"""Write the JPEG fixtures of dvmvs_tpu_torch/data/synth_scannet.py:
SynthScene renders at 1296x968 encoded by OpenCV (quality 95, 4:2:0), and
the SHA-256 of the RGB pixels cv2.imdecode gives for each.

Run from the root of the repo: ``python tests/make_synth_scannet.py``.
tests/test_torch_jpeg.py holds the committed files to what this writes.
"""

import json
import os
import sys

import cv2
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dvmvs_tpu_torch.data import synth_scannet as ss  # noqa: E402

QUALITY = [cv2.IMWRITE_JPEG_QUALITY, 95,
           cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420]


def encode(i: int) -> bytes:
    rgb = ss.render(i, ss.K_COLOR, ss.COLOR_SIZE)[0]
    ok, data = cv2.imencode(".jpg", cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR), QUALITY)
    assert ok
    return data.tobytes()


def cv2_rgb(data: bytes) -> np.ndarray:
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def main():
    os.makedirs(ss.FIXTURES, exist_ok=True)
    sums = []
    for i, path in enumerate(ss.jpeg_paths()):
        data = encode(i)
        path.write_bytes(data)
        sums.append(ss.pixel_digest(cv2_rgb(data)))
        print(path, len(data), "bytes")
    with open(ss.FIXTURES / "digests.json", "w") as f:
        json.dump({"opencv": cv2.__version__, "rgb_sha256": sums}, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
