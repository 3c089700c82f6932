"""Offline keyframe-index generation by replaying the online selection
heuristic (counterpart of dvmvs_tpu/apps/simulate_keyframe_buffer.py;
reference: dvmvs/simulate_keyframe_buffer.py:7-115). Host code: it reads
poses and file names only and takes no device.

Index files are the contract between online and offline evaluation
(``apps/run_testing.py``, ``apps/run_tsdf.py``): one line per predicted
keyframe, ``ref.png meas1.png [meas2.png ...]``, with literal ``TRACKING
LOST`` lines where the buffer was cleared. File name:
``keyframe+<dataset>+<scene>+nmeas+<N>`` (or ``simple<skip>+...``).

Run: ``python -m dvmvs_tpu_torch.apps.simulate_keyframe_buffer --dataset
DIR --output DIR/../indices [--nmeas 1 2 3] [--simple-skip N]``.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence

import numpy as np

from dvmvs_tpu_torch.utils.keyframe_buffer import KeyframeBuffer, SimpleBuffer


def _scene(scene_folder: str):
    poses = np.fromfile(os.path.join(scene_folder, "poses.txt"), dtype=float,
                        sep="\n ").reshape(-1, 4, 4)
    images_dir = os.path.join(scene_folder, "images")
    return poses, sorted(f for f in os.listdir(images_dir) if f.endswith(".png"))


def _line(names: Sequence[str], i: int, frames) -> str:
    return " ".join([names[i]] + [names[meas_index] for _, _, meas_index in frames])


def simulate_keyframe_buffer_for_scene(
    scene_folder: str,
    n_measurement_frames: int,
    buffer_size: int = 30,
    keyframe_pose_distance: float = 0.1,
    optimal_t_measure: float = 0.15,
    optimal_R_measure: float = 0.0,
) -> List[str]:
    """The index lines of one scene under the online keyframe heuristic."""
    poses, names = _scene(scene_folder)
    buf = KeyframeBuffer(buffer_size=buffer_size, keyframe_pose_distance=keyframe_pose_distance,
                         optimal_t_score=optimal_t_measure, optimal_R_score=optimal_R_measure,
                         store_return_indices=True)
    lines = []
    for i in range(len(poses)):
        response = buf.try_new_keyframe(poses[i], None, index=i)
        if response == 3:
            lines.append("TRACKING LOST")
        elif response == 1:
            lines.append(_line(names, i, buf.get_best_measurement_frames(n_measurement_frames)))
    return lines


def simulate_simple_buffer_for_scene(scene_folder: str, n_skip: int,
                                     n_measurement_frames: int) -> List[str]:
    """The index lines of one scene with a keyframe every ``n_skip`` frames
    and the ``n_measurement_frames`` keyframes before it as measurements."""
    poses, names = _scene(scene_folder)
    buf = SimpleBuffer(n_measurement_frames, store_return_indices=True)
    lines = []
    i = 0
    while i < len(poses):
        response = buf.try_new_keyframe(poses[i], None, index=i)
        if response == 0:
            i += n_skip
        elif response == 2:
            lines.append("TRACKING LOST")
            i += 1
        elif response in (3, 4):
            i += 1
        else:
            lines.append(_line(names, i, buf.get_measurement_frames()))
            i += n_skip
    return lines


def simulate_dataset(dataset_path: str, output_folder: str, n_measurement_frames: int,
                     simple_skip: int = 0):
    """Write index files for every scene folder under ``dataset_path``."""
    os.makedirs(output_folder, exist_ok=True)
    dataset_name = os.path.basename(os.path.normpath(dataset_path))
    scenes = sorted(d for d in os.listdir(dataset_path)
                    if os.path.isdir(os.path.join(dataset_path, d)))
    for scene in scenes:
        folder = os.path.join(dataset_path, scene)
        if simple_skip > 0:
            lines = simulate_simple_buffer_for_scene(folder, simple_skip, n_measurement_frames)
            name = f"simple{simple_skip}+{dataset_name}+{scene}+nmeas+{n_measurement_frames}"
        else:
            lines = simulate_keyframe_buffer_for_scene(folder, n_measurement_frames)
            name = f"keyframe+{dataset_name}+{scene}+nmeas+{n_measurement_frames}"
        with open(os.path.join(output_folder, name), "w") as f:
            f.write("\n".join(lines) + "\n")
        print(f"wrote {name}: {len(lines)} lines")


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", required=True, help="folder of scene folders")
    ap.add_argument("--output", required=True)
    ap.add_argument("--nmeas", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--simple-skip", type=int, default=0)
    args = ap.parse_args(argv)
    for n in args.nmeas:
        simulate_dataset(args.dataset, args.output, n, args.simple_skip)


if __name__ == "__main__":
    main()
