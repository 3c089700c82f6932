"""A synthetic ScanNet scan: a ``SynthScene`` walk stored as a version-4
``.sens`` file (JPEG colour, zlib'd uint16 depth), the input of the ScanNet
exporter (``data/exporters/scannet.py``).

Colour is 1296x968 and depth 640x480 with the intrinsics of a ScanNet scan
(scene0000_00's ``_info.txt``), both rendered from the same poses; one frame
gets a NaN pose, as real scans have. The colour frames are committed JPEGs
(``fixtures/synth_scannet/frame_*.jpg``, encoded by OpenCV at quality 95 with
4:2:0 sampling from the renders, made by ``tests/make_synth_scannet.py``)
beside the SHA-256 of the RGB pixels ``cv2.imdecode`` gives for each
(``digests.json``), so a machine without an encoder can build the scan and
check its own decoder. Depth is rendered where the scan is built.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import zlib
from pathlib import Path
from typing import Sequence

import numpy as np

from dvmvs_tpu_torch.data.synthetic import SynthScene

FIXTURES = Path(__file__).with_name("fixtures") / "synth_scannet"
SEED, N_FRAMES, STEP, NAN_FRAME = 23, 8, 0.3, 5
COLOR_SIZE, DEPTH_SIZE = (1296, 968), (640, 480)  # (width, height)
K_COLOR = np.array([[1170.187988, 0.0, 647.75], [0.0, 1170.187988, 483.75], [0.0, 0.0, 1.0]])
K_DEPTH = np.array([[571.623718, 0.0, 319.5], [0.0, 571.623718, 239.5], [0.0, 0.0, 1.0]])


def poses() -> np.ndarray:
    """(N_FRAMES, 4, 4) camera-to-world poses of the walk (all finite)."""
    return SynthScene(SEED).trajectory(N_FRAMES, step=STEP)


def render(i: int, K: np.ndarray, size) -> tuple:
    """Frame i's (rgb uint8, depth float32 m) at ``size`` with ``K``."""
    return SynthScene(SEED).render(poses()[i], K, *size)


def render_depth_mm(i: int) -> np.ndarray:
    """Frame i's depth at DEPTH_SIZE in uint16 millimetres."""
    depth = render(i, K_DEPTH, DEPTH_SIZE)[1]
    return np.clip(np.round(depth * 1000.0), 0, 65535).astype(np.uint16)


def jpeg_paths() -> list:
    return [FIXTURES / f"frame_{i:02d}.jpg" for i in range(N_FRAMES)]


def pixel_digest(rgb: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(rgb, np.uint8).tobytes()).hexdigest()


def digests() -> list:
    """cv2's decoded-pixel SHA-256 of each committed JPEG."""
    with open(FIXTURES / "digests.json") as f:
        return json.load(f)["rgb_sha256"]


def _matrix4(K: np.ndarray) -> np.ndarray:
    M = np.eye(4, dtype=np.float32)
    M[:3, :3] = K
    return M


def write_sens(path: str, K_color: np.ndarray, K_depth: np.ndarray, color_size, depth_size,
               poses_c2w: Sequence[np.ndarray], jpegs: Sequence[bytes],
               depths_mm: Sequence[np.ndarray], depth_shift: float = 1000.0):
    """A version-4 .sens file (the layout ``SensorData`` reads): jpeg colour,
    zlib_ushort depth, identity extrinsics, zero timestamps."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        name = b"synthetic"
        f.write(struct.pack("I", 4) + struct.pack("Q", len(name)) + name)
        for M in (_matrix4(K_color), np.eye(4), _matrix4(K_depth), np.eye(4)):
            f.write(np.asarray(M, np.float32).tobytes())
        f.write(struct.pack("ii", 2, 1))  # jpeg colour, zlib_ushort depth
        f.write(struct.pack("IIII", *color_size, *depth_size))
        f.write(struct.pack("f", depth_shift) + struct.pack("Q", len(jpegs)))
        for pose, jpeg, depth in zip(poses_c2w, jpegs, depths_mm):
            packed = zlib.compress(np.ascontiguousarray(depth, np.uint16).tobytes())
            f.write(np.asarray(pose, np.float32).tobytes() + struct.pack("QQ", 0, 0))
            f.write(struct.pack("QQ", len(jpeg), len(packed)) + jpeg + packed)


def write_scan(scan_dir: str, depths_mm: Sequence[np.ndarray]) -> str:
    """``scan_dir/<name>.sens`` of the committed JPEGs and ``depths_mm``
    (``render_depth_mm`` of each frame), frame NAN_FRAME's pose set to NaN;
    returns its path."""
    walk = poses().astype(np.float32)
    walk[NAN_FRAME] = np.nan
    path = os.path.join(scan_dir, os.path.basename(os.path.normpath(scan_dir)) + ".sens")
    write_sens(path, K_COLOR, K_DEPTH, COLOR_SIZE, DEPTH_SIZE, walk,
               [p.read_bytes() for p in jpeg_paths()], depths_mm)
    return path
