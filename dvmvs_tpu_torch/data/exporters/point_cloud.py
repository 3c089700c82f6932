"""Debug point-cloud builder: backproject GT depth to colored PLY chunks
(counterpart of dvmvs_tpu/data/exporters/point_cloud.py; reference:
dataset/build_point_cloud.py, dataset/utils.py:6-59), written by the port's
native PLY writer (``utils/native.py``).

Run: ``python -m dvmvs_tpu_torch.data.exporters.point_cloud --dataset DIR
--scene NAME [--output point_clouds] [--stride 10]``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from dvmvs_tpu_torch.data.io import load_depth_png, read_rgb
from dvmvs_tpu_torch.utils.native import write_points_ply


def depth_image_to_point_cloud(rgb: np.ndarray, depth: np.ndarray, K: np.ndarray,
                               pose: np.ndarray, scale: float = 1.0):
    """Backproject a depth map to world-frame colored points (N, 6)."""
    h, w = depth.shape
    u, v = np.meshgrid(np.arange(w, dtype=float), np.arange(h, dtype=float))
    Z = depth.astype(float) / scale
    X = (u - K[0, 2]) * Z / K[0, 0]
    Y = (v - K[1, 2]) * Z / K[1, 1]
    valid = Z.ravel() > 0
    pts = np.stack([X.ravel()[valid], Y.ravel()[valid], Z.ravel()[valid],
                    np.ones(valid.sum())])
    world = (pose @ pts)[:3].T
    colors = rgb.reshape(-1, 3)[valid]
    return np.hstack([world, colors]).astype(np.float32)


def build_point_cloud(dataset_folder: str, scene_name: str, output_folder: str = ".",
                      frame_stride: int = 10, frames_per_chunk: int = 30):
    """Write ``<scene>_point_cloud_part<k>.ply`` for every ``frames_per_chunk``
    frames taken ``frame_stride`` apart, and ``..._part_last.ply`` for the
    rest; returns the paths written."""
    scene = os.path.join(dataset_folder, scene_name)
    poses = np.fromfile(os.path.join(scene, "poses.txt"), dtype=float, sep="\n ").reshape(-1, 4, 4)
    K = np.loadtxt(os.path.join(scene, "K.txt"))
    images = sorted(os.listdir(os.path.join(scene, "images")))
    depths = sorted(os.listdir(os.path.join(scene, "depth")))

    os.makedirs(output_folder, exist_ok=True)
    chunk, part, written = [], 1, []

    def write(suffix):
        pts = np.vstack(chunk)
        path = os.path.join(output_folder, f"{scene_name}_point_cloud_part{suffix}.ply")
        write_points_ply(path, pts[:, :3], pts[:, 3:].astype(np.uint8))
        written.append(path)

    for n, i in enumerate(range(0, len(images), frame_stride)):
        rgb = read_rgb(os.path.join(scene, "images", images[i]))
        depth = load_depth_png(os.path.join(scene, "depth", depths[i]))
        chunk.append(depth_image_to_point_cloud(rgb, depth, K, poses[i]))
        if (n + 1) % frames_per_chunk == 0:
            write(part)
            chunk, part = [], part + 1
    if chunk:
        write("_last")
    return written


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--scene", required=True)
    ap.add_argument("--output", default="point_clouds")
    ap.add_argument("--stride", type=int, default=10)
    args = ap.parse_args(argv)
    return build_point_cloud(args.dataset, args.scene, args.output, args.stride)


if __name__ == "__main__":
    main()
