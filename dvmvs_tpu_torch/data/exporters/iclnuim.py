"""Augmented ICL-NUIM exporter (counterpart of
dvmvs_tpu/data/exporters/iclnuim.py; reference:
dataset/augmented-iclnuim-export/iclnuim-export.py).

Per-scene <name>-traj.txt 4x4 poses, <name>-color JPEGs (decoded by
``data/jpeg.py``), <name>-depth-clean PNGs; K = [525, 525, 320, 240];
4 scenes.

Run: ``python -m dvmvs_tpu_torch.data.exporters.iclnuim --input ROOT
--output OUT [--scenes ...] [--workers 4]``.
"""

from __future__ import annotations

import argparse
import os
from functools import partial

import numpy as np

from dvmvs_tpu_torch.data.exporters import PNG_LEVEL
from dvmvs_tpu_torch.data.io import read_image, write_png
from dvmvs_tpu_torch.data.scene_folders import spawn_pool

K_ICLNUIM = np.array([[525.0, 0.0, 320.0], [0.0, 525.0, 240.0], [0.0, 0.0, 1.0]])
SCENES = ["livingroom1", "livingroom2", "office1", "office2"]


def export_scene(scene: str, input_root: str, output_root: str):
    color_dir = os.path.join(input_root, scene + "-color")
    depth_dir = os.path.join(input_root, scene + "-depth-clean")
    image_files = sorted(f for f in os.listdir(color_dir) if f.endswith(".jpg"))
    depth_files = sorted(f for f in os.listdir(depth_dir) if f.endswith(".png"))

    rows = []
    with open(os.path.join(input_root, scene + "-traj.txt")) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 4:
                rows.append([float(p) for p in parts])
    poses = np.array(rows).reshape(-1, 4, 4)

    out_dir = os.path.join(output_root, scene)
    os.makedirs(os.path.join(out_dir, "images"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)

    out_poses = []
    for i in range(len(poses)):
        image = read_image(os.path.join(color_dir, image_files[i]))
        depth = read_image(os.path.join(depth_dir, depth_files[i]))
        out_poses.append(poses[i].ravel())
        name = str(i).zfill(6) + ".png"
        write_png(os.path.join(out_dir, "images", name), image, PNG_LEVEL)
        write_png(os.path.join(out_dir, "depth", name), depth, PNG_LEVEL)

    np.savetxt(os.path.join(out_dir, "poses.txt"), np.array(out_poses))
    np.savetxt(os.path.join(out_dir, "K.txt"), K_ICLNUIM)
    return scene


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--scenes", nargs="*", default=SCENES)
    ap.add_argument("--workers", type=int, default=4)
    args = ap.parse_args(argv)
    with spawn_pool(args.workers) as workers:
        for name in workers.imap_unordered(
                partial(export_scene, input_root=args.input,
                        output_root=args.output), args.scenes):
            print("finished", name)


if __name__ == "__main__":
    main()
