"""RGB-D Scenes V2 exporter (counterpart of
dvmvs_tpu/data/exporters/rgbd_scenes.py; reference:
dataset/rgbdscenes-export/rgbdscenes-export.py).

Quaternion .pose files (w x y z tx ty tz); depth /10000 -> meters -> clamp
50 m -> uint16 mm; K = [570.3, 570.3, 320, 240]; 8 scenes.

Run: ``python -m dvmvs_tpu_torch.data.exporters.rgbd_scenes --input ROOT
--output OUT [--scenes ...] [--workers 8]``.
"""

from __future__ import annotations

import argparse
import os
from functools import partial

import numpy as np
from scipy.spatial.transform import Rotation

from dvmvs_tpu_torch.data.exporters import PNG_LEVEL
from dvmvs_tpu_torch.data.io import read_image, read_rgb, write_png
from dvmvs_tpu_torch.data.scene_folders import spawn_pool

K_RGBD_SCENES = np.array([[570.3, 0.0, 320.0], [0.0, 570.3, 240.0], [0.0, 0.0, 1.0]])
SCENE_NUMBERS = ["01", "02", "05", "06", "09", "10", "13", "14"]


def export_scene(scene_no: str, input_root: str, output_root: str):
    img_dir = os.path.join(input_root, "imgs", f"scene_{scene_no}")
    image_files = sorted(f for f in os.listdir(img_dir) if "color" in f and f.endswith(".png"))
    depth_files = sorted(f for f in os.listdir(img_dir) if "depth" in f and f.endswith(".png"))
    extrinsics = np.loadtxt(os.path.join(input_root, "pc", f"{scene_no}.pose"))

    out_dir = os.path.join(output_root, f"scene_{scene_no}")
    os.makedirs(os.path.join(out_dir, "images"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)

    poses = []
    for row in extrinsics:
        w, xyz, t = row[0], row[1:4], row[4:7]
        pose = np.eye(4)
        pose[:3, :3] = Rotation.from_quat(np.hstack([xyz, w])).as_matrix()
        pose[:3, 3] = t
        poses.append(pose.ravel())

    out_poses = []
    for i, (img_f, dep_f) in enumerate(zip(image_files, depth_files)):
        image = read_rgb(os.path.join(img_dir, img_f))
        depth = read_image(os.path.join(img_dir, dep_f)).astype(np.float32)
        depth = depth / 10000.0
        depth[(depth > 50.0) | ~np.isfinite(depth)] = 0.0
        depth = (depth * 1000.0).astype(np.uint16)
        out_poses.append(poses[i])
        name = str(i).zfill(6) + ".png"
        write_png(os.path.join(out_dir, "images", name), image, PNG_LEVEL)
        write_png(os.path.join(out_dir, "depth", name), depth, PNG_LEVEL)

    np.savetxt(os.path.join(out_dir, "poses.txt"), np.array(out_poses))
    np.savetxt(os.path.join(out_dir, "K.txt"), K_RGBD_SCENES)
    return scene_no


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--scenes", nargs="*", default=SCENE_NUMBERS)
    ap.add_argument("--workers", type=int, default=8)
    args = ap.parse_args(argv)
    with spawn_pool(args.workers) as workers:
        for name in workers.imap_unordered(
                partial(export_scene, input_root=args.input,
                        output_root=args.output), args.scenes):
            print("finished", name)


if __name__ == "__main__":
    main()
