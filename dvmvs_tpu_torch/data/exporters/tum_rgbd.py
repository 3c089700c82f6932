"""TUM RGB-D exporter (counterpart of dvmvs_tpu/data/exporters/tum_rgbd.py;
reference: dataset/tum-rgbd-export/tum-rgbd-export.py).

Nearest-timestamp matching of rgb/depth/groundtruth streams per depth frame;
quaternion poses -> 4x4 camera-to-world; depth scaled /5 into millimeters
(TUM stores 5000 units per meter); K = [525, 525, 320, 240]; 13 sequences.

Run: ``python -m dvmvs_tpu_torch.data.exporters.tum_rgbd --input ROOT
--output OUT [--sequences ...] [--workers 6]``.
"""

from __future__ import annotations

import argparse
import os
from functools import partial

import numpy as np
from scipy.spatial.transform import Rotation

from dvmvs_tpu_torch.data.exporters import PNG_LEVEL
from dvmvs_tpu_torch.data.io import read_image, write_png
from dvmvs_tpu_torch.data.scene_folders import spawn_pool

K_TUM = np.array([[525.0, 0.0, 320.0], [0.0, 525.0, 240.0], [0.0, 0.0, 1.0]])

SEQUENCES = [
    "rgbd_dataset_freiburg1_desk",
    "rgbd_dataset_freiburg1_plant",
    "rgbd_dataset_freiburg1_room",
    "rgbd_dataset_freiburg1_teddy",
    "rgbd_dataset_freiburg2_desk",
    "rgbd_dataset_freiburg2_dishes",
    "rgbd_dataset_freiburg2_large_no_loop",
    "rgbd_dataset_freiburg3_cabinet",
    "rgbd_dataset_freiburg3_long_office_household",
    "rgbd_dataset_freiburg3_nostructure_notexture_far",
    "rgbd_dataset_freiburg3_nostructure_texture_far",
    "rgbd_dataset_freiburg3_structure_notexture_far",
    "rgbd_dataset_freiburg3_structure_texture_far",
]


def export_sequence(sequence: str, input_root: str, output_root: str):
    in_dir = os.path.join(input_root, sequence)
    out_dir = os.path.join(output_root, sequence)
    os.makedirs(os.path.join(out_dir, "images"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)

    image_files = sorted(os.listdir(os.path.join(in_dir, "rgb")))
    image_ts = np.loadtxt(os.path.join(in_dir, "rgb.txt"), usecols=0)
    depth_files = sorted(os.listdir(os.path.join(in_dir, "depth")))
    depth_ts = np.loadtxt(os.path.join(in_dir, "depth.txt"), usecols=0)
    gt = np.loadtxt(os.path.join(in_dir, "groundtruth.txt"))
    pose_ts, locations, quats = gt[:, 0], gt[:, 1:4], gt[:, 4:]

    poses = []
    for i, dfile in enumerate(depth_files):
        t = depth_ts[i]
        pi = int(np.argmin(np.abs(pose_ts - t)))
        ii = int(np.argmin(np.abs(image_ts - t)))
        pose = np.eye(4)
        pose[:3, :3] = Rotation.from_quat(quats[pi]).as_matrix()
        pose[:3, 3] = locations[pi]
        poses.append(pose.ravel())

        image = read_image(os.path.join(in_dir, "rgb", image_files[ii]))
        depth = (read_image(os.path.join(in_dir, "depth", dfile)).astype(float) / 5
                 ).astype(np.uint16)
        name = str(i).zfill(6) + ".png"
        write_png(os.path.join(out_dir, "images", name), image, PNG_LEVEL)
        write_png(os.path.join(out_dir, "depth", name), depth, PNG_LEVEL)

    np.savetxt(os.path.join(out_dir, "poses.txt"), np.array(poses))
    np.savetxt(os.path.join(out_dir, "K.txt"), K_TUM)
    return sequence


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--sequences", nargs="*", default=SEQUENCES)
    ap.add_argument("--workers", type=int, default=6)
    args = ap.parse_args(argv)
    with spawn_pool(args.workers) as workers:
        for name in workers.imap_unordered(
                partial(export_sequence, input_root=args.input,
                        output_root=args.output), args.sequences):
            print("finished", name)


if __name__ == "__main__":
    main()
