"""7-Scenes exporter (counterpart of dvmvs_tpu/data/exporters/sevenscenes.py;
reference: dataset/7scenes-export/7scenes-export-{color,depth}.py).

Color/poses come from the official 7-Scenes release (per-seq *.color.png +
*.pose.txt, fixed K = [525, 525, 320, 240]); depth from the rendered-depth
source tree (exported separately). 13 test sequences.

Run: ``python -m dvmvs_tpu_torch.data.exporters.sevenscenes --input ROOT
[--depth-input RENDERED] --output OUT [--workers 6]``.
"""

from __future__ import annotations

import argparse
import os
from functools import partial

import numpy as np

from dvmvs_tpu_torch.data.exporters import PNG_LEVEL
from dvmvs_tpu_torch.data.io import read_image, read_rgb, write_png
from dvmvs_tpu_torch.data.scene_folders import spawn_pool

K_7SCENES = np.array([[525.0, 0.0, 320.0], [0.0, 525.0, 240.0], [0.0, 0.0, 1.0]])

# (scene, sequences) used for evaluation (reference: 7scenes-export-color.py:54-67)
TEST_SEQUENCES = [
    ("redkitchen", ["01", "07"]),
    ("chess", ["01", "02"]),
    ("heads", ["02"]),
    ("fire", ["01", "02"]),
    ("office", ["01", "03"]),
    ("pumpkin", ["03", "06"]),
    ("stairs", ["02", "06"]),
]


def export_color_scene(scene_seq, input_root: str, output_root: str):
    scene, seq = scene_seq
    in_dir = os.path.join(input_root, scene, f"seq-{seq}")
    out_dir = os.path.join(output_root, f"{scene}-seq-{seq}")
    images_dir = os.path.join(out_dir, "images")
    os.makedirs(images_dir, exist_ok=True)

    image_files = sorted(f for f in os.listdir(in_dir) if f.endswith("color.png"))
    pose_files = sorted(f for f in os.listdir(in_dir) if f.endswith("pose.txt"))
    poses = []
    for i, (img_f, pose_f) in enumerate(zip(image_files, pose_files)):
        poses.append(np.loadtxt(os.path.join(in_dir, pose_f)).ravel())
        write_png(os.path.join(images_dir, str(i).zfill(6) + ".png"),
                  read_rgb(os.path.join(in_dir, img_f)), PNG_LEVEL)
    np.savetxt(os.path.join(out_dir, "poses.txt"), np.array(poses))
    np.savetxt(os.path.join(out_dir, "K.txt"), K_7SCENES)
    return f"{scene}-seq-{seq}"


def export_depth_scene(scene_seq, depth_root: str, output_root: str):
    """Depth from the rendered-depth tree: 7scenes_<scene>/train/depth/seq<NN>*."""
    scene, seq = scene_seq
    in_dir = os.path.join(depth_root, f"7scenes_{scene}", "train", "depth")
    out_dir = os.path.join(output_root, f"{scene}-seq-{seq}", "depth")
    os.makedirs(out_dir, exist_ok=True)
    files = sorted(f for f in os.listdir(in_dir) if f.startswith(f"seq{seq}"))
    for i, f in enumerate(files):
        depth = np.round(read_image(os.path.join(in_dir, f))).astype(np.uint16)
        write_png(os.path.join(out_dir, str(i).zfill(6) + ".png"), depth, PNG_LEVEL)
    return f"{scene}-seq-{seq}"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--input", required=True, help="official 7scenes root")
    ap.add_argument("--depth-input", default=None, help="rendered-depth root")
    ap.add_argument("--output", required=True)
    ap.add_argument("--workers", type=int, default=6)
    args = ap.parse_args(argv)

    pairs = [(s, q) for s, seqs in TEST_SEQUENCES for q in seqs]
    with spawn_pool(args.workers) as workers:
        for name in workers.imap_unordered(
                partial(export_color_scene, input_root=args.input,
                        output_root=args.output), pairs):
            print("finished color", name)
        if args.depth_input:
            for name in workers.imap_unordered(
                    partial(export_depth_scene, depth_root=args.depth_input,
                            output_root=args.output), pairs):
                print("finished depth", name)


if __name__ == "__main__":
    main()
