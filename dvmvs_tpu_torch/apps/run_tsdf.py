"""TSDF reconstruction from saved depth predictions (counterpart of
dvmvs_tpu/apps/run_tsdf.py; reference:
sample-data/run-tsdf-reconstruction.py:477-662).

Reads the npz predictions that ``apps/run_testing.py`` writes and the
matching keyframe index file, fuses them into a TSDF volume on the device
(``ops/tsdf.py``) and writes a coloured mesh with the native marching cubes
(``utils/native.py``). Frames are resized to the predictions' size with the
port's nearest resize (no OpenCV).

Run on the card (the default; ``--device cpu`` asks for the CPU):
``python -m dvmvs_tpu_torch.apps.run_tsdf --predictions X_predictions_S.npz
--data DIR --dataset-name D --scene S``.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from dvmvs_tpu_torch.data.io import load_depth_png, load_image
from dvmvs_tpu_torch.data.preprocess import PreprocessImage, resize
from dvmvs_tpu_torch.ops.tsdf import TSDFVolume, calculate_volume_bounds
from dvmvs_tpu_torch.utils.native import write_mesh_ply

EDGE_PIXEL_AMOUNT = 10


def load_keyframe_data(scene_folder: str, index_file: str, predictions: np.ndarray,
                       max_depth: float, dataset_name: str):
    """(poses, uint8 frames at the predictions' size, depths with far and
    ScanNet black-border pixels zeroed, scaled K, original K, all poses) of
    the index file's keyframes, in order."""
    original_K = np.loadtxt(os.path.join(scene_folder, "K.txt")).astype(np.float32)
    all_poses = np.fromfile(os.path.join(scene_folder, "poses.txt"), dtype=float,
                            sep="\n ").reshape(-1, 4, 4)
    images_dir = os.path.join(scene_folder, "images")
    image_names = sorted(f for f in os.listdir(images_dir) if f.endswith(".png"))
    name_to_index = {f: i for i, f in enumerate(image_names)}
    with open(index_file) as f:
        lines = [line for line in f.read().splitlines() if line]

    ph, pw = predictions[0].shape
    first = load_image(os.path.join(images_dir, image_names[0]))
    pre = PreprocessImage(K=original_K, old_width=first.shape[1], old_height=first.shape[0],
                          new_width=pw, new_height=ph, distortion_crop=0, perform_crop=False)
    scaled_K = pre.get_updated_intrinsics().astype(np.float32)

    edge_mask = np.zeros((ph, pw), dtype=bool)
    edge_mask[:EDGE_PIXEL_AMOUNT, :] = True
    edge_mask[ph - EDGE_PIXEL_AMOUNT:, :] = True
    edge_mask[:, :EDGE_PIXEL_AMOUNT] = True
    edge_mask[:, pw - EDGE_PIXEL_AMOUNT:] = True

    poses, images, depths = [], [], []
    pred_i = 0
    for line in lines:
        if line == "TRACKING LOST":
            continue
        if pred_i >= len(predictions):
            break
        ref_name = line.split(" ")[0]
        image = resize(load_image(os.path.join(images_dir, ref_name)), pw, ph, nearest=True)
        pred = predictions[pred_i].copy()
        pred_i += 1
        if "scannet" in dataset_name:
            black = np.mean(image.astype(float), axis=-1) < 10.0
            pred[np.logical_and(black, edge_mask)] = 0.0
        pred[pred > max_depth] = 0.0
        poses.append(all_poses[name_to_index[ref_name]])
        images.append(image.astype(np.uint8))
        depths.append(pred)
    return poses, images, depths, scaled_K, original_K, all_poses


def reconstruct(poses, images, depths, K, voxel_size: float, mesh_path: str, bounds=None,
                save_progressive: bool = False, device="cuda") -> TSDFVolume:
    """Fuse the frames into a volume (bounds from the depth frusta unless
    given) and write its mesh to ``mesh_path``; with ``save_progressive`` a
    mesh after every frame too. Returns the volume."""
    if bounds is None:
        bounds = calculate_volume_bounds(depths, poses, K) * 1.05
    volume = TSDFVolume(bounds, voxel_size=voxel_size, device=device)
    print(f"Voxel volume size: {volume.vol_dim[0]} x {volume.vol_dim[1]} x "
          f"{volume.vol_dim[2]} - # points: {int(np.prod(volume.vol_dim)):,}")
    t0 = time.time()
    if save_progressive:
        base = mesh_path[:-len("_complete.ply")]
        for i in range(len(images)):
            volume.integrate(images[i], depths[i], K, poses[i], obs_weight=1.0)
            verts, faces, norms, colors = volume.get_mesh()
            write_mesh_ply(f"{base}_frame_{i:05d}.ply", verts, faces, norms, colors)
    else:
        volume.integrate_frames(images, depths, K, poses, obs_weight=1.0)
    if volume.device.type == "cuda":
        torch.cuda.synchronize(volume.device)  # the frames are fused before the clock stops
    print(f"Average FPS: {len(images) / (time.time() - t0):.2f}")

    verts, faces, norms, colors = volume.get_mesh()
    write_mesh_ply(mesh_path, verts, faces, norms, colors)
    print(f"Saved mesh with {len(verts)} vertices / {len(faces)} faces to {mesh_path}")
    return volume


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--predictions", required=True, help="npz from run_testing")
    ap.add_argument("--data", required=True, help="folder with indices/ and <dataset>/<scene>/")
    ap.add_argument("--dataset-name", required=True)
    ap.add_argument("--scene", required=True)
    ap.add_argument("--nmeas", type=int, default=2)
    ap.add_argument("--output", default="reconstructions")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--voxel-size", type=float, default=0.05)
    ap.add_argument("--max-depth", type=float, default=3.0)
    ap.add_argument("--groundtruth-anchor", action="store_true",
                    help="volume bounds from GT depth frusta")
    ap.add_argument("--save-groundtruth", action="store_true",
                    help="also reconstruct from GT depth maps")
    ap.add_argument("--save-progressive", action="store_true",
                    help="write a mesh after every integrated frame")
    args = ap.parse_args(argv)

    os.makedirs(args.output, exist_ok=True)
    predictions = np.load(args.predictions)["arr_0"]
    scene_folder = os.path.join(args.data, args.dataset_name, args.scene)
    index_file = os.path.join(args.data, "indices",
                              f"keyframe+{args.dataset_name}+{args.scene}+nmeas+{args.nmeas}")
    poses, images, depths, scaled_K, original_K, all_poses = load_keyframe_data(
        scene_folder, index_file, predictions, args.max_depth, args.dataset_name)
    print(f"{len(images)} keyframes for reconstruction")

    bounds = gts = None
    if args.groundtruth_anchor or args.save_groundtruth:
        depth_dir = os.path.join(scene_folder, "depth")
        gts = []
        for n in sorted(f for f in os.listdir(depth_dir) if f.endswith(".png")):
            g = load_depth_png(os.path.join(depth_dir, n))
            g[g > args.max_depth] = 0.0
            gts.append(g)
        if args.groundtruth_anchor:
            bounds = calculate_volume_bounds(gts, all_poses, original_K) * 1.05

    tag = (f"reconstruction_voxelsize-{args.voxel_size}_maxdepth-{args.max_depth}"
           f"_anchor-{args.groundtruth_anchor}")
    mesh_path = os.path.join(
        args.output, f"{tag}_PREDICTION_{args.dataset_name}_{args.scene}_complete.ply")
    reconstruct(poses, images, depths, scaled_K, args.voxel_size, mesh_path, bounds,
                save_progressive=args.save_progressive, device=args.device)

    if args.save_groundtruth:
        # every frame at its stored size
        images_dir = os.path.join(scene_folder, "images")
        gt_images = [load_image(os.path.join(images_dir, n)).astype(np.uint8)
                     for n in sorted(f for f in os.listdir(images_dir) if f.endswith(".png"))]
        gt_mesh_path = os.path.join(
            args.output, f"{tag}_GROUNDTRUTH_{args.dataset_name}_{args.scene}_complete.ply")
        gt_bounds = calculate_volume_bounds(gts, all_poses, original_K) * 1.05
        reconstruct(list(all_poses), gt_images, gts, original_K, args.voxel_size, gt_mesh_path,
                    gt_bounds, device=args.device)


if __name__ == "__main__":
    main()
