"""ScanNet .sens exporter (counterpart of dvmvs_tpu/data/exporters/scannet.py;
reference: dataset/scannet-export/scannet-export.py, Python 2).

.sens binary layout (version 4): header (sensor name, 4x4 color/depth
intrinsics+extrinsics, compression types, sizes, depth shift, frame count)
followed by per-frame records (4x4 camera-to-world pose f32, two uint64
timestamps, two uint64 payload sizes, JPEG color bytes, zlib'd uint16 depth).

Color is decoded by the port's JPEG decoder (``data/jpeg.py``, equal to
``cv2.imdecode``) and registered onto the depth intrinsics by a homography
warp with nearest sampling (reference: scannet-export.py:19-53).
Train export: per-frame .npz {image, depth} + poses.txt + K.txt, skipping
invalid poses. Test export: images/ + depth/ PNG folders, all poses kept.

Run: ``python -m dvmvs_tpu_torch.data.exporters.scannet --input SCANS
--output OUT [--train] [--frame-skip N] [--workers 8]``.
"""

from __future__ import annotations

import argparse
import os
import struct
import zlib
from functools import partial
from typing import List

import numpy as np

from dvmvs_tpu_torch.data.exporters import PNG_LEVEL
from dvmvs_tpu_torch.data.io import write_png
from dvmvs_tpu_torch.data.jpeg import decode_jpeg
from dvmvs_tpu_torch.data.scene_folders import spawn_pool

COMPRESSION_TYPE_COLOR = {-1: "unknown", 0: "raw", 1: "png", 2: "jpeg"}
COMPRESSION_TYPE_DEPTH = {-1: "unknown", 0: "raw_ushort", 1: "zlib_ushort", 2: "occi_ushort"}


def register_color_to_depth(color: np.ndarray, depth_hw, K_color: np.ndarray,
                            K_depth: np.ndarray) -> np.ndarray:
    """Warp the color image onto the depth camera's pixel grid.

    Nearest sampling with torch grid_sample align_corners=True semantics
    (coordinates scaled by (size-1)/size from the W/2-normalizer fold)."""
    new_h, new_w = depth_hw
    old_h, old_w = color.shape[:2]
    H = (K_color @ np.linalg.inv(K_depth)).astype(np.float32)

    xs, ys = np.meshgrid(np.arange(new_w), np.arange(new_h))
    coords = H @ np.stack([xs.ravel(), ys.ravel(), np.ones(xs.size)]).astype(np.float32)
    # f32 normalize (W/2) then unnormalize ((g+1)/2*(W-1)) exactly like the
    # reference's torch pipeline, so half-integer boundaries round identically
    gx = (coords[0] / (coords[2] + np.float32(1e-8))) / np.float32(old_w / 2.0) - 1
    gy = (coords[1] / (coords[2] + np.float32(1e-8))) / np.float32(old_h / 2.0) - 1
    u = (gx + 1) * np.float32(0.5) * (old_w - 1)
    v = (gy + 1) * np.float32(0.5) * (old_h - 1)
    ui = np.round(u).astype(int)
    vi = np.round(v).astype(int)
    valid = (ui >= 0) & (ui < old_w) & (vi >= 0) & (vi < old_h)
    out = np.zeros((new_h * new_w, color.shape[2]), dtype=color.dtype)
    out[valid] = color[vi[valid], ui[valid]]
    return out.reshape(new_h, new_w, color.shape[2])


class SensFrame:
    __slots__ = ("camera_to_world", "color_data", "depth_data")

    def load(self, f):
        self.camera_to_world = np.frombuffer(f.read(16 * 4), np.float32).reshape(4, 4)
        f.read(16)  # color + depth timestamps
        color_bytes = struct.unpack("Q", f.read(8))[0]
        depth_bytes = struct.unpack("Q", f.read(8))[0]
        self.color_data = f.read(color_bytes)
        self.depth_data = f.read(depth_bytes)


class SensorData:
    def __init__(self, filename: str):
        self.filename = filename
        with open(filename, "rb") as f:
            version = struct.unpack("I", f.read(4))[0]
            if version != 4:
                raise ValueError(f"{filename}: unsupported .sens version {version}")
            strlen = struct.unpack("Q", f.read(8))[0]
            self.sensor_name = f.read(strlen).decode("ascii", errors="replace")
            self.intrinsic_color = np.frombuffer(f.read(64), np.float32).reshape(4, 4)
            self.extrinsic_color = np.frombuffer(f.read(64), np.float32).reshape(4, 4)
            self.intrinsic_depth = np.frombuffer(f.read(64), np.float32).reshape(4, 4)
            self.extrinsic_depth = np.frombuffer(f.read(64), np.float32).reshape(4, 4)
            self.color_compression = COMPRESSION_TYPE_COLOR[struct.unpack("i", f.read(4))[0]]
            self.depth_compression = COMPRESSION_TYPE_DEPTH[struct.unpack("i", f.read(4))[0]]
            self.color_width = struct.unpack("I", f.read(4))[0]
            self.color_height = struct.unpack("I", f.read(4))[0]
            self.depth_width = struct.unpack("I", f.read(4))[0]
            self.depth_height = struct.unpack("I", f.read(4))[0]
            self.depth_shift = struct.unpack("f", f.read(4))[0]
            self.num_frames = struct.unpack("Q", f.read(8))[0]
            self.frames: List[SensFrame] = []
            for _ in range(self.num_frames):
                frame = SensFrame()
                frame.load(f)
                self.frames.append(frame)

    def decode_frame(self, frame: SensFrame):
        """(color (depth H, depth W, 3) uint8 RGB registered to the depth
        camera, depth (H, W) uint16 as stored). Only zlib_ushort depth and
        jpeg colour are read, as in the JAX exporter."""
        if self.depth_compression != "zlib_ushort":
            raise ValueError(f"{self.filename}: depth compression {self.depth_compression}")
        depth = np.frombuffer(
            zlib.decompress(frame.depth_data), np.uint16
        ).reshape(self.depth_height, self.depth_width)
        if self.color_compression != "jpeg":
            raise ValueError(f"{self.filename}: color compression {self.color_compression}")
        color = decode_jpeg(frame.color_data, self.filename)
        if color.ndim == 2:  # cv2.IMREAD_COLOR repeats a gray image
            color = np.repeat(color[:, :, None], 3, axis=2)
        color = register_color_to_depth(
            color, depth.shape, self.intrinsic_color[:3, :3], self.intrinsic_depth[:3, :3])
        return color, depth

    def export_train(self, output_path: str, frame_skip: int):
        os.makedirs(output_path, exist_ok=True)
        poses = []
        counter = 0
        for index in range(0, len(self.frames), frame_skip):
            pose = self.frames[index].camera_to_world
            if not np.isfinite(pose).all():
                continue
            poses.append(pose.ravel())
            color, depth = self.decode_frame(self.frames[index])
            np.savez_compressed(
                os.path.join(output_path, str(counter).zfill(6)),
                image=color, depth=depth)
            counter += 1
        np.savetxt(os.path.join(output_path, "poses.txt"), np.array(poses), fmt="%.8e")
        np.savetxt(os.path.join(output_path, "K.txt"), self.intrinsic_depth[:3, :3])

    def export_test(self, output_path: str, frame_skip: int):
        os.makedirs(os.path.join(output_path, "images"), exist_ok=True)
        os.makedirs(os.path.join(output_path, "depth"), exist_ok=True)
        poses = np.array([f.camera_to_world.ravel() for f in self.frames])
        np.savetxt(os.path.join(output_path, "poses.txt"), poses, fmt="%.8e")
        np.savetxt(os.path.join(output_path, "K.txt"), self.intrinsic_depth[:3, :3])
        for index in range(0, len(self.frames), frame_skip):
            color, depth = self.decode_frame(self.frames[index])
            name = str(index).zfill(6) + ".png"
            write_png(os.path.join(output_path, "images", name), color, PNG_LEVEL)
            write_png(os.path.join(output_path, "depth", name), depth, PNG_LEVEL)


def export_scene(scene_path: str, output_root: str, train: bool, frame_skip: int):
    scene_name = os.path.basename(os.path.normpath(scene_path))
    out = os.path.join(output_root, scene_name)
    if os.path.exists(out):
        print(f"existing scene {scene_name}, skipping")
        return scene_name
    sd = SensorData(os.path.join(scene_path, scene_name + ".sens"))
    if train:
        sd.export_train(out, frame_skip)
    else:
        sd.export_test(out, frame_skip)
    return scene_name


def sanity_check(output_root: str, train: bool):
    """Counts of images/depths/poses must agree per scene
    (reference: scannet-export.py:200-223)."""
    problems = []
    for scene in sorted(os.listdir(output_root)):
        path = os.path.join(output_root, scene)
        if not os.path.isdir(path):
            continue
        n_poses = len(np.loadtxt(os.path.join(path, "poses.txt")))
        if train:
            n_files = len([f for f in os.listdir(path) if f.endswith(".npz")])
            ok = n_files == n_poses
        else:
            n_images = len(os.listdir(os.path.join(path, "images")))
            n_depths = len(os.listdir(os.path.join(path, "depth")))
            ok = n_images == n_depths
        if not ok:
            problems.append(scene)
            print(scene, "is problematic")
    return problems


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--input", required=True, help="folder of ScanNet scan folders")
    ap.add_argument("--output", required=True)
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--frame-skip", type=int, default=None,
                    help="default: 4 for train (reference README.md:104), 1 for test")
    ap.add_argument("--workers", type=int, default=8)
    args = ap.parse_args(argv)

    frame_skip = args.frame_skip or (4 if args.train else 1)
    scenes = sorted(
        os.path.join(args.input, d) for d in os.listdir(args.input)
        if os.path.isdir(os.path.join(args.input, d)))
    os.makedirs(args.output, exist_ok=True)
    with spawn_pool(args.workers) as workers:
        for name in workers.imap_unordered(
                partial(export_scene, output_root=args.output,
                        train=args.train, frame_skip=frame_skip), scenes):
            print("finished", name)
    return sanity_check(args.output, args.train)


if __name__ == "__main__":
    main()
