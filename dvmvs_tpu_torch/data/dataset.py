"""Training dataset + input pipeline (counterpart of
dvmvs_tpu/data/dataset.py; reference: dvmvs/dataset_loader.py:349-496).

Loads per-frame ``.npz`` archives ({image, depth}) + poses.txt + K.txt from
the canonical training layout, applies the reference's augmentations:
  - 50% random sequence reversal (train)
  - geometric scale: depth AND pose translation scaled by a random factor
    bounded so depths stay inside [min_depth, max_depth]
  - color: random brightness/contrast/gamma in random order, only when the
    mean RGB is in (55, 200)
  - ImageNet normalization

Output layout is the JAX package's: NHWC float32 batches
(images (B,S,H,W,3), depths (B,S,H,W), poses (B,S,4,4), K (B,3,3)), and the
same seeds give the same samples and batches through the same RNG calls.

The pipeline is a host-side thread feeding a double-buffered device
prefetcher (pinned host memory, non-blocking copies): decode/augment of batch
t+1 overlaps device compute of batch t.
"""

from __future__ import annotations

import os
import queue
import random
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from dvmvs_tpu_torch.config import MEAN_RGB, SCALE_RGB, STD_RGB, TrainConfig
from dvmvs_tpu_torch.data.crawler import crawl
from dvmvs_tpu_torch.data.preprocess import PreprocessImage

# host RAM for decoded, resized frames (the JAX package's default budget)
FRAME_CACHE_BYTES = 8 << 30


# ----------------------------------------------------------- color augmenters
def adjust_brightness(img: np.ndarray, value: float) -> np.ndarray:
    return np.clip(img + value, 0.0, 1.0)


def adjust_contrast(img: np.ndarray, value: float) -> np.ndarray:
    return np.clip(img * value, 0.0, 1.0)


def adjust_gamma(img: np.ndarray, value: float) -> np.ndarray:
    return np.clip(img ** value, 0.0, 1.0)


class MVSSequenceDataset:
    def __init__(
        self,
        root: str,
        split: str,
        subsequence_length: int,
        cfg: TrainConfig = TrainConfig(),
        geometric_scale_augmentation: bool = False,
        seed: int = 0,
        wire_compact: bool = False,
    ):
        self.root = root
        self.split = split
        self.cfg = cfg
        self.subsequence_length = subsequence_length
        self.geometric_scale_augmentation = geometric_scale_augmentation
        # compact wire format: emit uint8 images (post-augmentation, still
        # un-normalized) + float16 depths; the train/eval steps cast and
        # normalize ON DEVICE (parallel/train.py::decode_wire_batch),
        # shrinking host->device transfer ~3.6x. Quantization is lossless
        # when color augmentation doesn't fire (validation) and <=0.5/255
        # dither when it does.
        self.wire_compact = wire_compact
        self.rng = np.random.RandomState(seed)
        self.pyrng = random.Random(seed)

        split_file = os.path.join(root, "train.txt" if split == "TRAINING" else "validation.txt")
        with open(split_file) as f:
            scenes = [line.strip() for line in f if line.strip()]
        self.scenes = scenes
        self.samples = crawl(
            root, scenes, subsequence_length,
            min_pose_distance=cfg.minimum_pose_distance,
            max_pose_distance=cfg.maximum_pose_distance,
            crawl_step=cfg.crawl_step,
            num_workers=cfg.data_pipeline_workers,
            seed=seed,
        )

        # Host-side caches. Both hold only DETERMINISTIC per-frame work
        # (decode + resize + valid-range scan) so cached and uncached paths
        # are bit-identical and the augmentation RNG stream is untouched.
        self._frame_cache_budget = FRAME_CACHE_BYTES
        self._frame_cache_bytes = 0
        self._frame_cache: Dict[str, tuple] = {}
        self._scene_cache: Dict[str, tuple] = {}

    def __len__(self):
        return len(self.samples)

    def _scene_meta(self, scene: str):
        """(K, poses (N,4,4), sorted npz paths, PreprocessImage, new K) —
        parsed once per scene instead of once per sample."""
        meta = self._scene_cache.get(scene)
        if meta is not None:
            return meta
        scene_path = os.path.join(self.root, scene)
        K = np.loadtxt(os.path.join(scene_path, "K.txt"), dtype=np.float32)
        poses = np.reshape(
            np.loadtxt(os.path.join(scene_path, "poses.txt"), dtype=np.float32), (-1, 4, 4))
        npzs = sorted(
            os.path.join(scene_path, f) for f in os.listdir(scene_path) if f.endswith(".npz"))
        with np.load(npzs[0]) as first:
            old_h, old_w = first["depth"].shape[:2]
        pre = PreprocessImage(
            K=K,
            old_width=old_w,
            old_height=old_h,
            new_width=self.cfg.image_width,
            new_height=self.cfg.image_height,
            distortion_crop=0,
        )
        meta = (K, poses, npzs, pre, pre.get_updated_intrinsics().astype(np.float32))
        self._scene_cache[scene] = meta
        return meta

    def _load_frame(self, path: str, pre: PreprocessImage):
        """(image float32 0..255 resized, depth float32 m resized,
        valid-min, valid-max) with an in-RAM cache under a byte budget."""
        hit = self._frame_cache.get(path)
        if hit is not None:
            return hit
        with np.load(path) as r:
            img, dep = r["image"], r["depth"]
        d = dep.astype(np.float32) / 1000.0
        d[~np.isfinite(d)] = 0.0
        d = pre.apply_depth(d)
        valid = d[d > 0]
        vmin = float(valid.min()) if valid.size else np.inf
        vmax = float(valid.max()) if valid.size else -np.inf
        im = pre.apply_rgb(img, 1.0, [0.0] * 3, [1.0] * 3, normalize_colors=False)
        entry = (im, d, vmin, vmax)
        nbytes = im.nbytes + d.nbytes
        if self._frame_cache_bytes + nbytes <= self._frame_cache_budget:
            self._frame_cache[path] = entry
            self._frame_cache_bytes += nbytes
        return entry

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        sample = self.samples[index]
        indices = list(sample["indices"])
        _, scene_poses, npzs, pre, new_K = self._scene_meta(sample["scene"])

        if self.split == "TRAINING" and self.rng.random_sample() > 0.5:
            indices.reverse()

        raw_poses = [scene_poses[i] for i in indices]

        depth_cfg = self.cfg.depth
        min_d, max_d = depth_cfg.max_depth, depth_cfg.min_depth
        images, depths = [], []
        rgb_sum = 0.0
        for i in indices:
            im, d, vmin, vmax = self._load_frame(npzs[i], pre)
            depths.append(d)
            if np.isfinite(vmin):
                min_d = min(min_d, vmin)
                max_d = max(max_d, vmax)
            rgb_sum += im.sum()
            images.append(im)
        rgb_average = rgb_sum / (len(images) * self.cfg.image_height * self.cfg.image_width * 3)

        geometric_scale_factor = 1.0
        if self.geometric_scale_augmentation:
            lo_bound = depth_cfg.min_depth / min_d
            hi_bound = depth_cfg.max_depth / max_d
            if self.rng.random_sample() > 0.5:
                lo, hi = max(lo_bound, 0.666), min(hi_bound, 1.5)
            else:
                lo, hi = max(lo_bound, 0.8), min(hi_bound, 1.25)
            geometric_scale_factor = self.rng.uniform(low=lo, high=hi)

        color_transforms = [
            (adjust_gamma, self.pyrng.uniform(0.8, 1.2)),
            (adjust_contrast, self.pyrng.uniform(0.8, 1.2)),
            (adjust_brightness, self.pyrng.uniform(-0.03, 0.03)),
        ]
        self.pyrng.shuffle(color_transforms)

        out_images, out_depths, out_poses = [], [], []
        for im, d, pose in zip(images, depths, raw_poses):
            im = im.astype(np.float32) / 255.0
            if self.split == "TRAINING" and 55.0 < rgb_average < 200.0:
                for fn, v in color_transforms:
                    im = fn(im, v)
            if self.wire_compact:
                # un-normalized uint8 over the wire; the step divides by
                # scale_rgb and applies mean/std on device
                im = np.clip(np.round(im * 255.0), 0, 255).astype(np.uint8)
            else:
                im = (im * 255.0) / SCALE_RGB
                for c in range(3):
                    im[:, :, c] = (im[:, :, c] - MEAN_RGB[c]) / STD_RGB[c]
            pose = pose.astype(np.float32).copy()
            pose[0:3, 3] *= geometric_scale_factor
            out_images.append(im)
            out_depths.append(d * geometric_scale_factor)
            out_poses.append(pose)

        img_dtype = np.uint8 if self.wire_compact else np.float32
        dep_dtype = np.float16 if self.wire_compact else np.float32
        return {
            "images": np.stack(out_images).astype(img_dtype),
            "depths": np.stack(out_depths).astype(dep_dtype),
            "poses": np.stack(out_poses).astype(np.float32),
            "K": new_K.copy(),
        }


def batch_iterator(
    dataset: MVSSequenceDataset,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    drop_last: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    order = np.arange(len(dataset))
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    for start in range(0, len(order) - (batch_size - 1 if drop_last else 0), batch_size):
        idx = order[start : start + batch_size]
        if drop_last and len(idx) < batch_size:
            break
        items = [dataset[i] for i in idx]
        yield {k: np.stack([it[k] for it in items]) for k in items[0]}


def host_prefetch(iterator, buffer_size: int = 2):
    """Run the host-side batch assembly (decode + augment, pure numpy) in a
    background thread feeding a bounded queue. Large-array numpy releases
    the GIL, so this overlaps augmentation with the time the main thread
    spends waiting on the device. Closing the generator (or dropping it)
    stops the thread after the batch it is building."""
    q: queue.Queue = queue.Queue(maxsize=buffer_size)
    sentinel = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def work():
        try:
            for item in iterator:
                if not put(item):
                    return
            put(sentinel)
        except BaseException as e:  # propagate into the consumer
            put(e)

    threading.Thread(target=work, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def device_prefetch(iterator, device, buffer_size: int = 2):
    """Double-buffered host->device feed: the copy of batch t+1 is queued
    while batch t computes. On a GPU every array goes through a fresh pinned
    host buffer (so no buffer is overwritten while its copy is in flight) and
    a non-blocking copy; on the CPU it is wrapped as it is. The host-side
    assembly runs in a prefetch thread (host_prefetch)."""
    device = torch.device(device)

    def put(array):
        t = torch.from_numpy(np.ascontiguousarray(array))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    buf = []
    for batch in host_prefetch(iterator, buffer_size):
        buf.append({k: put(v) for k, v in batch.items()})
        if len(buf) == buffer_size:
            yield buf.pop(0)
    while buf:
        yield buf.pop(0)
