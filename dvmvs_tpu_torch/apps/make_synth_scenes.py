"""The procedural multi-scene corpus of the accuracy proxy (counterpart of
scripts/make_synth_scenes.py), written from ``data/synthetic.py`` without
OpenCV:

  <out>/train/scene_<seed>/{i:05d}.npz (image, depth in mm), poses.txt, K.txt
  <out>/train/{train,validation}.txt
  <out>/eval/synth-eval/<nnn>/{images,depth}/{i:05d}.png, poses.txt, K.txt

Training and validation scenes are stored exactly as the JAX script stores
them. Evaluation scenes are PNGs from ``data/io.py::write_png``: 8-bit RGB
and 16-bit gray depth in millimetres, the pixels cv2 writes (the bytes
differ: ``apps/corpus_fingerprint.py`` hashes their decoded pixels).
Evaluation scenes take the seeds after the training and validation ones,
so they are unseen. Frames are rendered by spawned worker processes.

Keyframe index files of the evaluation scenes come from
``apps/simulate_keyframe_buffer.py``. The defaults are the recorded proxy
corpus (``docs/corpus_fingerprint.json``): 8 train, 2 validation and 9
evaluation scenes of 120 frames, seed base 100, 320x256.

    python -m dvmvs_tpu_torch.apps.make_synth_scenes --output build/data_synth
"""

from __future__ import annotations

import argparse
import os
from typing import List, Sequence, Tuple

import numpy as np

from dvmvs_tpu_torch.data import synthetic as synth
from dvmvs_tpu_torch.data.io import write_png
from dvmvs_tpu_torch.data.scene_folders import render_walk, spawn_pool, walk_poses

STEP = 0.03  # SynthScene.trajectory's default, which the JAX script uses


def render_scenes(scenes: Sequence[Tuple[int, int]], width: int, height: int,
                  workers: int = 8) -> List[list]:
    """Every frame of each ``(seed, n_frames)`` walk, (rgb uint8, depth f32
    m) in order, rendered in chunks by ``workers`` spawned processes."""
    chunk = max(1, -(-sum(n for _, n in scenes) // (4 * workers)))
    jobs = [(seed, n, i, min(i + chunk, n), width, height, STEP)
            for seed, n in scenes for i in range(0, n, chunk)]
    with spawn_pool(workers) as pool:
        chunks = pool.starmap(render_walk, jobs)
    frames = {seed: [] for seed, _ in scenes}
    for job, part in zip(jobs, chunks):
        frames[job[0]].extend(part)
    return [frames[seed] for seed, _ in scenes]


def depth_mm(depth: np.ndarray) -> np.ndarray:
    return np.round(depth * 1000.0).astype(np.uint16)


def _write_geometry(out_dir: str, seed: int, n_frames: int, width: int, height: int):
    np.savetxt(os.path.join(out_dir, "poses.txt"),
               walk_poses(seed, n_frames, STEP).reshape(n_frames, 16))
    np.savetxt(os.path.join(out_dir, "K.txt"), synth.default_K(width, height))


def write_train_scene(out_dir: str, seed: int, frames, width: int, height: int):
    os.makedirs(out_dir, exist_ok=True)
    for i, (rgb, depth) in enumerate(frames):
        np.savez(os.path.join(out_dir, f"{i:05d}.npz"), image=rgb, depth=depth_mm(depth))
    _write_geometry(out_dir, seed, len(frames), width, height)


def write_eval_scene(out_dir: str, seed: int, frames, width: int, height: int):
    os.makedirs(os.path.join(out_dir, "images"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)
    for i, (rgb, depth) in enumerate(frames):
        write_png(os.path.join(out_dir, "images", f"{i:05d}.png"), rgb, level=1)
        write_png(os.path.join(out_dir, "depth", f"{i:05d}.png"), depth_mm(depth), level=1)
    _write_geometry(out_dir, seed, len(frames), width, height)


def scene_plan(train_scenes: int, val_scenes: int, eval_scenes: int,
               seed_base: int) -> List[Tuple[str, int]]:
    """(folder under the output, seed) of every scene, in render order."""
    plan = []
    for i in range(train_scenes + val_scenes):
        seed = seed_base + i
        name = f"scene_{seed:03d}" if i < train_scenes else f"val_{seed:03d}"
        plan.append((os.path.join("train", name), seed))
    n_total = train_scenes + val_scenes
    for i in range(eval_scenes):
        plan.append((os.path.join("eval", "synth-eval", f"{i:03d}"), seed_base + n_total + i))
    return plan


def make_corpus(output: str, train_scenes: int = 8, val_scenes: int = 2, eval_scenes: int = 9,
                frames: int = 120, width: int = 320, height: int = 256, seed_base: int = 100,
                workers: int = 8):
    plan = scene_plan(train_scenes, val_scenes, eval_scenes, seed_base)
    print(f"rendering {len(plan)} scenes of {frames} frames at {width}x{height} "
          f"({workers} workers)", flush=True)
    rendered = render_scenes([(seed, frames) for _, seed in plan], width, height, workers)
    for (folder, seed), scene_frames in zip(plan, rendered):
        write = write_train_scene if folder.startswith("train") else write_eval_scene
        write(os.path.join(output, folder), seed, scene_frames, width, height)
    train_root = os.path.join(output, "train")
    names = [os.path.basename(folder) for folder, _ in plan[:train_scenes + val_scenes]]
    with open(os.path.join(train_root, "train.txt"), "w") as f:
        f.write("\n".join(names[:train_scenes]) + "\n")
    with open(os.path.join(train_root, "validation.txt"), "w") as f:
        f.write("\n".join(names[train_scenes:]) + "\n")
    print("done:", output, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--output", required=True)
    ap.add_argument("--train-scenes", type=int, default=8)
    ap.add_argument("--val-scenes", type=int, default=2)
    ap.add_argument("--eval-scenes", type=int, default=9)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--seed-base", type=int, default=100)
    ap.add_argument("--workers", type=int, default=8, help="render processes")
    args = ap.parse_args(argv)
    make_corpus(args.output, args.train_scenes, args.val_scenes, args.eval_scenes, args.frames,
                args.width, args.height, args.seed_base, args.workers)


if __name__ == "__main__":
    main()
