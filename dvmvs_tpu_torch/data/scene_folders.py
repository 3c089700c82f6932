"""Synthetic scene folders on disk: ``SynthScene`` walks rendered by spawned
worker processes and written in the canonical layout that the evaluators
read (``images/*.png`` RGB, ``depth/*.png`` in mm, ``poses.txt``, ``K.txt``)
with the port's PNG writer, so nothing here needs OpenCV. ``chip_smoke.py``
and ``apps/bench_bulk.py`` make their scenes with it.
"""

from __future__ import annotations

import multiprocessing
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from dvmvs_tpu_torch.data import synthetic as synth
from dvmvs_tpu_torch.data.io import write_png

POOL_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def spawn_pool(workers: int):
    """A pool of ``workers`` spawned processes whose BLAS and OpenMP run one
    thread each: the renders are NumPy, and a thread a core in every worker
    oversubscribes the host's cores several times over."""
    saved = {k: os.environ.get(k) for k in POOL_THREAD_VARS}
    os.environ.update(dict.fromkeys(POOL_THREAD_VARS, "1"))
    try:
        return multiprocessing.get_context("spawn").Pool(workers)
    finally:  # the workers have started; the parent keeps its own settings
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def walk_poses(seed: int, n_frames: int, step: float,
               lost: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """SynthScene(seed)'s walk at ``step``; frames lost[0]..lost[1]-1 get a
    NaN pose (tracking lost once the run is longer than the keyframe
    buffer's limit)."""
    poses = synth.SynthScene(seed).trajectory(n_frames, step=step)
    if lost is not None:
        poses[lost[0]:lost[1]] = np.nan
    return poses


def render_walk(seed, n_frames, first, last, width, height, step, lost=None):
    """Frames first..last-1 of the walk, (rgb uint8, depth) at width x
    height; frames without a pose are None."""
    scene = synth.SynthScene(seed)
    poses = walk_poses(seed, n_frames, step, lost)
    K = synth.default_K(width, height)
    return [None if np.isnan(poses[i]).any() else scene.render(poses[i], K, width, height)
            for i in range(first, last)]


def write_scene_folders(root: str, scenes: Sequence[Tuple[int, int]], size: Tuple[int, int],
                        step: float, lost: Optional[Tuple[int, int, int]] = None,
                        workers: int = 8) -> list:
    """Scene folders ``root/scene_<seed>`` of the ``(seed, n_frames)`` walks
    in ``scenes``, rendered at ``size`` (width, height) by ``workers``
    spawned processes. ``lost``: (seed, first, last), the frames of that
    scene without a pose (stored black, depth 0). Returns the folders."""
    width, height = size
    jobs = []
    for seed, n in scenes:
        chunk = -(-n // workers)
        gap = lost[1:] if lost is not None and lost[0] == seed else None
        jobs += [(seed, n, i, min(i + chunk, n), width, height, step, gap)
                 for i in range(0, n, chunk)]
    with spawn_pool(workers) as pool:
        chunks = pool.starmap(render_walk, jobs)
    frames = {}
    for (seed, *_), chunk in zip(jobs, chunks):
        frames.setdefault(seed, []).extend(chunk)
    folders = []
    for seed, n in scenes:
        folder = os.path.join(root, f"scene_{seed}")
        os.makedirs(os.path.join(folder, "images"))
        os.makedirs(os.path.join(folder, "depth"))
        for i, frame in enumerate(frames[seed]):
            rgb, depth = frame if frame is not None else (
                np.zeros((height, width, 3), np.uint8), np.zeros((height, width)))
            write_png(os.path.join(folder, "images", f"{i:05d}.png"), rgb, level=1)
            write_png(os.path.join(folder, "depth", f"{i:05d}.png"),
                      np.clip(np.round(depth * 1000.0), 0, 65535).astype(np.uint16), level=1)
        gap = lost[1:] if lost is not None and lost[0] == seed else None
        np.savetxt(os.path.join(folder, "poses.txt"), walk_poses(seed, n, step, gap).reshape(n, 16))
        np.savetxt(os.path.join(folder, "K.txt"), synth.default_K(width, height))
        folders.append(folder)
    return folders
