"""The general traffic generator: reads a mix's parameters
(``traffic/<mix>.json``) and makes its inputs from the run's seed.

Two kinds of mix:

  - ``walks``: one camera walk of ``frames`` poses, about ``step_m``
    apart (``SynthScene.trajectory``), for each entry of ``walks``, through
    a room drawn from the run's seed out of the entry's ``rooms``: rooms
    whose walk gives exactly the entry's ``keyframes`` under the
    configuration's keyframe heuristic (checked here). So every seed
    streams other geometry with the same number of frames and keyframes,
    the walks in an order of its own; and a pool of ``pool`` normalised
    frames of seeded noise that the walks draw their pixels from. The
    convolutions are dense and the sweep's in-range samples depend only on
    poses and K, so pixel content changes the work of no timed layer;
    rendering each frame would cost about 0.1 s of set-up a frame.
  - ``subsequences``: ``batches`` training batches of the configuration's
    batch size, each row a subsequence of the configuration's length from
    a walk of its own room, its consecutive frames ``pose_distance`` apart
    (DeepVideoMVS's training window: combined pose distance in [min, max]
    and at least ``min_translation_m`` of translation, the first later
    frame that fits), rendered with exact depth. Every row is another
    room, so no two rows of the first batches are alike.
"""

from __future__ import annotations

import multiprocessing
import os

import numpy as np

from benchmark.harness import synth
from benchmark.harness.core import seeds
from benchmark.reference.geometry import pose_distance
from benchmark.reference.loops import KeyframeBuffer

MEAN_RGB, STD_RGB = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def normalise(rgb: np.ndarray) -> np.ndarray:
    """uint8 RGB -> the network's ImageNet-normalised float32."""
    out = rgb.astype(np.float32) / 255.0
    return ((out - np.asarray(MEAN_RGB, np.float32)) / np.asarray(STD_RGB, np.float32)
            ).astype(np.float32)


def make(traffic: dict, config: dict, seed: int, workers: int = 0) -> dict:
    if traffic["kind"] == "walks":
        return walks(traffic, config["test"], seed)
    if traffic["kind"] == "subsequences":
        return subsequences(traffic, config["train"], seed, workers)
    raise ValueError(f"unknown traffic kind {traffic['kind']!r}")


def walks(traffic: dict, test: dict, seed: int) -> dict:
    """{"poses": [(frames, 4, 4) float64 a walk], "frame_ids": [(frames,) int
    a walk], "pool": (pool, H, W, 3) float32, "K": (3, 3) float32}."""
    H, W = test["image_height"], test["image_width"]
    n = len(traffic["walks"])
    room_seed, pool_seed, ids_seed = seeds(seed, 3)
    rooms = np.random.RandomState(room_seed)
    poses = []
    for w in rooms.permutation(n):
        spec = traffic["walks"][w]
        walk = synth.SynthScene(int(rooms.choice(spec["rooms"]))).trajectory(
            traffic["frames"], step=traffic["step_m"])
        if count_keyframes(walk, test) != spec["keyframes"]:
            raise ValueError(f"a room of walk {w} does not give {spec['keyframes']} keyframes")
        poses.append(walk)
    rs = np.random.RandomState(pool_seed)
    pool = normalise(rs.randint(0, 256, (traffic["pool"], H, W, 3), dtype=np.uint8))
    ids = np.random.RandomState(ids_seed).randint(0, traffic["pool"], (n, traffic["frames"]))
    return {"poses": poses, "frame_ids": list(ids), "pool": pool,
            "K": synth.default_K(W, H).astype(np.float32)}


def count_keyframes(poses, test: dict) -> int:
    """Keyframes the configuration's keyframe heuristic predicts on a walk."""
    buf = KeyframeBuffer(test["keyframe_buffer_size"], test["keyframe_pose_distance"],
                         test["optimal_t_measure"], test["optimal_R_measure"])
    return sum(buf.offer(pose, None) == 1 for pose in poses)


def pick_subsequence(poses: np.ndarray, length: int, lo: float, hi: float, min_t: float,
                     start: int):
    """Frame indices from ``start``: each the first later frame whose
    combined distance to the previous pick is in [lo, hi] with at least
    ``min_t`` of translation; None if the walk ends first."""
    picked = [start]
    while len(picked) < length:
        prev = picked[-1]
        for j in range(prev + 1, len(poses)):
            combined, _, t = pose_distance(poses[prev], poses[j])
            if lo <= combined <= hi and t >= min_t:
                picked.append(j)
                break
        else:
            return None
    return picked


def _render(job):
    scene_seed, poses, size = job
    scene = synth.SynthScene(scene_seed)
    K = synth.default_K(size, size)
    frames = [scene.render(p, K, size, size) for p in poses]
    return (np.stack([normalise(rgb) for rgb, _ in frames]),
            np.stack([depth for _, depth in frames]))


def subsequences(traffic: dict, train: dict, seed: int, workers: int = 0) -> dict:
    """{"batches": [{"images" (B, S, H, W, 3), "depths" (B, S, H, W), "poses"
    (B, S, 4, 4), "K" (B, 3, 3)}, ...]} as float32 host arrays."""
    B, S, size = train["batch_size"], train["subsequence_length"], train["image_size"]
    lo, hi = traffic["pose_distance"]
    rows = traffic["batches"] * B
    jobs = []
    for room_seed in seeds(seed, 4 * rows):
        scene = synth.SynthScene(room_seed)
        poses = scene.trajectory(traffic["walk_frames"], step=traffic["step_m"])
        start = int(np.random.RandomState(room_seed).randint(0, len(poses) // 4))
        picked = pick_subsequence(poses, S, lo, hi, traffic["min_translation_m"], start)
        if picked is not None:
            jobs.append((room_seed, poses[picked], size))
        if len(jobs) == rows:
            break
    if len(jobs) < rows:
        raise RuntimeError("too few walks hold a subsequence in the pose window")
    if workers > 1:
        # forked before the driver touches the card; the renders use NumPy only
        with multiprocessing.get_context("fork").Pool(workers) as pool:
            rendered = pool.map(_render, jobs)
            pool.close()
            pool.join()
    else:
        rendered = [_render(job) for job in jobs]
    K = synth.default_K(size, size).astype(np.float32)
    batches = []
    for b in range(traffic["batches"]):
        part = range(b * B, (b + 1) * B)
        batches.append({
            "images": np.stack([rendered[i][0] for i in part]),
            "depths": np.stack([rendered[i][1] for i in part]),
            "poses": np.stack([jobs[i][1] for i in part]).astype(np.float32),
            "K": np.stack([K] * B)})
    return {"batches": batches}


def render_workers() -> int:
    return max(1, min(8, os.cpu_count() or 1))
