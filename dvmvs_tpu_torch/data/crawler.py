"""Training-sample crawling over scene pose files (counterpart of
dvmvs_tpu/data/crawler.py; reference: dvmvs/dataset_loader.py:18-252).

Builds (scene, frame-index) samples whose consecutive pose distances fall in
the configured window:
  - pair mode (subsequence length 2): greedy bidirectional scan with window
    loosening x1.1 on failure; 3 passes with multipliers
    (1.0 fwd, 0.666 bwd, 1.5 fwd)
  - subsequence mode: 10 passes over (offset, multiplier, direction) with
    per-frame usage threshold and pair dedupe

Host-side NumPy; parallelized over scenes with a process pool (spawned
workers, so it is safe after CUDA has started).
"""

from __future__ import annotations

import multiprocessing
import os
import random
from functools import partial
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np

from dvmvs_tpu_torch.ops.geometry import pose_distance_np


def is_valid_pair(
    reference_pose,
    measurement_pose,
    pose_dist_min: float,
    pose_dist_max: float,
    t_norm_threshold: float = 0.05,
):
    combined, _, t_measure = pose_distance_np(reference_pose, measurement_pose)
    return pose_dist_min <= combined <= pose_dist_max and t_measure >= t_norm_threshold


def gather_pairs_train(
    poses: np.ndarray,
    used_pairs: Set[Tuple[int, int]],
    is_backward: bool,
    initial_pose_dist_min: float,
    initial_pose_dist_max: float,
) -> List[Tuple[int, int]]:
    """Greedy (reference, measurement) pair collection in one direction."""
    n = len(poses)
    pose_dist_min = initial_pose_dist_min
    pose_dist_max = initial_pose_dist_max
    used_measurement_indices: Set[int] = set()

    if is_backward:
        i, step = n - 1, -1
        first_limit, second_limit = 5, n - 5
    else:
        i, step = 0, 1
        first_limit, second_limit = n - 5, 5

    pairs: List[Tuple[int, int]] = []
    check_future = False
    loosening_counter = 0

    while 0 <= i < n:
        found = None
        scan_range = (
            range(i + step, first_limit, step) if check_future
            else range(i - step, second_limit, -step)
        )
        for j in scan_range:
            if j in used_measurement_indices or (i, j) in used_pairs:
                continue
            if is_valid_pair(poses[i], poses[j], pose_dist_min, pose_dist_max):
                found = (i, j)
                break

        if found is not None:
            pairs.append(found)
            used_pairs.add(found)
            used_pairs.add((found[1], found[0]))
            used_measurement_indices.add(found[1])
            pose_dist_min = initial_pose_dist_min
            pose_dist_max = initial_pose_dist_max
            i += step
            check_future = False
            loosening_counter = 0
        elif check_future:
            pose_dist_min /= 1.1
            pose_dist_max *= 1.1
            check_future = False
            loosening_counter += 1
            if loosening_counter > 1:
                i += step
                loosening_counter = 0
        else:
            check_future = True

    return pairs


PAIR_PASSES = [(1.0, False), (0.666, True), (1.5, False)]
SUBSEQ_PASSES = [
    (0, 1.0, False), (1, 0.666, True), (2, 1.5, False), (0, 0.8, True),
    (1, 1.25, False), (2, 1.0, True), (0, 0.666, False), (1, 1.5, True),
    (2, 0.8, False), (0, 1.25, True),
]


def crawl_scene_pairs(
    scene: str, dataset_path: str, min_pose_distance: float, max_pose_distance: float
) -> List[Dict]:
    poses = np.reshape(
        np.loadtxt(os.path.join(dataset_path, scene, "poses.txt")), (-1, 4, 4)
    )
    samples = []
    used_pairs: Set[Tuple[int, int]] = set()
    for multiplier, backward in PAIR_PASSES:
        pairs = gather_pairs_train(
            poses, used_pairs, backward,
            multiplier * min_pose_distance, multiplier * max_pose_distance)
        samples.extend({"scene": scene, "indices": [i, j]} for i, j in pairs)
    return samples


def crawl_scene_subsequences(
    scene: str,
    dataset_path: str,
    subsequence_length: int,
    min_pose_distance: float,
    max_pose_distance: float,
    crawl_step: int = 3,
) -> List[Dict]:
    poses = np.reshape(
        np.loadtxt(os.path.join(dataset_path, scene, "poses.txt")), (-1, 4, 4)
    )
    n = len(poses)
    usage_threshold = 1
    used_nodes = {i: 0 for i in range(n)}
    used_pairs: Set[Tuple[int, int]] = set()
    samples = []

    for offset, multiplier, is_backward in SUBSEQ_PASSES:
        offset = offset % crawl_step
        if is_backward:
            start, step, limit = n - 1 - offset, -crawl_step, subsequence_length
        else:
            start, step, limit = offset, crawl_step, n - subsequence_length + 1

        for i in range(start, limit, step):
            if used_nodes[i] > usage_threshold:
                continue
            indices = [i]
            previous_index = i
            valid_counter = 1
            any_counter = 1
            reached_sequence_limit = False
            while valid_counter < subsequence_length:
                j = i - any_counter if is_backward else i + any_counter
                reached_sequence_limit = j < 0 if is_backward else j >= n
                if reached_sequence_limit:
                    break
                ok = (
                    used_nodes[j] <= usage_threshold
                    and (previous_index, j) not in used_pairs
                    and is_valid_pair(
                        poses[previous_index], poses[j],
                        multiplier * min_pose_distance,
                        multiplier * max_pose_distance,
                        t_norm_threshold=multiplier * min_pose_distance * 0.5)
                )
                if ok:
                    indices.append(j)
                    previous_index = j
                    valid_counter += 1
                any_counter += 1

            if not reached_sequence_limit:
                prev = indices[0]
                used_nodes[prev] += 1
                for cur in indices[1:]:
                    used_nodes[cur] += 1
                    used_pairs.add((prev, cur))
                    used_pairs.add((cur, prev))
                    prev = cur
                samples.append({"scene": scene, "indices": indices})

    return samples


def crawl(
    dataset_path: str,
    scenes: Sequence[str],
    subsequence_length: int,
    min_pose_distance: float = 0.125,
    max_pose_distance: float = 0.325,
    crawl_step: int = 3,
    num_workers: int = 1,
    seed: int = 0,
) -> List[Dict]:
    if subsequence_length == 2:
        fn = partial(crawl_scene_pairs, dataset_path=dataset_path,
                     min_pose_distance=min_pose_distance,
                     max_pose_distance=max_pose_distance)
    else:
        fn = partial(crawl_scene_subsequences, dataset_path=dataset_path,
                     subsequence_length=subsequence_length,
                     min_pose_distance=min_pose_distance,
                     max_pose_distance=max_pose_distance,
                     crawl_step=crawl_step)

    samples: List[Dict] = []
    if num_workers > 1:
        # Ordered imap: with imap_unordered the concatenation order is a
        # race, so the (seeded) shuffle below permutes a different list on
        # every run and the sample stream is not reproducible across runs
        # of the same seed.
        with multiprocessing.get_context("spawn").Pool(num_workers) as pool:
            for scene_samples in pool.imap(fn, scenes):
                samples.extend(scene_samples)
    else:
        for scene in scenes:
            samples.extend(fn(scene))

    random.Random(seed).shuffle(samples)
    return samples
