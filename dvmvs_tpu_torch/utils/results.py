"""Result saving and inference timing (NumPy copy of dvmvs_tpu/utils/results.py).

Save format is npz-compatible with the reference so its TSDF/plotting
tooling can consume our predictions directly.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np

from dvmvs_tpu_torch.utils.errors import ERROR_NAMES, compute_errors


def save_results(
    predictions: List[np.ndarray],
    groundtruths: Optional[List[np.ndarray]],
    system_name: str,
    scene_name: str,
    save_folder: str,
    max_depth: float = np.inf,
) -> Optional[np.ndarray]:
    os.makedirs(save_folder, exist_ok=True)
    mean_errors = None
    if groundtruths is not None:
        errors = np.array(
            [compute_errors(groundtruths[i], p, max_depth) for i, p in enumerate(predictions)]
        )
        mean_errors = np.nanmean(errors, 0)
        print(f"Metrics of {system_name} for scene {scene_name}:")
        print(("{:>25}, " * 8).format(*ERROR_NAMES).rstrip(", "))
        print(("{:25.4f}, " * 8).format(*mean_errors).rstrip(", "))
        np.savez_compressed(
            os.path.join(save_folder, f"{system_name}_errors_{scene_name}"), errors
        )
    np.savez_compressed(
        os.path.join(save_folder, f"{system_name}_predictions_{scene_name}"),
        np.array(predictions),
    )
    return mean_errors


class InferenceTimer:
    """Per-frame timing with warm-up skip.

    Callers time around the host readback of the prediction, which waits
    for the device; this class just collects the wall-clock intervals.
    """

    def __init__(self, n_skip: int = 20):
        self.times: List[float] = []
        self.n_skip = n_skip
        self._t0: Optional[float] = None

    def record_start_time(self):
        self._t0 = time.perf_counter()

    def record_end_time_and_elapsed_time(self):
        self.times.append((time.perf_counter() - self._t0) * 1000.0)

    def print_statistics(self):
        times = np.array(self.times[self.n_skip :])
        if len(times) > 0:
            print("Number of Forward Passes:", len(times))
            print("--- Mean Inference Time:", np.mean(times))
            print("--- Std Inference Time:", np.std(times))
            print("--- Median Inference Time:", np.median(times))
            print("--- Min Inference Time:", np.min(times))
            print("--- Max Inference Time:", np.max(times))
        else:
            print("Not enough time measurements are taken!")
