"""Baseline plugin protocol and registry (NumPy only; counterpart of
dvmvs_tpu/baselines/registry.py)."""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np


class DepthEstimator:
    """Protocol for depth estimators driven by the shared evaluation loop
    (``apps/run_testing_baseline.py``).

    Attributes:
      image_width/image_height: working resolution
      scale_rgb/mean_rgb/std_rgb: preprocessing normalisation
    """

    image_width: int = 320
    image_height: int = 256
    scale_rgb: float = 1.0
    mean_rgb: Sequence[float] = (81.0, 81.0, 81.0)
    std_rgb: Sequence[float] = (35.0, 35.0, 35.0)

    def reset(self):
        """Called on a new scene and on TRACKING LOST."""

    def predict(
        self,
        ref_image: np.ndarray,
        meas_images: List[np.ndarray],
        ref_pose: np.ndarray,
        meas_poses: List[np.ndarray],
        K: np.ndarray,
    ) -> np.ndarray:
        raise NotImplementedError


BASELINE_REGISTRY: Dict[str, Callable[..., DepthEstimator]] = {}


def register_baseline(name: str):
    def deco(cls):
        BASELINE_REGISTRY[name] = cls
        return cls
    return deco


def pad_views(n_views: int, meas_images: Sequence[np.ndarray],
              meas_poses: Sequence[np.ndarray]):
    """Pad 1..n_views measurement frames to ``n_views`` with the first one.
    Returns (images (V, H, W, 3) float32, poses (V, 4, 4) as given, mask (1,
    V) float32: 1 for the real views, 0 for the padding)."""
    n = len(meas_images)
    mask = np.zeros((1, n_views), np.float32)
    mask[0, :n] = 1.0
    images = list(meas_images) + [meas_images[0]] * (n_views - n)
    poses = list(meas_poses) + [meas_poses[0]] * (n_views - n)
    return np.stack(images).astype(np.float32), np.stack(poses), mask
