"""Depth evaluation metrics (NumPy copy of dvmvs_tpu/utils/errors.py).

8 metrics over valid pixels (gt >= 0.5 m and gt <= max_depth): abs, abs-rel,
abs-inv, sq-rel, rmse, and the three delta<1.25^k inlier ratios. Host-side
NumPy — evaluation happens after predictions come back from device.
"""

from __future__ import annotations

import numpy as np

ERROR_NAMES = (
    "abs_error",
    "abs_relative_error",
    "abs_inverse_error",
    "squared_relative_error",
    "rmse",
    "ratio_125",
    "ratio_125_2",
    "ratio_125_3",
)


def compute_errors(gt: np.ndarray, pred: np.ndarray, max_depth: float = np.inf):
    valid = (gt >= 0.5) & (gt <= max_depth)
    gt = gt[valid]
    pred = pred[valid]

    if len(gt) == 0:
        return (np.nan,) * 8

    diff = gt - pred
    abs_diff = np.abs(diff)
    sq_diff = np.square(diff)
    abs_error = np.mean(abs_diff)
    abs_relative_error = np.mean(abs_diff / gt)
    abs_inverse_error = np.mean(np.abs(1.0 / gt - 1.0 / pred))
    squared_relative_error = np.mean(sq_diff / gt)
    rmse = np.sqrt(np.mean(sq_diff))
    ratios = np.maximum(gt / pred, pred / gt)
    n = np.float32(len(ratios))
    ratio_125 = np.count_nonzero(ratios < 1.25) / n
    ratio_125_2 = np.count_nonzero(ratios < 1.25 ** 2) / n
    ratio_125_3 = np.count_nonzero(ratios < 1.25 ** 3) / n
    return (
        abs_error,
        abs_relative_error,
        abs_inverse_error,
        squared_relative_error,
        rmse,
        ratio_125,
        ratio_125_2,
        ratio_125_3,
    )
