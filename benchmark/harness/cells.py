"""Helpers the drivers share: the port's ``TestConfig`` built from a
configuration file, waiting for the device and reading its memory peak,
and the plane sweep's geometry of a call, as the port builds it."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import geometry


def test_config(config: dict):
    """The port's ``TestConfig`` of a configuration file."""
    from dvmvs_tpu_torch.config import DepthConfig, TestConfig

    sizes, test = config["sizes"], config["test"]
    depth = DepthConfig(sizes["min_depth"], sizes["max_depth"], sizes["n_depth_levels"])
    return TestConfig(image_width=test["image_width"], image_height=test["image_height"],
                      depth=depth, n_measurement_frames=test["n_measurement_frames"],
                      keyframe_buffer_size=test["keyframe_buffer_size"],
                      keyframe_pose_distance=test["keyframe_pose_distance"],
                      optimal_t_measure=test["optimal_t_measure"],
                      optimal_R_measure=test["optimal_R_measure"])


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def memory_peak(device) -> int:
    return int(torch.cuda.max_memory_allocated()) if torch.device(device).type == "cuda" else 0


def free(device):
    import gc

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def sweep_call(ref_pose, meas_poses, mask, K_half, sizes: dict, device):
    """The forward sweep's geometry of a batch: poses (b, 4, 4) and (b, V, 4,
    4), mask (b, V), K at half resolution (b, 3, 3), as the program builds
    it: (mats (b, V, P, 3, 3), weights (b, V))."""
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)
    inv = geometry.inverse_depth_planes(sizes["min_depth"], sizes["max_depth"],
                                        sizes["n_depth_levels"], device)
    mats = geometry.plane_matrices(t(ref_pose)[:, None], t(meas_poses), t(K_half)[:, None], inv)
    m = t(mask)
    return mats, m / torch.clamp(m.sum(1, keepdim=True), min=1.0)


def half_K(K: np.ndarray) -> np.ndarray:
    out = np.array(K, np.float32, copy=True)
    out[..., :2, :] *= 0.5
    return out
