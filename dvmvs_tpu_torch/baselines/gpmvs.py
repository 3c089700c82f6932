"""GP-MVS baseline (counterpart of dvmvs_tpu/baselines/gpmvs.py; reference:
dvmvs/baselines/gpmvs/).

The MVDepthNet backbone and L1 sweep + Gaussian-process fusion of the
bottleneck latent. Online, the Matern-3/2 GP runs in its Kalman
(state-space) form (reference: gpmvs/run-testing.py:97-103, 177-193): per
keyframe the 2-state SDE is propagated by expm(F dt) over the pose
distance, then a scalar Kalman update of the flattened conv5 latent; the
smoothed latent, ReLU'd, replaces conv5 in the decoder. The filter stays
NumPy float64 on the host, as in the JAX package: conv5 goes to the host
and comes back as float32. The batch GP form is ``gp_batch_smooth``. On the
card ``predict`` is two CUDA graph replays, the JAX package's two jits: the
encoder (the sweep's kernel launched inside it) and the decoder, which
reads conv4..conv1 from the encoder graph's buffers on the device.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch
import torch.nn as nn
from scipy.linalg import expm

from dvmvs_tpu_torch.baselines.mvdepth_backbone import MVDepthDecoder, MVDepthEncoder
from dvmvs_tpu_torch.baselines.mvdepthnet import (
    MVDepthNet,
    device_views,
    host_views,
    inverse_disparity,
    l1_cost_volume,
)
from dvmvs_tpu_torch.baselines.registry import register_baseline
from dvmvs_tpu_torch.models.layers import seeded_model
from dvmvs_tpu_torch.ops.geometry import pose_distance_np
from dvmvs_tpu_torch.utils.blas_threads import single_threaded_blas

HYPERPARAMETERS = ("gamma2", "ell", "sigma2")


def matern32_kernel(D: np.ndarray, gamma2: float, ell: float) -> np.ndarray:
    """Matern-3/2 covariance over a pose-distance matrix (reference:
    gplayer.py:26-30)."""
    s = np.sqrt(3.0) * D / ell
    return gamma2 * (1.0 + s) * np.exp(-s)


def gp_batch_smooth(D: np.ndarray, Y: np.ndarray, gamma2: float, ell: float,
                    sigma2: float) -> np.ndarray:
    """Batch GP posterior mean Z = K (K + sigma2 I)^-1 Y, ReLU'd (reference:
    gplayer.py:21-35). D: (N, N); Y: (N, d)."""
    K = matern32_kernel(D, gamma2, ell)
    C = K + sigma2 * np.eye(len(D))
    Z = K @ np.linalg.solve(C, Y)
    return np.maximum(Z, 0.0)


class KalmanLatentState:
    """Matern-3/2 state-space filter over the bottleneck latent."""

    def __init__(self, latent_dim: int, gamma2: float, ell: float, sigma2: float):
        lam = np.sqrt(3.0) / ell
        self.F = np.array([[0.0, 1.0], [-lam ** 2, -2 * lam]])
        self.Pinf = np.array([[gamma2, 0.0], [0.0, gamma2 * lam ** 2]])
        self.h = np.array([[1.0], [0.0]])
        self.sigma2 = sigma2
        self.latent_dim = latent_dim
        self.reset()

    def reset(self):
        self.M = np.zeros((2, self.latent_dim))
        self.P = self.Pinf.copy()

    def step(self, y: np.ndarray, dt: float) -> np.ndarray:
        """Propagate by dt (pose distance) and update with observation y."""
        A = expm(self.F * dt)
        Q = self.Pinf - A @ self.Pinf @ A.T
        self.M = A @ self.M
        self.P = A @ self.P @ A.T + Q

        v = y[None, :] - self.h.T @ self.M
        s = float((self.h.T @ self.P @ self.h)[0, 0]) + self.sigma2
        k = self.P @ self.h / s
        self.M += k @ v
        self.P -= k @ self.h.T @ self.P
        return self.M[0]


class GPLayer(nn.Module):
    """The reference's GP layer: the logs of the hyper-parameters as float64
    buffers (the reference applies exp() at use, gplayer.py:11-13, 29-31)."""

    def __init__(self, gamma2: float = 1.0, ell: float = 1.0, sigma2: float = 0.1):
        super().__init__()
        for name, value in zip(HYPERPARAMETERS, (gamma2, ell, sigma2)):
            self.register_buffer(name, torch.tensor([math.log(value)], dtype=torch.float64))

    def hyperparameters(self) -> dict:
        return {name: float(np.exp(getattr(self, name).item())) for name in HYPERPARAMETERS}


class GPMVSModel(nn.Module):
    """Encoder, GP layer and decoder: ``encoder``, ``gplayer`` and ``decoder``
    state dicts are the reference's three weight files."""

    def __init__(self, gamma2: float = 1.0, ell: float = 1.0, sigma2: float = 0.1):
        super().__init__()
        self.encoder = MVDepthEncoder()
        self.gplayer = GPLayer(gamma2, ell, sigma2)
        self.decoder = MVDepthDecoder()

    def encode(self, image, meas_images, pose, meas_poses, K, mask):
        cv = l1_cost_volume(image, meas_images, pose, meas_poses, K, mask)
        return self.encoder(image, cv)

    def decode(self, conv5, conv4, conv3, conv2, conv1):
        return inverse_disparity(self.decoder(conv5, conv4, conv3, conv2, conv1)[0])


@register_baseline("gpmvs")
class GPMVS(MVDepthNet):
    def __init__(self, n_measurement_frames: int = 2, state_dict=None, gamma2: float = 1.0,
                 ell: float = 1.0, sigma2: float = 0.1, seed: int = 0, device="cuda",
                 graphs: bool = True):
        """As MVDepthNet; the hyper-parameters come from ``state_dict``'s
        ``gplayer.*`` when given, else from the arguments."""
        self.V = n_measurement_frames
        self.model = seeded_model(GPMVSModel(gamma2, ell, sigma2), seed, device, state_dict)
        self.device = next(self.model.parameters()).device
        self._init_steps(graphs)
        H, W = self.image_height, self.image_width
        latent_dim = 512 * (H // 32) * (W // 32)
        self.kalman = KalmanLatentState(latent_dim, **self.model.gplayer.hyperparameters())
        self.prev_pose: Optional[np.ndarray] = None

    def reset(self):
        """A new scene or TRACKING LOST: the Kalman state restarts; the
        graphs stay."""
        self.kalman.reset()
        self.prev_pose = None

    def _encode_body(self, **views):
        return self.model.encode(*device_views(**views))

    def _decode_body(self, conv5, skips):
        return self.model.decode(conv5, *skips)

    @torch.inference_mode()
    def predict(self, ref_image, meas_images: List[np.ndarray], ref_pose, meas_poses,
                K) -> np.ndarray:
        views = host_views(self.V, ref_image, meas_images, ref_pose, meas_poses, K)
        conv5, *skips = self._step("encode", self._encode_body, views)
        # Kalman smoothing of the flattened latent on the host; every latent
        # dimension has its own independent filter, so the NCHW order is as
        # good as the JAX package's NHWC. OpenBLAS on one thread: its spinning
        # workers would otherwise starve the thread that replays the graphs
        if self.prev_pose is None:
            self.prev_pose = meas_poses[-1]
        dt, _, _ = pose_distance_np(ref_pose, self.prev_pose)
        latent = self._to_host(conv5).ravel()
        with single_threaded_blas():
            z = self.kalman.step(latent, dt)
        self.prev_pose = ref_pose
        z = np.maximum(z, 0.0).reshape(conv5.shape).astype(np.float32)
        return self._readback(self._step("decode", self._decode_body, {"conv5": z},
                                         fixed={"skips": tuple(skips)}))
