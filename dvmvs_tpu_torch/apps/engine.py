"""Inference engine: the device-side steps of the online loop
(counterpart of dvmvs_tpu/apps/engine.py).

  - ``encode``: MnasNet + FPN features of one frame, run once per accepted
    keyframe; the online loop caches the half-resolution features beside the
    keyframe, so measurement features are never recomputed.
  - ``encode_and_predict`` / ``predict``: cost volume -> encoder [-> LSTM]
    -> decoder. For fusionnet the depth hypothesis (forward splat of the
    previous prediction onto the 1/32 grid) is computed on the device from
    the previous depth, which stays there between keyframes.

Measurement views are padded to ``n_measurement_frames`` with copies of
view 0 and a validity mask, so one code path serves every keyframe
cardinality. The LSTM carry, the previous pose and the previous depth live
on the device; only the full-resolution depth of each keyframe is copied to
the host.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from dvmvs_tpu_torch.config import TestConfig
from dvmvs_tpu_torch.models.fusionnet import FusionNet, init_lstm_carry
from dvmvs_tpu_torch.models.layers import init_parameters
from dvmvs_tpu_torch.models.pairnet import PairNet, scale_intrinsics
from dvmvs_tpu_torch.ops.warp import splat_depth_max_strided
from dvmvs_tpu_torch.utils.weights import load_jax_variables


class InferenceEngine:
    def __init__(self, model_kind: str, cfg: TestConfig = TestConfig(), device="cuda",
                 variables=None, seed: int = 0):
        """Runs on the card unless ``device="cpu"`` is asked for; raises if
        the card is asked for and there is none. ``variables``: optional
        Flax ``{"params", "batch_stats"}`` tree to load (see
        utils/weights.py); without it the weights are drawn from a
        ``torch.Generator`` seeded with ``seed``."""
        if model_kind not in ("pairnet", "fusionnet"):
            raise ValueError(f"unknown model kind {model_kind!r}")
        if cfg.image_height % 32 or cfg.image_width % 32:
            raise ValueError("image height and width must be multiples of 32 "
                             "(1/32 bottleneck grid)")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"InferenceEngine: device {device!r} asked for, but "
                               "torch.cuda.is_available() is false; pass device=\"cpu\" to run "
                               "on the CPU")
        self.kind = model_kind
        self.cfg = cfg
        self.H, self.W = cfg.image_height, cfg.image_width
        self.V = cfg.n_measurement_frames

        d = cfg.depth
        net = PairNet if model_kind == "pairnet" else FusionNet
        model = net(d.min_depth, d.max_depth, d.n_depth_levels)
        init_parameters(model, torch.Generator().manual_seed(seed))
        if variables is not None:
            load_jax_variables(model, variables)
        self.model = model.to(self.device).eval()
        self.reset()

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        """Host array -> float32 device tensor without a host sync: on CUDA
        through pinned memory with a non-blocking copy."""
        t = torch.from_numpy(np.ascontiguousarray(array, dtype=np.float32))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _image(self, image: np.ndarray) -> torch.Tensor:
        """(H, W, 3) preprocessed float32 -> (1, 3, H, W) on the device."""
        return self._upload(image).permute(2, 0, 1)[None].contiguous()

    @torch.inference_mode()
    def reset(self):
        """Reset recurrent state (tracking lost / new scene)."""
        self.carry = init_lstm_carry(1, self.H, self.W, device=self.device)
        self.prev_pose = torch.eye(4, device=self.device)[None]
        self.prev_depth = torch.zeros((1, self.H, self.W), device=self.device)
        self.has_prev = torch.zeros((), device=self.device)

    @torch.inference_mode()
    def encode(self, image: np.ndarray):
        """image (H, W, 3) preprocessed float32 -> feature tuple on the
        device, each (1, C, h, w): (half, quarter, one_eight, one_sixteen)."""
        return self.model.extract_features(self._image(image))

    @torch.inference_mode()
    def predict(self, ref_image: np.ndarray, ref_feats, meas_half: Sequence[torch.Tensor],
                ref_pose: np.ndarray, meas_poses: Sequence[np.ndarray],
                K: np.ndarray) -> np.ndarray:
        """One depth prediction from cached features. meas_half: list of
        1..V (1, C, H/2, W/2) measurement features; returns depth (H, W)."""
        depth = self._predict(self._image(ref_image), ref_feats, meas_half, ref_pose,
                              meas_poses, K)
        return depth[0].cpu().numpy()

    @torch.inference_mode()
    def encode_and_predict(self, ref_image: np.ndarray, meas_half: Sequence[torch.Tensor],
                           ref_pose: np.ndarray, meas_poses: Sequence[np.ndarray],
                           K: np.ndarray):
        """The online loop's step: encode the reference frame and predict.
        Returns (depth (H, W) numpy, the frame's half-res features (1, C,
        H/2, W/2) on the device, for the keyframe cache)."""
        image = self._image(ref_image)
        ref_feats = self.model.extract_features(image)
        depth = self._predict(image, ref_feats, meas_half, ref_pose, meas_poses, K)
        return depth[0].cpu().numpy(), ref_feats[0]

    def _predict(self, image, ref_feats, meas_half, ref_pose, meas_poses,
                 K) -> torch.Tensor:
        """Queue one prediction on the device without synchronising; returns
        the full-resolution depth (1, H, W) on the device."""
        V, n = self.V, len(meas_half)
        if not 1 <= n <= V:
            raise ValueError(f"need 1..{V} measurement frames, got {n}")
        mask = np.zeros((1, V), np.float32)
        mask[0, :n] = 1.0
        # padded views repeat view 0 with weight 0
        meas_stack = torch.stack([f[0] for f in meas_half] + [meas_half[0][0]] * (V - n))[None]
        mposes = np.stack(list(meas_poses) + [meas_poses[0]] * (V - n))[None]
        mposes, mask = self._upload(mposes), self._upload(mask)
        ref_pose_t = self._upload(ref_pose[None])
        K_t = self._upload(K[None])

        if self.kind == "pairnet":
            return self.model.predict_depth(image, ref_feats, meas_stack, ref_pose_t,
                                            mposes, K_t, mask)[0]

        # only the stride-16 sites of the half-res splat survive the nearest
        # x1/16 downsample to the 1/32 LSTM grid
        splat = splat_depth_max_strided(
            self.prev_depth, self.prev_pose, ref_pose_t, K_t, scale_intrinsics(K_t, 0.5),
            self.H // 32, self.W // 32, 16)
        depths, self.carry = self.model.predict_depth(
            image, ref_feats, meas_stack, ref_pose_t, mposes, K_t, self.carry,
            self.prev_pose, splat * self.has_prev, mask)
        self.prev_pose = ref_pose_t
        self.prev_depth = depths[0]
        self.has_prev = torch.ones((), device=self.device)
        return depths[0]
