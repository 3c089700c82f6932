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

The bulk evaluators (``apps/run_testing.py``) use the batched steps:
``encode_batch``, ``predict_batch`` (pairnet, B independent keyframes) and
``fusion_step_batch`` (fusionnet, B independent scenes in lockstep, each
with its own recurrent state and a ``keep`` mask that resets it), and their
device-resident form, ``predict_pair_steps`` / ``fusion_steps``: T steps
whose inputs are read with ``index_select`` from the scene's images and
encoded feature bank on the device (a bfloat16 bank is cast to float32
where it is read), queued without a host upload or a host sync.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from dvmvs_tpu_torch.config import TestConfig
from dvmvs_tpu_torch.models.fusionnet import FusionNet, LSTMCarry, init_lstm_carry
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

    def upload(self, array: np.ndarray) -> torch.Tensor:
        """Host array -> float32 device tensor without a host sync: on CUDA
        through pinned memory with a non-blocking copy."""
        t = torch.from_numpy(np.ascontiguousarray(array, dtype=np.float32))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def upload_index(self, array: np.ndarray) -> torch.Tensor:
        """Host integer array -> int64 device tensor, without a host sync."""
        t = torch.from_numpy(np.ascontiguousarray(array, dtype=np.int64))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _image(self, image: np.ndarray) -> torch.Tensor:
        """(H, W, 3) preprocessed float32 -> (1, 3, H, W) on the device."""
        return self.upload(image).permute(2, 0, 1)[None].contiguous()

    def images(self, images: np.ndarray) -> torch.Tensor:
        """(B, H, W, 3) preprocessed float32 -> (B, 3, H, W) on the device."""
        return self.upload(images).permute(0, 3, 1, 2).contiguous()

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
        mposes, mask = self.upload(mposes), self.upload(mask)
        ref_pose_t = self.upload(ref_pose[None])
        K_t = self.upload(K[None])

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

    # ------------------------------------------------------------ bulk steps
    @torch.inference_mode()
    def encode_batch(self, images) -> Tuple[torch.Tensor, ...]:
        """(B, H, W, 3) preprocessed float32 frames (host array) or (B, 3,
        H, W) device tensor -> feature tuple, each (B, C, h, w)."""
        if isinstance(images, np.ndarray):
            images = self.images(images)
        return self.model.extract_features(images)

    @torch.inference_mode()
    def predict_batch(self, ref_images, ref_feats, meas_half, ref_poses, meas_poses, K,
                      view_mask) -> torch.Tensor:
        """B independent pairnet keyframes in one step, device tensors:
        ref_images (B, 3, H, W); ref_feats tuple of (B, C, h, w); meas_half
        (B, V, C, H/2, W/2); ref_poses (B, 4, 4); meas_poses (B, V, 4, 4);
        K (B, 3, 3); view_mask (B, V). Returns depth (B, H, W) on the device."""
        if self.kind != "pairnet":
            raise ValueError("predict_batch is the stateless (pairnet) step")
        return self.model.predict_depth(ref_images, ref_feats, meas_half, ref_poses, meas_poses,
                                        K, view_mask)[0]

    def init_batch_state(self, batch: int):
        """Zero recurrent state of ``batch`` independent scenes: (carry,
        prev_pose (B, 4, 4), prev_depth (B, H, W), has_prev (B,))."""
        return (init_lstm_carry(batch, self.H, self.W, device=self.device),
                torch.eye(4, device=self.device).repeat(batch, 1, 1),
                torch.zeros((batch, self.H, self.W), device=self.device),
                torch.zeros((batch,), device=self.device))

    @torch.inference_mode()
    def fusion_step_batch(self, ref_images, ref_feats, meas_half, ref_poses, meas_poses, K,
                          view_mask, state, keep):
        """One lockstep fusionnet step over B independent scenes (arguments
        as ``predict_batch``). ``keep`` (B,) float: 0 zeroes that scene's
        carry, previous depth and ``has_prev`` before the step (tracking
        lost or a new scene), as ``reset`` does for one. Returns (depth (B,
        H, W), new state), both on the device."""
        if self.kind != "fusionnet":
            raise ValueError("fusion_step_batch is the recurrent (fusionnet) step")
        carry, prev_pose, prev_depth, has_prev = state
        k4 = keep.reshape(-1, 1, 1, 1)
        carry = LSTMCarry(carry.h * k4, carry.c * k4)
        prev_depth = prev_depth * keep.reshape(-1, 1, 1)
        has_prev = has_prev * keep
        splat = splat_depth_max_strided(
            prev_depth, prev_pose, ref_poses, K, scale_intrinsics(K, 0.5),
            self.H // 32, self.W // 32, 16)
        depths, carry = self.model.predict_depth(
            ref_images, ref_feats, meas_half, ref_poses, meas_poses, K, carry, prev_pose,
            splat * has_prev.reshape(-1, 1, 1), view_mask)
        return depths[0], (carry, ref_poses, depths[0], torch.ones_like(has_prev))

    @contextlib.contextmanager
    def recording_cost_volumes(self):
        """Within the block, the yielded list gets every cost volume the
        model computes, one (B, P, h, w) float32 host array a call. Checks
        of the bulk paths read it: with seeded random weights a wrong
        feature row moves the depth by about 1e-6 m but the cost volume by
        a tenth of its range. Each call copies to the host, so the run
        syncs once a step."""
        calls = []
        real = self.model.cost_volume

        def cost_volume(*args, **kwargs):
            out = real(*args, **kwargs)
            calls.append(out.float().cpu().numpy())
            return out

        self.model.cost_volume = cost_volume
        try:
            yield calls
        finally:
            del self.model.cost_volume

    @staticmethod
    def gather_features(bank, ref_idx, meas_idx):
        """Read one step's features from a device-resident bank: a tuple of
        (N, C, h, w) scales (float32 or bfloat16), ``ref_idx`` (B,) and
        ``meas_idx`` (B, V) int64. Returns (ref_feats, meas_half (B, V, C,
        H/2, W/2)) in float32."""
        B, V = meas_idx.shape
        ref_feats = tuple(b.index_select(0, ref_idx).float() for b in bank)
        meas = bank[0].index_select(0, meas_idx.reshape(-1)).float()
        return ref_feats, meas.reshape((B, V) + tuple(meas.shape[1:]))

    @classmethod
    def gather_step_inputs(cls, bank, images, ref_idx, meas_idx):
        """``gather_features`` plus the reference frames from the
        device-resident (N, 3, H, W) ``images``: (ref_images, ref_feats,
        meas_half)."""
        return (images.index_select(0, ref_idx),) + cls.gather_features(bank, ref_idx, meas_idx)

    @torch.inference_mode()
    def predict_pair_steps(self, bank, images, K, xs: Dict[str, torch.Tensor]) -> torch.Tensor:
        """T pairnet batches from the device-resident images and bank.
        ``xs``: device tensors ref_idx (T, B), meas_idx (T, B, V),
        ref_pose (T, B, 4, 4), meas_pose (T, B, V, 4, 4), view_mask (T, B,
        V); K (B, 3, 3). Returns depth (T, B, H, W) on the device."""
        out = []
        for t in range(xs["ref_idx"].shape[0]):
            ref_images, ref_feats, meas_half = self.gather_step_inputs(
                bank, images, xs["ref_idx"][t], xs["meas_idx"][t])
            out.append(self.predict_batch(ref_images, ref_feats, meas_half, xs["ref_pose"][t],
                                          xs["meas_pose"][t], K, xs["view_mask"][t]))
        return torch.stack(out)

    @torch.inference_mode()
    def fusion_steps(self, bank, images, K, state, xs: Dict[str, torch.Tensor]):
        """T lockstep fusionnet steps from the device-resident images and
        bank; ``xs`` as in ``predict_pair_steps`` plus keep (T, B). The state
        threads through, so a scene can be split into chunks. Returns (new
        state, depth (T, B, H, W) on the device)."""
        out = []
        for t in range(xs["ref_idx"].shape[0]):
            ref_images, ref_feats, meas_half = self.gather_step_inputs(
                bank, images, xs["ref_idx"][t], xs["meas_idx"][t])
            depth, state = self.fusion_step_batch(
                ref_images, ref_feats, meas_half, xs["ref_pose"][t], xs["meas_pose"][t], K,
                xs["view_mask"][t], state, xs["keep"][t])
            out.append(depth)
        return state, torch.stack(out)
