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
on the device in buffers that every step updates in place; only the
full-resolution depth of each keyframe is copied to the host.

The bulk evaluators (``apps/run_testing.py``) use the batched steps:
``encode_batch``, ``predict_batch`` (pairnet, B independent keyframes) and
``fusion_step_batch`` (fusionnet, B independent scenes in lockstep, each
with its own recurrent state and a ``keep`` mask that resets it), and their
device-resident form, ``predict_pair_steps`` / ``fusion_steps``: a chunk of
T steps whose inputs are read with ``index_select`` from the scene's images
and encoded feature bank on the device (a bfloat16 bank is cast to float32
where it is read), without a host upload or a host sync.

Every step has one body, a function of tensors (``_*_body``), run one of two
ways. With ``graphs=True`` (the default) it runs on static buffers: the
inputs are copied in, the body runs as one CUDA graph replay on the card
(``apps/graphs.py``; captured at first use per shape, the counterpart of the
JAX engine's eight jitted programs, a chunk of T steps being the
``lax.scan`` of ``_predict_pair_scan`` / ``_fusion_scan``) and without
capture on the CPU, and what the caller keeps is copied out of the output
buffers. With ``graphs=False`` the body is called on fresh tensors (the
eager path; ``recording_cost_volumes`` and ``profile_step``'s per-module
split run it). A failed capture or replay raises: nothing falls back to
the eager path. Both ways compute in IEEE float32, the reference's mode,
whatever the process's TF32 flags are (``utils/precision.py``).

Under ``torch.profiler`` the host work of a graphed step shows as spans
(``utils/profiling.py::span``): ``dvmvs.engine.inputs`` (the online step's
packing), ``dvmvs.engine.fill`` (the graph lookup, eviction and copy-in),
``dvmvs.graph.run``, ``dvmvs.engine.readback`` and, when a bank is
allocated, ``dvmvs.engine.bank_alloc``. The counters ``graph.evictions``,
``bank.allocations``, ``engine.h2d_bytes`` and ``engine.d2h_bytes`` count
the graphs dropped for another bank, the banks allocated and the bytes
copied in from host arrays and read back.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from dvmvs_tpu_torch.apps.graphs import WARMUP_RUNS, StepGraph, fill, leaves, tree_map
from dvmvs_tpu_torch.config import TestConfig
from dvmvs_tpu_torch.models.fusionnet import FusionNet, LSTMCarry, init_lstm_carry
from dvmvs_tpu_torch.models.layers import init_parameters
from dvmvs_tpu_torch.models.pairnet import PairNet, scale_intrinsics
from dvmvs_tpu_torch.ops.warp import splat_depth_max_strided
from dvmvs_tpu_torch.utils.precision import ieee_float32
from dvmvs_tpu_torch.utils.profiling import counters, span
from dvmvs_tpu_torch.utils.weights import load_jax_variables

# a bank's storage is allocated in whole multiples of this many frames, so
# that the next scene's bank usually fits at the same addresses
BANK_ROWS = 64


class InferenceEngine:
    def __init__(self, model_kind: str, cfg: TestConfig = TestConfig(), device="cuda",
                 variables=None, seed: int = 0, graphs: bool = True):
        """Runs on the card unless ``device="cpu"`` is asked for; raises if
        the card is asked for and there is none. ``variables``: optional
        Flax ``{"params", "batch_stats"}`` tree to load (see
        utils/weights.py); without it the weights are drawn from a
        ``torch.Generator`` seeded with ``seed``. ``graphs``: run each step
        on static buffers, as one CUDA graph replay on the card (module
        doc); False calls the step bodies eagerly."""
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
        self.graphs = graphs
        # the captured steps by (name, cost volumes kept, input shapes, bank
        # and frames read in place); shapes warmed up by an earlier capture
        self.step_graphs: Dict[tuple, StepGraph] = {}
        self._warmed = set()
        self._batch_states = {}
        self._bank = None  # (bank, frames) storage of bulk evaluation
        self._recording = None
        self._record_graphed = False

        d = cfg.depth
        net = PairNet if model_kind == "pairnet" else FusionNet
        model = net(d.min_depth, d.max_depth, d.n_depth_levels)
        init_parameters(model, torch.Generator().manual_seed(seed))
        if variables is not None:
            load_jax_variables(model, variables)
        self.model = model.to(self.device).eval()
        self.carry, self.prev_pose, self.prev_depth, self.has_prev = self.init_batch_state(1)
        self._eye = self.prev_pose.clone()

    def upload(self, array: np.ndarray) -> torch.Tensor:
        """Host array -> float32 device tensor without a host sync: on CUDA
        through pinned memory with a non-blocking copy."""
        t = torch.from_numpy(np.ascontiguousarray(array, dtype=np.float32))
        counters.add("engine.h2d_bytes", t.nbytes)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def upload_index(self, array: np.ndarray) -> torch.Tensor:
        """Host integer array -> int64 device tensor, without a host sync."""
        t = torch.from_numpy(np.ascontiguousarray(array, dtype=np.int64))
        counters.add("engine.h2d_bytes", t.nbytes)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def images(self, images: np.ndarray) -> torch.Tensor:
        """(B, H, W, 3) preprocessed float32 -> (B, 3, H, W) on the device."""
        return self.upload(images).permute(0, 3, 1, 2).contiguous()

    # ------------------------------------------------- running a step body
    def _graphed(self) -> bool:
        return self.graphs and (self._recording is None or self._record_graphed)

    def _fresh(self, value):
        """An input as the eager path takes it: a host float32 array uploaded,
        a list of (1, ...) views stacked at dim 1, device tensors as given."""
        if isinstance(value, np.ndarray):
            return self.upload(value)
        if isinstance(value, list):
            return torch.stack(value, dim=1)
        return value

    def _buffer(self, value):
        """A static buffer for an input (``_fresh``'s shapes)."""
        if isinstance(value, np.ndarray):
            return torch.empty(value.shape, dtype=torch.float32, device=self.device)
        if isinstance(value, list):
            shape = (value[0].shape[0], len(value)) + tuple(value[0].shape[1:])
            return torch.empty(shape, dtype=value[0].dtype, device=self.device)
        return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=self.device),
                        value)

    def _fill(self, buffer, value):
        """Copy an input into its static buffer (a host array through pinned
        memory, without a host sync)."""
        if isinstance(value, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(value, dtype=np.float32))
            counters.add("engine.h2d_bytes", t.nbytes)
            fill(buffer, t)
        elif isinstance(value, list):
            for i, view in enumerate(value):
                buffer[:, i].copy_(view)
        else:
            for dst, src in zip(leaves(buffer), leaves(value)):
                dst.copy_(src)

    @staticmethod
    def _signature(inputs: dict, fixed: dict) -> tuple:
        def shape(v):
            if isinstance(v, np.ndarray):
                return (v.shape,)
            if isinstance(v, list):
                return (len(v), tuple(v[0].shape), v[0].dtype)
            return tuple((tuple(t.shape), t.dtype) for t in leaves(v))

        return (tuple((k, shape(v)) for k, v in inputs.items()),
                tuple(map(InferenceEngine._where, leaves(fixed))))

    @staticmethod
    def _where(t: torch.Tensor) -> tuple:
        """What a graph that reads ``t`` in place is keyed on."""
        return t.data_ptr(), tuple(t.shape), t.stride(), t.dtype

    def _run(self, name: str, body, inputs: dict, fixed=None, state=None,
             cost_volumes: bool = True):
        """Run a step body. ``inputs`` (host float32 arrays, device tensors,
        trees of them, or a list of views) are copied into the step's static
        buffers on the graph path; ``fixed`` tensors (a bank, frames) are
        read in place, so the graph is keyed on their addresses and graphs
        of another bank are dropped; ``state`` is written in place. Returns
        the body's outputs: on the graph path the static buffers, valid
        until the step runs again."""
        fixed = fixed or {}
        extra = {} if state is None else {"state": state}
        if not self._graphed():
            with ieee_float32():
                return body(**{k: self._fresh(v) for k, v in inputs.items()}, **fixed, **extra)
        with span("dvmvs.engine.fill"):
            tap = self._recording is not None and cost_volumes
            shapes, addresses = self._signature(inputs, fixed)
            key = (name, tap, shapes, addresses)
            step = self.step_graphs.get(key)
            if step is None:
                if addresses:  # drop the graphs of a bank that is not the engine's own
                    owned = set(map(self._where, leaves(self._bank)))
                    n = len(self.step_graphs)
                    self.step_graphs = {k: v for k, v in self.step_graphs.items()
                                        if not k[3] or k[3] == addresses or set(k[3]) <= owned}
                    counters.add("graph.evictions", n - len(self.step_graphs))
                warm = key[:3] not in self._warmed
                self._warmed.add(key[:3])
                args = {k: self._buffer(v) for k, v in inputs.items()}
                step = self.step_graphs[key] = StepGraph(
                    name, self._tapped(body) if tap else body, {**args, **fixed, **extra},
                    state=tuple(leaves(state)), warmup=WARMUP_RUNS if warm else 0)
            for k, v in inputs.items():
                self._fill(step.args[k], v)
        out = step.run()
        if tap:
            out, cvs = out
            self._recording.extend(cv.to("cpu", torch.float32, copy=True).numpy() for cv in cvs)
        return out

    @staticmethod
    def _readback(depth: torch.Tensor) -> np.ndarray:
        """The host copy of a (1, H, W) depth, the step's one host sync (a
        copy on the CPU too, where ``.cpu()`` would alias the buffer)."""
        with span("dvmvs.engine.readback"):
            out = depth[0].to("cpu", copy=True).numpy()
        counters.add("engine.d2h_bytes", out.nbytes)
        return out

    def _copy_out(self, tensor: torch.Tensor) -> torch.Tensor:
        """What a caller keeps of a step's output: on the graph path a copy,
        since the next replay rewrites the output buffer."""
        return tensor.clone() if self._graphed() else tensor

    def _write_state(self, state, new):
        """The end of a recurrent step: the new state written into the state
        buffers in place, where the next step (or replay) reads it."""
        for dst, src in zip(leaves(state), leaves(new)):
            dst.copy_(src)

    def _tapped(self, body):
        """``body`` that also returns every cost volume it computes."""
        def tapped(**args):
            cvs = []
            real = self.model.cost_volume

            def cost_volume(*a, **k):
                cvs.append(real(*a, **k))
                return cvs[-1]

            self.model.cost_volume = cost_volume
            try:
                out = body(**args)
            finally:
                del self.model.cost_volume
            return out, tuple(cvs)
        return tapped

    # ----------------------------------------------------------- step bodies
    def _predict_core(self, image, ref_feats, meas, ref_pose, meas_pose, K, mask, state):
        """Depth (B, H, W); fusionnet writes its new state into ``state``."""
        if self.kind == "pairnet":
            return self.model.predict_depth(image, ref_feats, meas, ref_pose, meas_pose, K,
                                            mask)[0]
        depth, new = self._fusion_core(image, ref_feats, meas, ref_pose, meas_pose, K, mask,
                                       state)
        self._write_state(state, new)
        return depth

    def _fusion_core(self, ref_images, ref_feats, meas_half, ref_poses, meas_poses, K,
                     view_mask, state, keep=None):
        """One recurrent step over B scenes: ``keep`` (B,) zeroes a scene's
        carry, previous depth and ``has_prev`` first. Returns (depth (B, H,
        W), new state)."""
        carry, prev_pose, prev_depth, has_prev = state
        if keep is not None:
            k4 = keep.reshape(-1, 1, 1, 1)
            carry = LSTMCarry(carry.h * k4, carry.c * k4)
            prev_depth = prev_depth * keep.reshape(-1, 1, 1)
            has_prev = has_prev * keep
        # only the stride-16 sites of the half-res splat survive the nearest
        # x1/16 downsample to the 1/32 LSTM grid
        splat = splat_depth_max_strided(
            prev_depth, prev_pose, ref_poses, K, scale_intrinsics(K, 0.5),
            self.H // 32, self.W // 32, 16)
        depths, carry = self.model.predict_depth(
            ref_images, ref_feats, meas_half, ref_poses, meas_poses, K, carry, prev_pose,
            splat * has_prev.reshape(-1, 1, 1), view_mask)
        return depths[0], (carry, ref_poses, depths[0], torch.ones_like(has_prev))

    def _geometry(self, geometry):
        """The online step's packed float32 inputs -> ref_pose (1, 4, 4),
        meas_pose (1, V, 4, 4), K (1, 3, 3), view mask (1, V)."""
        V = self.V
        return (geometry[:16].view(1, 4, 4), geometry[16:16 + 16 * V].view(1, V, 4, 4),
                geometry[16 + 16 * V:25 + 16 * V].view(1, 3, 3), geometry[25 + 16 * V:].view(1, V))

    @staticmethod
    def _nchw(image):
        return image.permute(0, 3, 1, 2).contiguous()

    def _encode_body(self, image):
        return self.model.extract_features(self._nchw(image))

    def _predict_body(self, image, ref_feats, meas, geometry, state=None):
        return self._predict_core(self._nchw(image), ref_feats, meas, *self._geometry(geometry),
                                  state)

    def _encode_predict_body(self, image, meas, geometry, state=None):
        """The JAX engine's ``_encode_predict``: features and depth in one
        step; returns (depth (1, H, W), half-resolution features)."""
        image = self._nchw(image)
        ref_feats = self.model.extract_features(image)
        return (self._predict_core(image, ref_feats, meas, *self._geometry(geometry), state),
                ref_feats[0])

    def _pair_batch_body(self, ref_images, ref_feats, meas_half, ref_poses, meas_poses, K,
                         view_mask):
        return self.model.predict_depth(ref_images, ref_feats, meas_half, ref_poses, meas_poses,
                                        K, view_mask)[0]

    def _fusion_batch_body(self, ref_images, ref_feats, meas_half, ref_poses, meas_poses, K,
                           view_mask, keep, state):
        depth, new = self._fusion_core(ref_images, ref_feats, meas_half, ref_poses, meas_poses,
                                       K, view_mask, state, keep)
        self._write_state(state, new)
        return depth

    def _pair_steps_body(self, bank, images, K, xs):
        """The JAX engine's ``_predict_pair_scan``: T batches -> (T, B, H, W)."""
        out = []
        for t in range(xs["ref_idx"].shape[0]):
            ref_images, ref_feats, meas_half = self.gather_step_inputs(
                bank, images, xs["ref_idx"][t], xs["meas_idx"][t])
            out.append(self._pair_batch_body(ref_images, ref_feats, meas_half,
                                             xs["ref_pose"][t], xs["meas_pose"][t], K,
                                             xs["view_mask"][t]))
        return torch.stack(out)

    def _fusion_steps_body(self, bank, images, K, xs, state):
        """The JAX engine's ``_fusion_scan``: T lockstep steps, the state
        threaded through and written back at the end -> (T, B, H, W)."""
        out, new = [], state
        for t in range(xs["ref_idx"].shape[0]):
            ref_images, ref_feats, meas_half = self.gather_step_inputs(
                bank, images, xs["ref_idx"][t], xs["meas_idx"][t])
            depth, new = self._fusion_core(ref_images, ref_feats, meas_half, xs["ref_pose"][t],
                                           xs["meas_pose"][t], K, xs["view_mask"][t], new,
                                           xs["keep"][t])
            out.append(depth)
        self._write_state(state, new)
        return torch.stack(out)

    # ------------------------------------------------------------ online API
    @torch.inference_mode()
    def reset(self):
        """Reset recurrent state (tracking lost / new scene), in place."""
        for t in (self.carry.h, self.carry.c, self.prev_depth, self.has_prev):
            t.zero_()
        self.prev_pose.copy_(self._eye)

    def _state(self):
        return (self.carry, self.prev_pose, self.prev_depth, self.has_prev)

    def _online_inputs(self, ref_image, meas_half, ref_pose, meas_poses, K) -> dict:
        """The online step's inputs: the frame (1, H, W, 3), the measurement
        views padded to V with copies of view 0, and the packed poses, K and
        view mask."""
        V, n = self.V, len(meas_half)
        if not 1 <= n <= V:
            raise ValueError(f"need 1..{V} measurement frames, got {n}")
        with span("dvmvs.engine.inputs"):
            mask = np.zeros((V,), np.float32)
            mask[:n] = 1.0
            mposes = np.stack(list(meas_poses) + [meas_poses[0]] * (V - n))
            geometry = np.concatenate([np.ravel(ref_pose), np.ravel(mposes), np.ravel(K), mask])
            return {"image": np.asarray(ref_image, np.float32)[None],
                    "meas": list(meas_half) + [meas_half[0]] * (V - n),
                    "geometry": geometry.astype(np.float32)}

    @torch.inference_mode()
    def encode(self, image: np.ndarray):
        """image (H, W, 3) preprocessed float32 -> feature tuple on the
        device, each (1, C, h, w): (half, quarter, one_eight, one_sixteen)."""
        feats = self._run("encode", self._encode_body,
                          {"image": np.asarray(image, np.float32)[None]}, cost_volumes=False)
        return tuple(self._copy_out(f) for f in feats)

    @torch.inference_mode()
    def predict(self, ref_image: np.ndarray, ref_feats, meas_half: Sequence[torch.Tensor],
                ref_pose: np.ndarray, meas_poses: Sequence[np.ndarray],
                K: np.ndarray) -> np.ndarray:
        """One depth prediction from cached features. meas_half: list of
        1..V (1, C, H/2, W/2) measurement features; returns depth (H, W)."""
        return self._readback(self._predict(ref_image, ref_feats, meas_half, ref_pose,
                                            meas_poses, K))

    def _predict(self, ref_image, ref_feats, meas_half, ref_pose, meas_poses, K):
        """``predict`` without the readback: the depth (1, H, W) on the
        device, queued without a host sync."""
        inputs = self._online_inputs(ref_image, meas_half, ref_pose, meas_poses, K)
        inputs["ref_feats"] = tuple(ref_feats)
        return self._run("predict", self._predict_body, inputs,
                         state=self._state() if self.kind == "fusionnet" else None)

    @torch.inference_mode()
    def encode_and_predict(self, ref_image: np.ndarray, meas_half: Sequence[torch.Tensor],
                           ref_pose: np.ndarray, meas_poses: Sequence[np.ndarray],
                           K: np.ndarray):
        """The online loop's step: encode the reference frame and predict.
        Returns (depth (H, W) numpy, the frame's half-res features (1, C,
        H/2, W/2) on the device, for the keyframe cache)."""
        depth, half = self._encode_predict(ref_image, meas_half, ref_pose, meas_poses, K)
        return self._readback(depth), half

    def _encode_predict(self, ref_image, meas_half, ref_pose, meas_poses, K):
        """``encode_and_predict`` without the readback: (depth (1, H, W),
        the kept copy of the half-res features), queued without a host
        sync."""
        depth, half = self._run(
            "encode_and_predict", self._encode_predict_body,
            self._online_inputs(ref_image, meas_half, ref_pose, meas_poses, K),
            state=self._state() if self.kind == "fusionnet" else None)
        return depth, self._copy_out(half)

    # ------------------------------------------------------------ bulk steps
    @torch.inference_mode()
    def encode_batch(self, images) -> Tuple[torch.Tensor, ...]:
        """(B, H, W, 3) preprocessed float32 frames (host array) or (B, 3,
        H, W) device tensor -> feature tuple, each (B, C, h, w). The JAX
        engine's ``_extract_scan`` counterpart for ``run_testing``'s bank."""
        if isinstance(images, np.ndarray):
            images = self.images(images)
        feats = self._run("encode_batch", self.model.extract_features, {"images": images},
                          cost_volumes=False)
        return tuple(self._copy_out(f) for f in feats)

    def bank_storage(self, n: int, dtype, feats, images):
        """Engine-owned device storage for a feature bank of at least ``n``
        frames in ``dtype`` and the frames themselves, shaped like one
        batch's ``feats`` (tuple of (B, C, h, w)) and ``images`` (B, 3, H,
        W): (tuple of (N, C, h, w), (N, 3, H, W)) with N >= n, a multiple of
        BANK_ROWS. The next bank reuses it when it fits and has the same
        dtype, so the graphs of ``predict_pair_steps`` / ``fusion_steps``,
        which read the bank where it lies, replay for every scene instead of
        being captured again for each new bank. The engine holds one such
        storage (the last one made) between calls."""
        store = self._bank
        if store is None or store[1].shape[0] < n or store[0][0].dtype != dtype:
            rows = -(-n // BANK_ROWS) * BANK_ROWS
            self._bank = store = None  # free the old storage before the new one
            with span("dvmvs.engine.bank_alloc"):
                store = self._bank = (
                    tuple(torch.zeros((rows,) + tuple(f.shape[1:]), dtype=dtype,
                                      device=self.device) for f in feats),
                    torch.zeros((rows,) + tuple(images.shape[1:]), dtype=images.dtype,
                                device=self.device))
            counters.add("bank.allocations")
        return store

    @torch.inference_mode()
    def predict_batch(self, ref_images, ref_feats, meas_half, ref_poses, meas_poses, K,
                      view_mask) -> torch.Tensor:
        """B independent pairnet keyframes in one step, device tensors:
        ref_images (B, 3, H, W); ref_feats tuple of (B, C, h, w); meas_half
        (B, V, C, H/2, W/2); ref_poses (B, 4, 4); meas_poses (B, V, 4, 4);
        K (B, 3, 3); view_mask (B, V). Returns depth (B, H, W) on the device."""
        if self.kind != "pairnet":
            raise ValueError("predict_batch is the stateless (pairnet) step")
        depth = self._run("predict_batch", self._pair_batch_body, {
            "ref_images": ref_images, "ref_feats": tuple(ref_feats), "meas_half": meas_half,
            "ref_poses": ref_poses, "meas_poses": meas_poses, "K": K, "view_mask": view_mask})
        return self._copy_out(depth)

    def init_batch_state(self, batch: int):
        """Zero recurrent state of ``batch`` independent scenes: (carry,
        prev_pose (B, 4, 4), prev_depth (B, H, W), has_prev (B,))."""
        return (init_lstm_carry(batch, self.H, self.W, device=self.device),
                torch.eye(4, device=self.device).repeat(batch, 1, 1),
                torch.zeros((batch, self.H, self.W), device=self.device),
                torch.zeros((batch,), device=self.device))

    def _own_state(self, state):
        """The state a batched step writes: the caller's on the eager path;
        on the graph path the engine's buffers for this batch size, the
        caller's state copied in unless it is those buffers."""
        if not self._graphed():
            return state
        B = state[0].h.shape[0]
        own = self._batch_states.get(B)
        if own is None:
            own = self._batch_states[B] = self.init_batch_state(B)
        if any(a.data_ptr() != b.data_ptr() for a, b in zip(leaves(own), leaves(state))):
            self._write_state(own, state)
        return own

    @torch.inference_mode()
    def fusion_step_batch(self, ref_images, ref_feats, meas_half, ref_poses, meas_poses, K,
                          view_mask, state, keep):
        """One lockstep fusionnet step over B independent scenes (arguments
        as ``predict_batch``). ``keep`` (B,) float: 0 zeroes that scene's
        carry, previous depth and ``has_prev`` before the step (tracking
        lost or a new scene), as ``reset`` does for one. Returns (depth (B,
        H, W), new state), both on the device. The state is written in
        place; on the graph path the returned state is the engine's buffers
        for B, which the next call updates: pass it back, or copy it."""
        if self.kind != "fusionnet":
            raise ValueError("fusion_step_batch is the recurrent (fusionnet) step")
        own = self._own_state(state)
        depth = self._run("fusion_step_batch", self._fusion_batch_body, {
            "ref_images": ref_images, "ref_feats": tuple(ref_feats), "meas_half": meas_half,
            "ref_poses": ref_poses, "meas_poses": meas_poses, "K": K, "view_mask": view_mask,
            "keep": keep}, state=own)
        return self._copy_out(depth), own

    @contextlib.contextmanager
    def recording_cost_volumes(self, graphed: bool = False):
        """Within the block, the yielded list gets every cost volume the
        model computes, one (B, P, h, w) float32 host array a call. Checks
        of the bulk paths read it: with seeded random weights a wrong
        feature row moves the depth by about 1e-6 m but the cost volume by
        a tenth of its range. Each call copies to the host, so the run
        syncs once a step.

        By default the steps in the block run eagerly (the body on fresh
        tensors, the model's ``cost_volume`` hooked). ``graphed=True`` keeps
        the graph path: the steps are captured apart with their cost
        volumes as outputs, read after each replay, so a fault of the graph
        path itself shows."""
        calls = []
        self._recording, self._record_graphed = calls, graphed
        hooked = not self._graphed()  # an engine without graphs records eagerly
        real = self.model.cost_volume

        def cost_volume(*args, **kwargs):
            out = real(*args, **kwargs)
            calls.append(out.float().cpu().numpy())
            return out

        if hooked:
            self.model.cost_volume = cost_volume
        try:
            yield calls
        finally:
            if hooked:
                del self.model.cost_volume
            self._recording, self._record_graphed = None, False

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
        """T pairnet batches from the device-resident images and bank, one
        graph replay on the graph path. ``xs``: device tensors ref_idx (T,
        B), meas_idx (T, B, V), ref_pose (T, B, 4, 4), meas_pose (T, B, V,
        4, 4), view_mask (T, B, V); K (B, 3, 3). The bank and images are
        read in place: they must stay alive and unchanged while the call
        runs. Returns depth (T, B, H, W) on the device."""
        if self.kind != "pairnet":
            raise ValueError("predict_pair_steps is the stateless (pairnet) step")
        depth = self._run("predict_pair_steps", self._pair_steps_body, {"K": K, "xs": dict(xs)},
                          fixed={"bank": tuple(bank), "images": images})
        return self._copy_out(depth)

    @torch.inference_mode()
    def fusion_steps(self, bank, images, K, state, xs: Dict[str, torch.Tensor]):
        """T lockstep fusionnet steps from the device-resident images and
        bank, one graph replay on the graph path; ``xs`` as in
        ``predict_pair_steps`` plus keep (T, B). The state threads through
        (as in ``fusion_step_batch``), so a scene can be split into chunks.
        Returns (new state, depth (T, B, H, W) on the device)."""
        if self.kind != "fusionnet":
            raise ValueError("fusion_steps is the recurrent (fusionnet) step")
        own = self._own_state(state)
        depth = self._run("fusion_steps", self._fusion_steps_body, {"K": K, "xs": dict(xs)},
                          fixed={"bank": tuple(bank), "images": images}, state=own)
        return own, self._copy_out(depth)
