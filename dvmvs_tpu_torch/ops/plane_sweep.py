"""Fused plane sweep: the CUDA kernels, their wrappers, their plain PyTorch
versions and the autograd Function over them (counterpart of
dvmvs_tpu/ops/pallas/cost_volume_kernel.py and cost_volume_vjp.py).

``plane_sweep_multiview`` takes the Pallas functions' own arguments with a
leading batch dimension: ref (B, H, W, C), meas (B, V, H, W, C), per-plane
warp matrices (B, V, P, 3, 3) and view weights (B, V), and returns the
(B, P, H, W) cost ``sum_v w_v * reduce_c(ref, bilinear(meas_v, M_{v,p}))``.
A CPU tensor goes to ``plane_sweep_multiview_plain`` (gather based,
``F.grid_sample`` per plane chunk); a CUDA tensor launches
``csrc/plane_sweep.cu`` on the current stream. That one kernel replaces the
TPU kernels K1 (``pallas_plane_sweep_multiview``) and K2
(``pallas_plane_sweep_multiview_dyn``), and with V=1 and weight 1 also the
single-view training forwards K3 (``pallas_plane_sweep``) and K4
(``pallas_plane_sweep_dyn``); it needs no band ladder.

The wrapper is differentiable in dot mode: when grad mode is on and ref or
meas requires a gradient, it goes through ``PlaneSweepFunction``, whose
backward is ``csrc/plane_sweep_bwd.cu`` on the card (replacing K5
``_plane_sweep_bwd_padded`` and K6 ``_plane_sweep_dyn_bwd_padded``) and
autograd through the plain version on the CPU. The matrices and the view
weights get no gradient, as in the JAX custom VJP. L1 mode has no backward
kernel and raises when a gradient is asked for. ``plane_sweep_train`` is the
single-view training entry.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from dvmvs_tpu_torch.ops import cuda_build
from dvmvs_tpu_torch.ops.geometry import inverse_pose, matmul_f32
from dvmvs_tpu_torch.utils.profiling import counters

KERNELS = ("plane_sweep", "plane_sweep_bwd")

# Launches of the CUDA kernels are counted (never the plain versions'), one
# a backward call and one a forward call of up to 51 views, under these
# names of ``utils/profiling.py::counters``
FORWARD_LAUNCHES = "plane_sweep.launches"
BACKWARD_LAUNCHES = "plane_sweep.backward_launches"


def build_plane_matrices(ref_pose, meas_pose, K, inv_depths):
    """Pixel-warp matrices M_p = K R K^-1 + inv_depth_p (K t) e3^T so that
    coords_p = M_p @ [x, y, 1]. Poses (..., 4, 4) camera-to-world, K
    (..., 3, 3), inv_depths (P,) -> (..., P, 3, 3)."""
    extrinsic = matmul_f32(inverse_pose(meas_pose), ref_pose)
    R = extrinsic[..., :3, :3]
    t = extrinsic[..., :3, 3:4]
    Kt = matmul_f32(K, t)  # (..., 3, 1)
    A = matmul_f32(matmul_f32(K, R), inverse_pose(K))
    Kt_e3 = torch.zeros_like(A)
    Kt_e3[..., :, 2:3] = Kt
    return A[..., None, :, :] + inv_depths[:, None, None] * Kt_e3[..., None, :, :]


def sweep_reduce(ref, meas, grids, dot_product: bool = True, plane_chunk: int = 8):
    """Gather-based sweep for one view: ref/meas (B, C, H, W), grids
    (B, P, H, W, 2) normalised sample positions -> (B, P, H, W)."""
    B, C, H, W = ref.shape
    P = grids.shape[1]
    costs = []
    for p0 in range(0, P, plane_chunk):
        g = grids[:, p0:p0 + plane_chunk]
        n = g.shape[1]
        warped = F.grid_sample(meas, g.reshape(B, n * H, W, 2), mode="bilinear",
                               padding_mode="zeros", align_corners=True)
        warped = warped.reshape(B, C, n, H, W)
        if dot_product:
            costs.append((ref[:, :, None] * warped).sum(dim=1) / C)
        else:
            costs.append((ref[:, :, None] - warped).abs().sum(dim=1))
    return torch.cat(costs, dim=1)


def plane_sweep_multiview_plain(ref, meas, mats, weights, dot_product: bool = True):
    """Plain PyTorch version of the forward kernel (same arguments and result).

    Coordinates come from the matrices as in the kernel; they are normalised
    with the reference's W/2, H/2 convention and sampled by ``F.grid_sample``
    (zeros padding, align_corners=True), one chunk of planes at a time.
    """
    B, H, W, C = ref.shape
    x = torch.arange(W, dtype=torch.float32, device=ref.device)[None, :]
    y = torch.arange(H, dtype=torch.float32, device=ref.device)[:, None]
    m = mats[..., None, None]  # (B, V, P, 3, 3, 1, 1)
    den = m[..., 2, 0, :, :] * x + m[..., 2, 1, :, :] * y + m[..., 2, 2, :, :] + 1e-8
    gx = (m[..., 0, 0, :, :] * x + m[..., 0, 1, :, :] * y + m[..., 0, 2, :, :]) / den
    gy = (m[..., 1, 0, :, :] * x + m[..., 1, 1, :, :] * y + m[..., 1, 2, :, :]) / den
    grids = torch.stack([gx / (W / 2.0) - 1.0, gy / (H / 2.0) - 1.0], dim=-1)

    ref_nchw = ref.permute(0, 3, 1, 2)
    total = torch.zeros((B, mats.shape[2], H, W), dtype=torch.float32, device=ref.device)
    for v in range(meas.shape[1]):
        cost = sweep_reduce(ref_nchw, meas[:, v].permute(0, 3, 1, 2), grids[:, v],
                            dot_product)
        total = total + weights[:, v, None, None, None] * cost
    return total


def plane_sweep_backward_plain(ref, meas, mats, weights, g):
    """Plain version of the backward kernel: (d_ref, d_meas) of the dot-mode
    sweep for the cotangent g (B, P, H, W), by autograd through
    ``plane_sweep_multiview_plain``."""
    with torch.enable_grad():
        r = ref.detach().requires_grad_()
        m = meas.detach().requires_grad_()
        out = plane_sweep_multiview_plain(r, m, mats.detach(), weights.detach(), True)
        d_ref, d_meas = torch.autograd.grad(out, (r, m), g)
    return d_ref, d_meas


def bind(lib: ctypes.CDLL, name: str):
    """The C entry point of kernel ``name`` in a loaded library, typed."""
    if name == "plane_sweep":
        fn = lib.plane_sweep_multiview
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    else:
        fn = lib.plane_sweep_backward
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    """A kernel's library, built and loaded once per process."""
    return cuda_build.load(name)


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    """A kernel's C entry point."""
    return bind(_library(name), name)


@functools.lru_cache(maxsize=None)
def _forward_launches(V: int) -> int:
    """Launches the forward entry point makes for V views (it takes as many
    views in one launch as a block's shared memory holds)."""
    fn = _library("plane_sweep").plane_sweep_launches
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(V)


def _check(ref, meas, mats, weights):
    tensors = {"ref": ref, "meas": meas, "mats": mats, "weights": weights}
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"plane sweep: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"plane sweep: {name} must be contiguous")
        if t.device != ref.device:
            raise ValueError(f"plane sweep: {name} is on {t.device}, ref on {ref.device}")
    if ref.dim() != 4 or meas.dim() != 5 or mats.dim() != 5 or weights.dim() != 2:
        raise ValueError("plane sweep: want ref (B,H,W,C), meas (B,V,H,W,C), "
                         "mats (B,V,P,3,3), weights (B,V)")
    B, H, W, C = ref.shape
    V, P = mats.shape[1:3]
    if (tuple(meas.shape) != (B, V, H, W, C) or tuple(mats.shape) != (B, V, P, 3, 3)
            or tuple(weights.shape) != (B, V)):
        raise ValueError(
            f"plane sweep: inconsistent shapes ref {tuple(ref.shape)}, meas "
            f"{tuple(meas.shape)}, mats {tuple(mats.shape)}, weights {tuple(weights.shape)}")
    if ref.device.type not in ("cpu", "cuda"):
        raise ValueError(f"plane sweep: unsupported device {ref.device}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch_forward(fn, ref, meas, mats, weights, dot_product: bool = True):
    """Launch a forward entry point (``bind``) on checked CUDA tensors on
    the current stream; returns the (B, P, H, W) result."""
    B, H, W, C = ref.shape
    V, P = mats.shape[1:3]
    out = torch.empty((B, P, H, W), dtype=torch.float32, device=ref.device)
    with torch.cuda.device(ref.device):
        err = fn(ref.data_ptr(), meas.data_ptr(), mats.data_ptr(), weights.data_ptr(),
                 out.data_ptr(), B, V, P, H, W, C, int(bool(dot_product)), _stream(ref.device))
    if err != 0:
        raise RuntimeError(f"plane sweep kernel launch failed: cudaError {err}")
    return out


def _sweep(ref, meas, mats, weights, dot_product: bool):
    """The forward: plain version on the CPU, the kernel on the card."""
    _check(ref, meas, mats, weights)
    if ref.device.type == "cpu":
        return plane_sweep_multiview_plain(ref, meas, mats, weights, dot_product)
    out = launch_forward(_entry("plane_sweep"), ref, meas, mats, weights, dot_product)
    counters.add(FORWARD_LAUNCHES, _forward_launches(mats.shape[1]))
    return out


def plane_sweep_backward(ref, meas, mats, weights, g):
    """(d_ref, d_meas) of the dot-mode sweep for the cotangent g (B, P, H, W):
    plain version on the CPU, ``csrc/plane_sweep_bwd.cu`` on the card."""
    _check(ref, meas, mats, weights)
    B, H, W, C = ref.shape
    V, P = mats.shape[1:3]
    if g.dtype != torch.float32 or not g.is_contiguous() or g.device != ref.device \
            or tuple(g.shape) != (B, P, H, W):
        raise ValueError(f"plane sweep backward: want a contiguous float32 cotangent "
                         f"{(B, P, H, W)} on {ref.device}, got {g.dtype} "
                         f"{tuple(g.shape)} on {g.device}")
    if ref.device.type == "cpu":
        return plane_sweep_backward_plain(ref, meas, mats, weights, g)
    out = launch_backward(_entry("plane_sweep_bwd"), ref, meas, mats, weights, g)
    counters.add(BACKWARD_LAUNCHES)
    return out


def launch_backward(fn, ref, meas, mats, weights, g):
    """Launch a backward entry point (``bind``) on checked CUDA tensors on
    the current stream (one launch for any V); returns (d_ref, d_meas)."""
    B, H, W, C = ref.shape
    V, P = mats.shape[1:3]
    d_ref = torch.empty_like(ref)
    d_meas = torch.zeros_like(meas)
    with torch.cuda.device(ref.device):
        err = fn(ref.data_ptr(), meas.data_ptr(), mats.data_ptr(), weights.data_ptr(),
                 g.data_ptr(), d_ref.data_ptr(), d_meas.data_ptr(), B, V, P, H, W, C,
                 _stream(ref.device))
    if err != 0:
        raise RuntimeError(f"plane sweep backward kernel launch failed: cudaError {err}")
    return d_ref, d_meas


class PlaneSweepFunction(torch.autograd.Function):
    """Dot-mode sweep (ref, meas, mats, weights) -> (B, P, H, W) with the
    backward kernel as its VJP; the matrices and weights get no gradient."""

    @staticmethod
    def forward(ctx, ref, meas, mats, weights):
        ctx.save_for_backward(ref, meas, mats, weights)
        return _sweep(ref, meas, mats, weights, True)

    @staticmethod
    def backward(ctx, g):
        ref, meas, mats, weights = ctx.saved_tensors
        d_ref, d_meas = plane_sweep_backward(ref, meas, mats, weights, g.contiguous())
        need_ref, need_meas = ctx.needs_input_grad[:2]
        return d_ref if need_ref else None, d_meas if need_meas else None, None, None


def plane_sweep_multiview(ref, meas, mats, weights, dot_product: bool = True):
    """Fused multi-view plane sweep -> (B, P, H, W) float32.

    ref (B, H, W, C), meas (B, V, H, W, C), mats (B, V, P, 3, 3), weights
    (B, V), all contiguous float32 on one device. CPU tensors take the plain
    version; CUDA tensors launch the kernel (and raise if it cannot run).
    With grad mode on and ref or meas requiring a gradient, the result
    carries ``PlaneSweepFunction``'s backward on either device; L1 mode then
    raises ``NotImplementedError``.
    """
    if torch.is_grad_enabled() and (ref.requires_grad or meas.requires_grad):
        if not dot_product:
            raise NotImplementedError(
                "plane sweep: L1 mode has no backward kernel (csrc/plane_sweep_bwd.cu "
                "covers the dot product only); call it under torch.no_grad()")
        return PlaneSweepFunction.apply(ref, meas, mats, weights)
    return _sweep(ref, meas, mats, weights, dot_product)


def plane_sweep_train(ref, meas, mats):
    """Single-view training sweep (K3/K4 forward, K5/K6 backward): ref and
    meas (B, H, W, C), mats (B, P, 3, 3), contiguous float32 -> (B, P, H, W)
    dot-product cost, differentiable in ref and meas."""
    weights = torch.ones((ref.shape[0], 1), dtype=torch.float32, device=ref.device)
    return PlaneSweepFunction.apply(ref, meas[:, None], mats[:, None], weights)
