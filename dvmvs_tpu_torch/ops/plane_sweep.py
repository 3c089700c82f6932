"""Fused multi-view plane sweep: the CUDA kernel, its wrapper and its plain
PyTorch version (counterpart of dvmvs_tpu/ops/pallas/cost_volume_kernel.py).

``plane_sweep_multiview`` takes the Pallas functions' own arguments with a
leading batch dimension: ref (B, H, W, C), meas (B, V, H, W, C), per-plane
warp matrices (B, V, P, 3, 3) and view weights (B, V), and returns the
(B, P, H, W) cost ``sum_v w_v * reduce_c(ref, bilinear(meas_v, M_{v,p}))``.
A CPU tensor goes to ``plane_sweep_multiview_plain`` (gather based,
``F.grid_sample`` per plane chunk); a CUDA tensor launches
``csrc/plane_sweep.cu`` on the current stream, which replaces both TPU
kernels K1 (``pallas_plane_sweep_multiview``) and K2
(``pallas_plane_sweep_multiview_dyn``) and needs no band ladder.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from dvmvs_tpu_torch.ops import cuda_build
from dvmvs_tpu_torch.ops.geometry import inverse_pose, matmul_f32

# Launches of the CUDA kernel in this process (never the plain version's).
launch_count = 0


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
    """Plain PyTorch version of the kernel (same arguments and result).

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


@functools.lru_cache(maxsize=None)
def _kernel_entry():
    """The kernel's C entry point, built and loaded once per process."""
    fn = cuda_build.load("plane_sweep").plane_sweep_multiview
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def build_kernel():
    """Compile (if needed) and load the CUDA kernel; returns nvcc's output."""
    _, log = cuda_build.build("plane_sweep")
    _kernel_entry()
    return log


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


def plane_sweep_multiview(ref, meas, mats, weights, dot_product: bool = True):
    """Fused multi-view plane sweep -> (B, P, H, W) float32.

    ref (B, H, W, C), meas (B, V, H, W, C), mats (B, V, P, 3, 3), weights
    (B, V), all contiguous float32 on one device. CPU tensors take the plain
    version; CUDA tensors launch the kernel (and raise if it cannot run).
    """
    global launch_count
    _check(ref, meas, mats, weights)
    if ref.device.type == "cpu":
        return plane_sweep_multiview_plain(ref, meas, mats, weights, dot_product)
    if ref.device.type != "cuda":
        raise ValueError(f"plane sweep: unsupported device {ref.device}")
    B, H, W, C = ref.shape
    V, P = mats.shape[1:3]
    out = torch.empty((B, P, H, W), dtype=torch.float32, device=ref.device)
    fn = _kernel_entry()
    with torch.cuda.device(ref.device):
        stream = torch.cuda.current_stream(ref.device).cuda_stream
        err = fn(ref.data_ptr(), meas.data_ptr(), mats.data_ptr(), weights.data_ptr(),
                 out.data_ptr(), B, V, P, H, W, C, int(bool(dot_product)), stream)
    if err != 0:
        raise RuntimeError(f"plane sweep kernel launch failed: cudaError {err}")
    launch_count += 1
    return out
