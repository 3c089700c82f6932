"""Inputs, bounds and timers for measuring the port's kernels on a GPU.

Shared by ``apps/bench_plane_sweep.py``, ``chip_smoke.py`` and the tests:
seeded sweep inputs at a given shape (``sweep_case``), the least time the
card could take for a call (``sweep_bound``), the share of the backward
kernel's chunk steps whose d_meas it bins (``binned_share``), seeded
triangulation inputs and the DLT solve's bound (``dlt_case``,
``dlt_bound``), and two CUDA-event timers:
``time_ms`` (calls queued behind a spin kernel, so a kernel's time excludes
the host's launch overhead) and ``single_launch_ms`` (each call timed alone
as the host issues it, which includes that overhead where it is longer than
the kernel).
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from dvmvs_tpu_torch.ops.cost_volume import inverse_depth_planes
from dvmvs_tpu_torch.ops.plane_sweep import build_plane_matrices

TYPICAL = ((2, 3, 1), (0.12, 0.03, 0.02))  # euler (degrees) and translation of view 0
OTHER_VIEW = ((1, 2, 0.5), (0.1, 0.02, 0.0))
# NVIDIA H100 SXM5 data sheet, dense: HBM3 bytes/s, float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 34e12  # the same data sheet: float64 outside the tensor cores
# float64 flops of the least DLT solve (dlt_bound), whatever implements it:
# folding a non-zero row into a 4x4 upper triangle (per column k, 6 for the
# pivot's length and two quotients, and 6 for each column from k on);
# checking the triangle's six column pairs once and finding them orthogonal
# (three 4-long dot products and the test each); the norms and ranks
DLT_ROW_FLOPS, DLT_CHECK_FLOPS, DLT_TAIL_FLOPS = 84, 6 * 28, 80
# flops per channel of one in-range (pixel, plane, view) sample: forward, 4
# FMA to interpolate and 1 for the dot; backward, 4 FMA into d_ref, 4
# multiplies and 4 atomic adds into d_meas
FWD_FLOPS, BWD_FLOPS = 10, 16
# csrc/plane_sweep_bwd.cu's tile (x, y), plane chunk and bin budget
BWD_TILE, BWD_CHUNK, BWD_MAX_BINS = (32, 2), 8, 1024
SPIN_CLOCK_HZ = 1.98e9  # H100 SXM5 boost clock: cycles of time_ms's spin kernel per second
TIMER = "median of 30 CUDA-event timings of 10 calls queued behind a spin kernel, per call"
SINGLE_LAUNCH_TIMER = "median of 30 CUDA-event timings of one call each, as the host issues it"


def pose(rx, ry, rz, t):
    """Camera-to-world pose from xyz Euler angles in degrees."""
    ax, ay, az = np.radians([rx, ry, rz])
    Rx = np.array([[1, 0, 0], [0, np.cos(ax), -np.sin(ax)], [0, np.sin(ax), np.cos(ax)]])
    Ry = np.array([[np.cos(ay), 0, np.sin(ay)], [0, 1, 0], [-np.sin(ay), 0, np.cos(ay)]])
    Rz = np.array([[np.cos(az), -np.sin(az), 0], [np.sin(az), np.cos(az), 0], [0, 0, 1]])
    out = np.eye(4)
    out[:3, :3] = Rz @ Ry @ Rx  # extrinsic xyz, as scipy's from_euler("xyz")
    out[:3, 3] = t
    return out.astype(np.float32)


def sweep_case(shape, euler=TYPICAL[0], t=TYPICAL[1], weights=None, seed=0, device="cuda",
               focal=0.95, depths=(0.25, 20.0)):
    """Seeded inputs of the forward at ``shape`` = (B, V, C, H, W, P): view 0
    at (euler, t), view 1 at OTHER_VIEW, intrinsics ``focal * W``, P
    inverse-depth planes in ``depths`` (metres); every batch element alike.
    Returns ref, meas, mats, weights (default 1 / V each)."""
    B, V, C, H, W, P = shape
    rs = np.random.RandomState(seed)
    ref = torch.from_numpy(rs.randn(B, H, W, C).astype(np.float32)).to(device)
    meas = torch.from_numpy(rs.randn(B, V, H, W, C).astype(np.float32)).to(device)
    K = torch.tensor([[focal * W, 0, W / 2], [0, focal * W, H / 2], [0, 0, 1]], device=device)
    poses = np.stack([pose(*euler, t), pose(*OTHER_VIEW[0], OTHER_VIEW[1])][:V])
    mats = build_plane_matrices(torch.eye(4, device=device), torch.from_numpy(poses).to(device),
                                K, inverse_depth_planes(*depths, P, device))
    w = torch.full((B, V), 1.0 / V) if weights is None else torch.tensor([weights] * B)
    return (ref, meas, mats[None].expand(B, -1, -1, -1, -1).contiguous(),
            w.to(device=device, dtype=torch.float32))


def in_range_samples(mats, weights, H: int, W: int) -> int:
    """(b, v, p, y, x) samples of views with a non-zero weight whose bilinear
    footprint touches the image: the samples the kernels do work for."""
    total = 0
    for p in range(mats.shape[2]):
        xs, ys = _source_coords(mats[:, :, p], H, W)  # (B, V, H, W)
        inside = (xs > -1) & (xs < W) & (ys > -1) & (ys < H) & (weights != 0)[:, :, None, None]
        total += int(inside.sum().item())
    return total


def _source_coords(m, H: int, W: int):
    """The kernels' source coordinates (xs, ys) of every pixel under matrices
    m (..., 3, 3): (..., H, W) each."""
    x = torch.arange(W, dtype=torch.float32, device=m.device)[None, :]
    y = torch.arange(H, dtype=torch.float32, device=m.device)[:, None]
    m = m[..., None, None]
    den = m[..., 2, 0, :, :] * x + m[..., 2, 1, :, :] * y + m[..., 2, 2, :, :] + 1e-8
    xs = (m[..., 0, 0, :, :] * x + m[..., 0, 1, :, :] * y + m[..., 0, 2, :, :]) / den
    ys = (m[..., 1, 0, :, :] * x + m[..., 1, 1, :, :] * y + m[..., 1, 2, :, :]) / den
    return xs * ((W - 1) / W), ys * ((H - 1) / H)


def binned_share(mats, weights, H: int, W: int) -> tuple[int, int]:
    """(steps binned, steps) of the backward kernel's d_meas route: a step
    is one (b, v, tile, chunk of BWD_CHUNK planes) with a non-zero view
    weight and an in-range sample; its samples are binned and gathered by
    source pixel when the box of their top-left taps has at most
    BWD_MAX_BINS pixels, else scattered straight to d_meas
    (csrc/plane_sweep_bwd.cu, at C <= 64)."""
    B, V, P = mats.shape[:3]
    (tx, ty), big = BWD_TILE, 1 << 30
    Hp, Wp = -(-H // ty) * ty, -(-W // tx) * tx
    binned = total = 0
    for p0 in range(0, P, BWD_CHUNK):
        xs, ys = _source_coords(mats[:, :, p0:p0 + BWD_CHUNK], H, W)  # (B, V, n, H, W)
        inside = (xs > -1) & (xs < W) & (ys > -1) & (ys < H) & (weights != 0)[:, :, None, None,
                                                                               None]
        x0, y0 = torch.floor(xs).clamp(-2, W).long(), torch.floor(ys).clamp(-2, H).long()
        box = []
        for t, fill, reduce in ((x0, big, torch.amin), (x0, -big, torch.amax),
                                (y0, big, torch.amin), (y0, -big, torch.amax)):
            t = F.pad(torch.where(inside, t, fill), (0, Wp - W, 0, Hp - H), value=fill)
            t = t.reshape(B, V, t.shape[2], Hp // ty, ty, Wp // tx, tx)
            box.append(reduce(t, dim=(2, 4, 6)))  # (B, V, tiles_y, tiles_x)
        lo_x, hi_x, lo_y, hi_y = box
        some = lo_x <= hi_x
        bins = (hi_x - lo_x + 1) * (hi_y - lo_y + 1)
        binned += int((some & (bins <= BWD_MAX_BINS)).sum().item())
        total += int(some.sum().item())
    return binned, total


def _bound(n_bytes: int, flops: int) -> dict:
    byte_ms, op_ms = n_bytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return {"bound_ms": max(byte_ms, op_ms), "bound_by": "bytes" if byte_ms >= op_ms else
            "operations", "bytes": n_bytes, "flops": flops}


def sweep_bound(ref, meas, mats, weights, backward: bool = False) -> dict:
    """The least time of one forward (or backward) call on these inputs:
    every input read once and every output written once over the HBM rate,
    and the flops of the in-range samples over the float32 rate; views of
    weight 0 are neither read nor computed."""
    B, H, W, C = ref.shape
    V, P = mats.shape[1:3]
    views = int((weights != 0).sum().item())
    pixels = B * H * W
    n_bytes = 4 * (pixels * C + views * H * W * C + mats.numel() + weights.numel() + B * P * H * W)
    if backward:  # the cotangent was counted as the output; add d_ref and d_meas
        n_bytes += 4 * (pixels * C + views * H * W * C)
    samples = in_range_samples(mats, weights, H, W)
    return _bound(n_bytes, samples * C * (BWD_FLOPS if backward else FWD_FLOPS))


def time_ms(fn, n_warmup=5, n=30, reps=10):
    """Median over ``n`` CUDA-event timings of ``reps`` back-to-back calls,
    per call. A spin kernel queued before the start event holds the card
    while the host queues the calls (for twice the host's time of the last
    warm-up call), so a kernel's time excludes the host's launch overhead,
    even where that overhead is longer than the kernel."""
    for _ in range(n_warmup):
        t0 = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t0
    spin_cycles = int(SPIN_CLOCK_HZ * min(2 * reps * host_s + 1e-3, 0.1))
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def dlt_case(seed: int = 0, B: int = 4, Kn: int = 512, V: int = 3, depths=(0.5, 10.0),
             noise: float = 0.25, baseline: float = 0.1):
    """Seeded inputs of ``baselines/deltas.py::triangulate_dlt`` at DELTAS's
    320x240 (K with a 240 px focal length), NumPy float32: proj (B, V, 3, 4),
    view 0 the reference camera K[I|0] and the others turned by about 3
    degrees and moved by about ``baseline`` m; points (B, Kn, V, 2), the
    reference's keypoints uniform over the image and their projections at
    log-uniform ``depths`` (m) with ``noise`` px of Gaussian noise in the
    other views; confidences (B, Kn, V), 1 for the reference and 0.3-1
    otherwise. By batch element, b % 4: 0 as above; 1 the last view masked
    (confidence 0: zero rows, as a masked measurement frame); 2 the last view
    masked and view 1 at 0.001 (a null epipolar segment's confidence: the
    system is near rank-deficient); 3 noise-free (an exactly consistent
    system, its smallest singular value about 0). Views are masked only
    where V >= 3, so that the reference and one view remain, as in DELTAS."""
    rs = np.random.RandomState(seed)
    W, H, f = 320, 240, 240.0
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])
    proj = np.zeros((B, V, 3, 4))
    points = np.zeros((B, Kn, V, 2))
    conf = np.ones((B, Kn, V))
    for b in range(B):
        cams = [np.eye(3, 4)]
        for _ in range(V - 1):
            R = pose(*rs.randn(3) * 3.0, (0, 0, 0))[:3, :3]
            cams.append(np.c_[R, rs.randn(3) * baseline])
        proj[b] = np.stack([K @ c for c in cams])
        uv = np.c_[rs.uniform(0, W, Kn), rs.uniform(0, H, Kn)]
        z = np.exp(rs.uniform(np.log(depths[0]), np.log(depths[1]), Kn))
        X = np.c_[(uv - K[:2, 2]) / f * z[:, None], z, np.ones(Kn)]
        points[b, :, 0] = uv
        for v in range(1, V):
            x = X @ proj[b, v].T
            points[b, :, v] = x[:, :2] / x[:, 2:3] + rs.randn(Kn, 2) * noise * (b % 4 != 3)
            conf[b, :, v] = rs.uniform(0.3, 1.0, Kn)
        if b % 4 in (1, 2) and V >= 3:
            conf[b, :, V - 1] = 0.0
        if b % 4 == 2 and V >= 3:
            conf[b, :, 1] = 0.001
    return proj.astype(np.float32), points.astype(np.float32), conf.astype(np.float32)


def dlt_bound(A) -> dict:
    """The least time of one DLT-solve call on the systems A (..., R, 4):
    A read once and Vh written once over the HBM rate, and the float64
    flops that any solve of these systems needs, whatever its sweeps, over
    the float64 rate: reducing their non-zero rows to a 4x4 triangle, one
    pass over the triangle's six column pairs that finds them orthogonal,
    and the column norms and ordering."""
    n = A.numel() // (A.shape[-2] * 4)
    rows = int((A != 0).any(dim=-1).sum().item())
    flops = rows * DLT_ROW_FLOPS + n * (DLT_CHECK_FLOPS + DLT_TAIL_FLOPS)
    n_bytes = 4 * (A.numel() + n * 16)
    byte_ms, op_ms = n_bytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F64_FLOPS * 1e3
    return {"bound_ms": max(byte_ms, op_ms), "bound_by": "bytes" if byte_ms >= op_ms else
            "operations", "bytes": n_bytes, "flops": flops}


def single_launch_ms(fn, n_warmup=5, n=30):
    """Median over ``n`` CUDA-event timings of one call each, recorded as the
    host issues it: where the host's launch takes longer than the kernel,
    this is the host's time."""
    for _ in range(n_warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))
