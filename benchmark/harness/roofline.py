"""The chip's peaks and the least time of a plane-sweep call (copies of the
port's ``ops/sweep_measure.py``: ``in_range_samples``, ``sweep_bound``).

A call's bound is the larger of its bytes (every input read once, every
output written once) over the HBM rate and its flops (10 a channel of each
in-range sample forward, 16 backward) over the float32 rate. A sample is
in range where its bilinear footprint touches the measurement image and
its view has a non-zero weight: the work these inputs need, not the most
they could.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

# NVIDIA H100 SXM5 data sheet, dense rates at 700 W
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
FWD_FLOPS, BWD_FLOPS = 10, 16
# kernel names of the port's csrc/plane_sweep.cu and csrc/plane_sweep_bwd.cu
FORWARD_KERNELS = ("plane_sweep_kernel", "plane_sweep_small_kernel")
BACKWARD_KERNELS = ("plane_sweep_bwd_kernel",)


def source_coords(m, H: int, W: int):
    """The kernels' source coordinates (xs, ys) of every pixel under
    matrices m (..., 3, 3): (..., H, W) each."""
    x = torch.arange(W, dtype=torch.float32, device=m.device)[None, :]
    y = torch.arange(H, dtype=torch.float32, device=m.device)[:, None]
    m = m[..., None, None]
    den = m[..., 2, 0, :, :] * x + m[..., 2, 1, :, :] * y + m[..., 2, 2, :, :] + 1e-8
    xs = (m[..., 0, 0, :, :] * x + m[..., 0, 1, :, :] * y + m[..., 0, 2, :, :]) / den
    ys = (m[..., 1, 0, :, :] * x + m[..., 1, 1, :, :] * y + m[..., 1, 2, :, :]) / den
    return xs * ((W - 1) / W), ys * ((H - 1) / H)


def in_range_samples(mats, weights, H: int, W: int) -> torch.Tensor:
    """Per batch element (B,) the (v, p, y, x) samples of views with a
    non-zero weight whose bilinear footprint touches the image; mats (B, V,
    P, 3, 3), weights (B, V)."""
    total = torch.zeros(mats.shape[0], dtype=torch.int64, device=mats.device)
    for p in range(mats.shape[2]):
        xs, ys = source_coords(mats[:, :, p], H, W)
        inside = (xs > -1) & (xs < W) & (ys > -1) & (ys < H) & (weights != 0)[:, :, None, None]
        total += inside.sum(dim=(1, 2, 3))
    return total


def sweep_bound_s(mats, weights, H: int, W: int, C: int, batch: int,
                  backward: bool = False) -> float:
    """The summed least time (s) of calls of ``batch`` elements each, their
    elements stacked: mats (N * batch, V, P, 3, 3), weights (N * batch, V)."""
    V, P = mats.shape[1:3]
    samples = in_range_samples(mats, weights, H, W).reshape(-1, batch).sum(1).double()
    views = (weights != 0).reshape(-1, batch * V).sum(1).double()
    pixels = batch * H * W
    n_bytes = 4 * (pixels * C + views * H * W * C + batch * V * P * 9 + batch * V
                   + batch * P * H * W)
    if backward:  # the cotangent counted as the output; d_ref and d_meas written
        n_bytes = n_bytes + 4 * (pixels * C + views * H * W * C)
    flops = samples * C * (BWD_FLOPS if backward else FWD_FLOPS)
    return float(torch.maximum(n_bytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS).sum())


def roofline_share(run, kernel: str) -> float | None:
    """Percent of the summed bound of the traced window's ``kernel``
    ("forward" or "backward") calls in the device time of the kernels of
    that name; None where the run has no trace of such a kernel."""
    calls: List[tuple] = run.sweeps.get(kernel) or []
    if run.trace is None or not calls:
        return None
    device_s = run.trace.kernel_s(FORWARD_KERNELS if kernel == "forward" else BACKWARD_KERNELS)
    if device_s <= 0:
        return None
    bound = sum(sweep_bound_s(*call, backward=kernel == "backward") for call in calls)
    return 100.0 * bound / device_s


def stack_calls(calls: Sequence[tuple]) -> list:
    """Group (mats (b, V, P, 3, 3), weights (b, V), H, W, C) calls of one
    shape into stacked tuples for ``sweep_bound_s``."""
    groups = {}
    for mats, weights, H, W, C in calls:
        key = (tuple(mats.shape), H, W, C)
        groups.setdefault(key, []).append((mats, weights))
    return [(torch.cat([m for m, _ in g]), torch.cat([w for _, w in g]), key[1], key[2], key[3],
             key[0][0]) for key, g in groups.items()]
