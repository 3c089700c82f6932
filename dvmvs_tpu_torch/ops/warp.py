"""Depth-based warping (counterpart of dvmvs_tpu/ops/warp.py).

  - ``warp_frame_depth``: backward warp of a source image or hidden state
    into the destination view using the destination depth.
  - ``splat_depth_max``: forward splat of the previous depth into the
    current view, keeping the largest z per landing pixel (a scatter-max
    over linearised pixel ids; misses land on a sentinel slot).
  - ``splat_depth_max_strided``: the same onto a strided sub-grid.
  - ``splat_depth_soft``: a differentiable forward splat (soft z-buffer):
    each point lands bilinearly on its 4 neighbour pixels and each pixel
    takes the exp(-z/tau)-weighted mean; gradients reach the depth and both
    poses through the scatter-adds.
"""

from __future__ import annotations

import torch

from dvmvs_tpu_torch.ops.geometry import (
    depth_to_3d,
    inverse_pose,
    matmul_f32,
    normalize_pixel_coordinates,
    project_points,
    transform_points,
)
from dvmvs_tpu_torch.ops.sampling import grid_sample


def warp_frame_depth(image_src, depth_dst, src_trans_dst, K, sampling_mode: str = "bilinear"):
    """Warp ``image_src`` (B, C, H, W) into the dst view.

    depth_dst: (B, H, W) metric depth in the destination view; src_trans_dst:
    (B, 4, 4) taking dst-camera points to src-camera coordinates; K: (B, 3, 3)
    at this resolution.
    """
    B, H, W = depth_dst.shape
    points_src = transform_points(src_trans_dst, depth_to_3d(depth_dst, K))
    points_src = torch.cat([points_src[..., :2], torch.relu(points_src[..., 2:3])], dim=-1)
    grid = normalize_pixel_coordinates(project_points(points_src, K), H, W)
    return grid_sample(image_src, grid, mode=sampling_mode, align_corners=True)


def _splat_points(previous_depth, previous_pose, current_pose, full_K, half_K):
    """The previous depth's points in the current camera, projected with
    ``half_K``: (uv (B, N, 2) float, z (B, N) with negative z set to 0)."""
    B = previous_depth.shape[0]
    trans = matmul_f32(inverse_pose(current_pose), previous_pose)  # prev-cam -> cur-cam
    points = transform_points(trans, depth_to_3d(previous_depth, full_K)).reshape(B, -1, 3)
    z = torch.relu(points[..., 2])
    points = torch.cat([points[..., :2], z[..., None]], dim=-1)
    return project_points(points, half_K), z


def _scatter_max(lin, z, n_pix: int):
    """(B, n_pix) largest z per slot of ``lin`` (B, N); 0 where none lands;
    slot ``n_pix`` is the sentinel of misses."""
    buf = torch.zeros((z.shape[0], n_pix + 1), dtype=z.dtype, device=z.device)
    buf = buf.scatter_reduce(1, lin, z, reduce="amax", include_self=True)
    return buf[:, :n_pix]


def splat_depth_max(previous_depth, previous_pose, current_pose, full_K, half_K,
                    out_height: int, out_width: int):
    """Forward-splat ``previous_depth`` (B, H, W) into the current view.

    Points are unprojected with ``full_K``, moved into the current camera,
    projected with ``half_K`` and rounded (half to even); each pixel keeps
    the largest z landing on it (the reference's collision rule,
    dvmvs/utils.py:110-154), unhit pixels are 0. Returns (B, out_height,
    out_width)."""
    uv, z = _splat_points(previous_depth, previous_pose, current_pose, full_K, half_K)
    uv = torch.round(uv)
    x, y = uv[..., 0], uv[..., 1]
    valid = (x >= 0) & (y >= 0) & (x < out_width) & (y < out_height)
    n_pix = out_height * out_width
    lin = torch.where(valid, y * out_width + x, torch.full_like(x, n_pix)).to(torch.int64)
    return _scatter_max(lin, z, n_pix).reshape(-1, out_height, out_width)


def splat_depth_max_strided(previous_depth, previous_pose, current_pose, full_K, half_K,
                            out_height: int, out_width: int, stride: int):
    """Forward-splat ``previous_depth`` (B, H, W) onto the stride-``stride``
    sub-grid of the half-resolution image: the fusion of a half-res
    max-z splat and a nearest 1/stride downsample.

    Points are unprojected with ``full_K``, moved into the current camera,
    projected with ``half_K`` and rounded (half to even); only points landing
    exactly on a stride-multiple site count, and each site keeps the largest
    z (unhit sites are 0). Returns (B, out_height, out_width).
    """
    uv, z = _splat_points(previous_depth, previous_pose, current_pose, full_K, half_K)
    uv = torch.round(uv)
    x, y = uv[..., 0], uv[..., 1]
    # validity is decided on the float coordinates, so no out-of-range value
    # is ever converted to an integer
    valid = (x >= 0) & (y >= 0) & (x < out_width * stride) & (y < out_height * stride)
    xi = torch.where(valid, x, torch.zeros_like(x)).to(torch.int64)
    yi = torch.where(valid, y, torch.zeros_like(y)).to(torch.int64)
    valid = valid & (xi % stride == 0) & (yi % stride == 0)
    n_pix = out_height * out_width
    lin = torch.where(valid, (yi // stride) * out_width + xi // stride,
                      torch.full_like(xi, n_pix))  # invalid -> sentinel slot
    return _scatter_max(lin, z, n_pix).reshape(-1, out_height, out_width)


def splat_depth_soft(previous_depth, previous_pose, current_pose, full_K, half_K,
                     out_height: int, out_width: int, tau: float = 0.05):
    """Differentiable forward splat (soft z-buffer), the JAX package's
    stand-in for the reference's point rasterizer
    (``get_differentiable_square_depth_estimation``, dvmvs/utils.py:157-202).

    The geometry of ``splat_depth_max``, but each projected point lands on
    its 4 neighbour pixels with bilinear weights, and a pixel's depth is the
    mean of what lands there weighted by exp(-(z - zmin)/tau), zmin being the
    pixel's nearest z (held constant for the gradient). Gradients reach
    ``previous_depth`` and both poses. Returns (B, out_height, out_width);
    unhit pixels are 0."""
    uv, z = _splat_points(previous_depth, previous_pose, current_pose, full_K, half_K)
    B, n_pix = z.shape[0], out_height * out_width
    x0, y0 = torch.floor(uv[..., 0]), torch.floor(uv[..., 1])
    fx, fy = uv[..., 0] - x0, uv[..., 1] - y0

    corners = []
    for dy, wy in ((0.0, 1.0 - fy), (1.0, fy)):
        for dx, wx in ((0.0, 1.0 - fx), (1.0, fx)):
            xi, yi = x0 + dx, y0 + dy
            valid = (xi >= 0) & (yi >= 0) & (xi < out_width) & (yi < out_height) & (z > 0)
            lin = torch.where(valid, yi * out_width + xi, torch.full_like(xi, n_pix))
            corners.append((lin.to(torch.int64), wx * wy * valid))

    # pass 1, without gradient: each pixel's nearest z, so the exponent is
    # -(z - zmin)/tau instead of -z/tau, which underflows
    zmin = torch.full((B, n_pix + 1), float("inf"), dtype=z.dtype, device=z.device)
    for lin, w in corners:
        zsafe = torch.where(w > 0, z, torch.full_like(z, float("inf")))
        zmin = zmin.scatter_reduce(1, lin, zsafe, reduce="amin", include_self=True)
    zmin = zmin.detach()

    num = torch.zeros((B, n_pix + 1), dtype=z.dtype, device=z.device)
    den = torch.zeros_like(num)
    hi, lo = torch.tensor(0.0, device=z.device), torch.tensor(-60.0, device=z.device)
    for lin, w in corners:
        ref_z = torch.gather(zmin, 1, lin)
        ref_z = torch.where(torch.isfinite(ref_z), ref_z, torch.zeros_like(ref_z))
        # the exponent is <= 0 by construction (z >= the pixel's zmin); the
        # clip keeps inf and nan of invalid (w = 0) corners out of the
        # backward pass. minimum(maximum(.)) as jnp.clip, so a tie at a
        # bound passes half the gradient as in JAX
        expo = torch.minimum(torch.maximum(-(z - ref_z) / tau, lo), hi)
        sw = w * torch.exp(expo)
        num = num.scatter_add(1, lin, sw * z)
        den = den.scatter_add(1, lin, sw)
    out = num[:, :n_pix] / torch.clamp_min(den[:, :n_pix], 1e-8)
    out = out * (den[:, :n_pix] > 1e-8)
    return out.reshape(B, out_height, out_width)
