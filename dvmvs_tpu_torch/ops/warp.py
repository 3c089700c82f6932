"""Depth-based warping (counterpart of dvmvs_tpu/ops/warp.py).

  - ``warp_frame_depth``: backward warp of a source image or hidden state
    into the destination view using the destination depth.
  - ``splat_depth_max_strided``: forward splat of the previous depth onto a
    strided sub-grid, keeping the largest z per landing site.
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
    B = previous_depth.shape[0]
    trans = matmul_f32(inverse_pose(current_pose), previous_pose)  # prev-cam -> cur-cam
    points = transform_points(trans, depth_to_3d(previous_depth, full_K)).reshape(B, -1, 3)
    z = torch.relu(points[..., 2])
    points = torch.cat([points[..., :2], z[..., None]], dim=-1)

    uv = torch.round(project_points(points, half_K))
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
    buf = torch.zeros((B, n_pix + 1), dtype=z.dtype, device=z.device)
    buf = buf.scatter_reduce(1, lin, z, reduce="amax", include_self=True)
    return buf[:, :n_pix].reshape(B, out_height, out_width)
