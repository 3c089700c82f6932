"""Plane-sweep cost volume (counterpart of dvmvs_tpu/ops/cost_volume.py).

For each of ``n_depth_levels`` planes uniform in inverse depth, warp the
measurement features into the reference view with the plane-induced
homography, sample them bilinearly (zeros padding, align_corners=True) and
reduce against the reference features: dot product / channels, or L1.
Multi-view fusion is the masked mean over measurement views.

``plane_sweep_cost_volume`` is the gather reference built from poses, as
the original model computes it. ``cost_volume_fused`` is the path the
networks take: one call of the fused kernel wrapper
(``ops/plane_sweep.py``) with no band ladder and no span check.
``plane_sweep_cost_volume_train`` is the single-view training sweep, one
call of ``plane_sweep_train`` (forward and backward kernels) in place of the
JAX package's tier ladder. Features are NCHW and the cost volume leaves as
(B, P, H, W), planes as channels.
"""

from __future__ import annotations

from typing import Optional

import torch

from dvmvs_tpu_torch.ops.geometry import inverse_pose, make_warp_grid, matmul_f32
from dvmvs_tpu_torch.ops.plane_sweep import (
    build_plane_matrices,
    plane_sweep_multiview,
    plane_sweep_train,
    sweep_reduce,
)


def inverse_depth_planes(min_depth: float, max_depth: float, n_levels: int,
                         device=None) -> torch.Tensor:
    """(P,) inverse depths, uniform in 1/d from 1/max_depth to 1/min_depth."""
    base = 1.0 / max_depth
    step = (1.0 / min_depth - 1.0 / max_depth) / (n_levels - 1)
    return base + step * torch.arange(n_levels, dtype=torch.float32, device=device)


def _plane_grids(ref_pose, meas_pose, K, height: int, width: int, inv_depths):
    """(B, P, H, W, 2) grid-sample coordinates with the reference's W/2, H/2
    normalisers."""
    B = ref_pose.shape[0]
    P = inv_depths.shape[0]
    grid = make_warp_grid(width, height, ref_pose.device)  # (3, H*W)
    extrinsic = matmul_f32(inverse_pose(meas_pose), ref_pose)  # ref-cam -> meas-cam
    R = extrinsic[:, :3, :3]
    t = extrinsic[:, :3, 3:4]
    Kt = matmul_f32(K, t)  # (B, 3, 1)
    K_R_Kinv = matmul_f32(matmul_f32(K, R), inverse_pose(K))
    base = (K_R_Kinv[:, :, :, None] * grid[None, None, :, :]).sum(dim=2)  # (B, 3, N)
    coords = base[:, None] + Kt[:, None] * inv_depths[None, :, None, None]
    xy = coords[:, :, 0:2, :] / (coords[:, :, 2:3, :] + 1e-8)
    x = xy[:, :, 0, :] / (width / 2.0) - 1.0
    y = xy[:, :, 1, :] / (height / 2.0) - 1.0
    return torch.stack([x, y], dim=-1).reshape(B, P, height, width, 2)


def plane_sweep_cost_volume(ref_feat, meas_feat, ref_pose, meas_pose, K,
                            min_depth: float, max_depth: float, n_depth_levels: int,
                            dot_product: bool = True, plane_chunk: int = 8):
    """Single-view gather sweep: features (B, C, H, W), poses camera-to-world
    (B, 4, 4), K (B, 3, 3) at feature resolution -> (B, P, H, W)."""
    B, C, H, W = ref_feat.shape
    inv_depths = inverse_depth_planes(min_depth, max_depth, n_depth_levels, ref_feat.device)
    grids = _plane_grids(ref_pose, meas_pose, K, H, W, inv_depths)
    return sweep_reduce(ref_feat, meas_feat, grids, dot_product, plane_chunk)


def _masked_view_mean(per_view, view_mask):
    """per_view (V, B, P, H, W) -> masked mean (B, P, H, W)."""
    if view_mask is None:
        return per_view.mean(dim=0)
    m = view_mask.to(per_view.dtype)  # (B, V)
    weighted = (per_view * m.t()[:, :, None, None, None]).sum(dim=0)
    denom = torch.clamp(m.sum(dim=1), min=1.0)[:, None, None, None]
    return weighted / denom


def cost_volume_fused(ref_feat, meas_feats, ref_pose, meas_poses, K,
                      min_depth: float, max_depth: float, n_depth_levels: int,
                      dot_product: bool = True,
                      view_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-view fused cost volume through the plane-sweep kernel.

    ref_feat (B, C, H, W); meas_feats (B, V, C, H, W); ref_pose (B, 4, 4);
    meas_poses (B, V, 4, 4); K (B, 3, 3) at feature resolution; view_mask
    optional (B, V): padded views get weight 0 and the mean divides by the
    number of valid views. Returns (B, P, H, W) float32.
    """
    B, V = meas_feats.shape[:2]
    inv_depths = inverse_depth_planes(min_depth, max_depth, n_depth_levels, ref_feat.device)
    mats = build_plane_matrices(ref_pose[:, None], meas_poses, K[:, None], inv_depths)
    if view_mask is None:
        weights = torch.full((B, V), 1.0 / V, dtype=torch.float32, device=ref_feat.device)
    else:
        m = view_mask.to(torch.float32)
        weights = m / torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)
    ref = ref_feat.to(torch.float32).permute(0, 2, 3, 1).contiguous()
    meas = meas_feats.to(torch.float32).permute(0, 1, 3, 4, 2).contiguous()
    return plane_sweep_multiview(ref, meas, mats.contiguous(), weights.contiguous(),
                                 dot_product)


def plane_sweep_cost_volume_train(ref_feat, meas_feat, ref_pose, meas_pose, K,
                                  min_depth: float, max_depth: float,
                                  n_depth_levels: int) -> torch.Tensor:
    """Differentiable single-view dot-product sweep for training: features
    (B, C, H, W), poses camera-to-world (B, 4, 4), K (B, 3, 3) at feature
    resolution -> (B, P, H, W). Gradients reach both feature maps; the
    geometry gets none."""
    inv_depths = inverse_depth_planes(min_depth, max_depth, n_depth_levels, ref_feat.device)
    mats = build_plane_matrices(ref_pose, meas_pose, K, inv_depths)
    ref = ref_feat.to(torch.float32).permute(0, 2, 3, 1).contiguous()
    meas = meas_feat.to(torch.float32).permute(0, 2, 3, 1).contiguous()
    return plane_sweep_train(ref, meas, mats.contiguous())
