"""Camera geometry, warps, the forward splat and the gather plane sweep of
the reference, in plain PyTorch (and NumPy for the host's pose distance).

Small matrix products are written as broadcast multiply-adds, so they stay
in float32 whatever the matmul precision flags are. The plane sweep warps
each measurement view onto each inverse-depth plane with ``F.grid_sample``
and reduces against the reference features, as the original model does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

HOMOGENEOUS_EPS = 1e-8


def pose_distance(reference_pose: np.ndarray, measurement_pose: np.ndarray):
    """(combined, R_measure, t_measure) of two camera-to-world poses."""
    rel = np.linalg.inv(reference_pose) @ measurement_pose
    R_measure = np.sqrt(2 * (1 - min(3.0, float(np.trace(rel[:3, :3]))) / 3))
    t_measure = float(np.linalg.norm(rel[:3, 3]))
    return float(np.sqrt(t_measure ** 2 + R_measure ** 2)), float(R_measure), t_measure


def matmul(a, b):
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def inverse(m):
    return torch.linalg.inv_ex(m).inverse


def scale_intrinsics(K, factor: float):
    return torch.cat([K[:, :2] * factor, K[:, 2:]], dim=1)


def depth_to_3d(depth, K):
    B, H, W = depth.shape
    u = torch.arange(W, dtype=depth.dtype, device=depth.device)[None, None, :]
    v = torch.arange(H, dtype=depth.dtype, device=depth.device)[None, :, None]
    x = (u - K[:, 0, 2][:, None, None]) / K[:, 0, 0][:, None, None] * depth
    y = (v - K[:, 1, 2][:, None, None]) / K[:, 1, 1][:, None, None] * depth
    return torch.stack([x, y, depth], dim=-1)


def transform_points(trans, points):
    B = trans.shape[0]
    flat = points.reshape(B, -1, 3)
    out = (trans[:, None, :3, :3] * flat[:, :, None, :]).sum(-1) + trans[:, None, :3, 3]
    return out.reshape(points.shape)


def project_points(points, K):
    B = K.shape[0]
    flat = points.reshape(B, -1, 3)
    z = flat[..., 2:3]
    ok = z.abs() > HOMOGENEOUS_EPS
    scale = torch.where(ok, 1.0 / torch.where(ok, z, torch.ones_like(z)), torch.ones_like(z))
    xy = flat[..., :2] * scale
    u = xy[..., 0] * K[:, 0, 0][:, None] + K[:, 0, 2][:, None]
    v = xy[..., 1] * K[:, 1, 1][:, None] + K[:, 1, 2][:, None]
    return torch.stack([u, v], -1).reshape(points.shape[:-1] + (2,))


def warp_hidden_state(h, previous_pose, current_pose, depth, K):
    """Backward warp of h (B, C, H, W) from the previous keyframe into the
    current one with the current depth estimate (B, H, W); pixels whose
    estimate is <= 0.01 m are zeroed."""
    B, H, W = depth.shape
    trans = matmul(inverse(previous_pose), current_pose)
    points = transform_points(trans, depth_to_3d(depth, K))
    points = torch.cat([points[..., :2], torch.relu(points[..., 2:3])], dim=-1)
    uv = project_points(points, K)
    grid = torch.stack([uv[..., 0] * (2.0 / (W - 1)) - 1.0, uv[..., 1] * (2.0 / (H - 1)) - 1.0],
                       -1)
    warped = F.grid_sample(h, grid, mode="bilinear", padding_mode="zeros", align_corners=True)
    return warped * (depth > 0.01)[:, None].to(warped.dtype)


def splat_hypothesis(previous_depth, previous_pose, current_pose, K, out_h: int, out_w: int,
                     stride: int = 16):
    """The previous depth (B, H, W) forward-splatted into the current view at
    half resolution (rounded half to even, the largest z per pixel) and
    nearest-downsampled by ``stride``: (B, out_h, out_w), 0 where nothing
    lands. Written as the splat and then the downsample."""
    B = previous_depth.shape[0]
    trans = matmul(inverse(current_pose), previous_pose)
    points = transform_points(trans, depth_to_3d(previous_depth, K)).reshape(B, -1, 3)
    z = torch.relu(points[..., 2])
    uv = torch.round(project_points(torch.cat([points[..., :2], z[..., None]], -1),
                                    scale_intrinsics(K, 0.5)))
    Hh, Wh = out_h * stride, out_w * stride
    x, y = uv[..., 0], uv[..., 1]
    valid = (x >= 0) & (y >= 0) & (x < Wh) & (y < Hh)
    lin = torch.where(valid, y * Wh + x, torch.full_like(x, Hh * Wh)).to(torch.int64)
    half = torch.zeros((B, Hh * Wh + 1), dtype=z.dtype, device=z.device)
    half = half.scatter_reduce(1, lin, z, reduce="amax", include_self=True)[:, :-1]
    return half.reshape(B, Hh, Wh)[:, ::stride, ::stride]


def inverse_depth_planes(min_depth: float, max_depth: float, n: int, device=None):
    step = (1.0 / min_depth - 1.0 / max_depth) / (n - 1)
    return 1.0 / max_depth + step * torch.arange(n, dtype=torch.float32, device=device)


def plane_matrices(ref_pose, meas_pose, K, inv_depths):
    """M_p = K R K^-1 + inv_depth_p (K t) e3^T, the pixel warp of each plane:
    poses (..., 4, 4), K (..., 3, 3) -> (..., P, 3, 3)."""
    extrinsic = matmul(inverse(meas_pose), ref_pose)
    Kt = matmul(K, extrinsic[..., :3, 3:4])
    A = matmul(matmul(K, extrinsic[..., :3, :3]), inverse(K))
    Kt_e3 = torch.zeros_like(A)
    Kt_e3[..., :, 2:3] = Kt
    return A[..., None, :, :] + inv_depths[:, None, None] * Kt_e3[..., None, :, :]


def sweep_view(ref, meas, mats, plane_chunk: int = 8):
    """Dot-product cost of one view: ref and meas (B, C, H, W), mats (B, P,
    3, 3) -> (B, P, H, W), sampled bilinearly with zeros padding and the
    original model's W/2, H/2 normalisers."""
    B, C, H, W = ref.shape
    x = torch.arange(W, dtype=torch.float32, device=ref.device)[None, :]
    y = torch.arange(H, dtype=torch.float32, device=ref.device)[:, None]
    m = mats[..., None, None]
    den = m[..., 2, 0, :, :] * x + m[..., 2, 1, :, :] * y + m[..., 2, 2, :, :] + 1e-8
    gx = (m[..., 0, 0, :, :] * x + m[..., 0, 1, :, :] * y + m[..., 0, 2, :, :]) / den
    gy = (m[..., 1, 0, :, :] * x + m[..., 1, 1, :, :] * y + m[..., 1, 2, :, :]) / den
    grids = torch.stack([gx / (W / 2.0) - 1.0, gy / (H / 2.0) - 1.0], -1)
    costs = []
    for p0 in range(0, mats.shape[1], plane_chunk):
        g = grids[:, p0:p0 + plane_chunk]
        n = g.shape[1]
        warped = F.grid_sample(meas, g.reshape(B, n * H, W, 2), mode="bilinear",
                               padding_mode="zeros", align_corners=True).reshape(B, C, n, H, W)
        costs.append((ref[:, :, None] * warped).sum(1) / C)
    return torch.cat(costs, 1)


def multiview_cost_volume(ref, meas, ref_pose, meas_poses, K, min_depth, max_depth, planes,
                          view_mask=None):
    """ref (B, C, H, W), meas (B, V, C, H, W), K at this resolution; views of
    mask 0 get no weight and the mean divides by the valid views."""
    B, V = meas.shape[:2]
    inv = inverse_depth_planes(min_depth, max_depth, planes, ref.device)
    mats = plane_matrices(ref_pose[:, None], meas_poses, K[:, None], inv)
    if view_mask is None:
        weights = torch.full((B, V), 1.0 / V, device=ref.device)
    else:
        m = view_mask.to(torch.float32)
        weights = m / torch.clamp(m.sum(1, keepdim=True), min=1.0)
    total = 0.0
    for v in range(V):
        total = total + weights[:, v, None, None, None] * sweep_view(ref, meas[:, v], mats[:, v])
    return total
