"""Camera geometry primitives in PyTorch (counterpart of dvmvs_tpu/ops/geometry.py).

Every small matrix product here is written out as broadcast multiply-adds
(``matmul_f32``) rather than ``torch.matmul``: the products stay in full
float32 whatever the TF32 settings are, because reduced precision moves
sample positions by about 0.1 px. Inverses use ``torch.linalg.inv_ex``, whose
result needs no host synchronisation (``inv`` checks for errors on the
host). Host-side NumPy variants serve the keyframe buffer.
"""

from __future__ import annotations

import numpy as np
import torch

# kornia's convert_points_from_homogeneous guard: coordinates with
# |z| <= eps are left undivided (scale 1) rather than producing inf.
_HOMOGENEOUS_EPS = 1e-8


def pose_distance_np(reference_pose: np.ndarray, measurement_pose: np.ndarray):
    """Combined SE(3) distance between two camera-to-world poses.

    Returns (combined, R_measure, t_measure), host-side float64 NumPy.
    """
    rel = np.linalg.inv(reference_pose) @ measurement_pose
    R = rel[:3, :3]
    t = rel[:3, 3]
    R_measure = np.sqrt(2 * (1 - min(3.0, float(np.trace(R))) / 3))
    t_measure = float(np.linalg.norm(t))
    combined = np.sqrt(t_measure ** 2 + R_measure ** 2)
    return float(combined), float(R_measure), t_measure


def is_pose_available_np(pose: np.ndarray) -> bool:
    """True when the pose contains no NaN/Inf."""
    return bool(np.isfinite(pose).all())


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for small matrices as exact-f32 multiply-adds (broadcasts
    over leading dims like ``torch.matmul``)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def inverse_pose(pose: torch.Tensor) -> torch.Tensor:
    """Generic inverse of (..., 4, 4) pose (or 3x3 intrinsics) matrices."""
    return torch.linalg.inv_ex(pose).inverse


def make_warp_grid(width: int, height: int, device=None) -> torch.Tensor:
    """Homogeneous pixel grid (3, H*W) float32: rows are (x, y, 1)."""
    x = torch.arange(width, dtype=torch.float32, device=device)
    y = torch.arange(height, dtype=torch.float32, device=device)
    yg, xg = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([xg.reshape(-1), yg.reshape(-1),
                        torch.ones_like(xg).reshape(-1)], dim=0)


def depth_to_3d(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Unproject depth (B, H, W) with K (B, 3, 3) to camera points (B, H, W, 3)."""
    B, H, W = depth.shape
    u = torch.arange(W, dtype=depth.dtype, device=depth.device)[None, None, :]
    v = torch.arange(H, dtype=depth.dtype, device=depth.device)[None, :, None]
    fx = K[:, 0, 0][:, None, None]
    fy = K[:, 1, 1][:, None, None]
    cx = K[:, 0, 2][:, None, None]
    cy = K[:, 1, 2][:, None, None]
    x = (u - cx) / fx * depth
    y = (v - cy) / fy * depth
    return torch.stack([x, y, depth], dim=-1)


def transform_points(trans: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply a (B, 4, 4) rigid transform to (B, ..., 3) points."""
    B = trans.shape[0]
    R = trans[:, :3, :3]
    t = trans[:, :3, 3]
    flat = points.reshape(B, -1, 3)
    out = (R[:, None, :, :] * flat[:, :, None, :]).sum(dim=-1) + t[:, None, :]
    return out.reshape(points.shape)


def project_points(points: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Project (B, ..., 3) camera points through (B, 3, 3) intrinsics to
    (B, ..., 2) pixels; points with |z| <= 1e-8 stay undivided (kornia)."""
    B = K.shape[0]
    flat = points.reshape(B, -1, 3)
    z = flat[..., 2:3]
    z_ok = z.abs() > _HOMOGENEOUS_EPS
    scale = torch.where(z_ok, 1.0 / torch.where(z_ok, z, torch.ones_like(z)),
                        torch.ones_like(z))
    xy = flat[..., :2] * scale
    u = xy[..., 0] * K[:, 0, 0][:, None] + K[:, 0, 2][:, None]
    v = xy[..., 1] * K[:, 1, 1][:, None] + K[:, 1, 2][:, None]
    return torch.stack([u, v], dim=-1).reshape(points.shape[:-1] + (2,))


def normalize_pixel_coordinates(coords: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Pixel coordinates (..., 2) in xy order -> [-1, 1], align_corners=True."""
    x = coords[..., 0] * (2.0 / (width - 1)) - 1.0
    y = coords[..., 1] * (2.0 / (height - 1)) - 1.0
    return torch.stack([x, y], dim=-1)
