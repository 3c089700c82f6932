"""TSDF fusion on the device (counterpart of dvmvs_tpu/ops/tsdf.py;
reference: sample-data/run-tsdf-reconstruction.py:79-152, 180-217).

The per-voxel projective update is elementwise over the volume, with one
gather of the pixel each voxel projects to, so it runs as torch operations
on the device, one frame at a time; the volume (tsdf, weight, packed colour)
stays there across frames, and mesh extraction (the native marching cubes,
``utils/native.py``) reads it back once at the end.

Semantics are the reference kernel's: truncation 5 * voxel_size, a
cumulative weighted average, voxels skipped where the depth is 0, behind the
surface by more than the margin, behind the camera or outside the image;
colour packed as b*65536 + g*256 + r with a per-frame rounded running
average; world to camera by the rigid inverse R^T (p - t); C ``roundf`` as
sign(x) * floor(|x| + 0.5). Volumes are flat float32 vectors of
DX * DY * DZ voxels (x major). Every product and division is its own torch
operation in the JAX package's order, so float32 rounding is the same on
either device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from dvmvs_tpu_torch.utils.native import marching_cubes

COLOR_CONST = 256.0 * 256.0


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    """C roundf: half away from zero (torch.round is half to even)."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def _unpack(packed: torch.Tensor):
    b = torch.floor(packed / COLOR_CONST)
    g = torch.floor((packed - b * COLOR_CONST) / 256.0)
    return b, g, packed - b * COLOR_CONST - g * 256.0


@torch.inference_mode()
def integrate_step(tsdf_vol, weight_vol, color_vol, vol_origin, voxel_size: float, color_im,
                   depth_im, K, cam_pose, obs_weight: float, trunc_margin: float,
                   vol_dim: Tuple[int, int, int]):
    """One frame of TSDF integration. Volumes (N,) float32 with logical dims
    ``vol_dim``; vol_origin (3,); color_im the packed (H, W) float image;
    depth_im (H, W); K (3, 3); cam_pose (4, 4) camera to world; all float32
    on one device. Returns the new (tsdf, weight, color) volumes."""
    DX, DY, DZ = vol_dim
    im_h, im_w = depth_im.shape
    idx = torch.arange(tsdf_vol.shape[0], dtype=torch.int64, device=tsdf_vol.device)
    vx = torch.div(idx, DY * DZ, rounding_mode="floor").float()
    rem = idx % (DY * DZ)
    vy = torch.div(rem, DZ, rounding_mode="floor").float()
    vz = (rem % DZ).float()
    px_w = vol_origin[0] + vx * voxel_size
    py_w = vol_origin[1] + vy * voxel_size
    pz_w = vol_origin[2] + vz * voxel_size

    t = cam_pose[:3, 3]
    R = cam_pose[:3, :3]
    dx = px_w - t[0]
    dy = py_w - t[1]
    dz = pz_w - t[2]
    cam_x = R[0, 0] * dx + R[1, 0] * dy + R[2, 0] * dz
    cam_y = R[0, 1] * dx + R[1, 1] * dy + R[2, 1] * dz
    cam_z = R[0, 2] * dx + R[1, 2] * dy + R[2, 2] * dz

    pix_x = _round_half_away(K[0, 0] * (cam_x / cam_z) + K[0, 2])
    pix_y = _round_half_away(K[1, 1] * (cam_y / cam_z) + K[1, 2])
    # the range test on the rounded floats: no out-of-range value (or NaN at
    # cam_z = 0) is ever converted to an integer
    in_view = (pix_x >= 0) & (pix_x < im_w) & (pix_y >= 0) & (pix_y < im_h) & (cam_z >= 0)
    zero = torch.zeros_like(pix_x)
    lin = (torch.where(in_view, pix_y, zero).long() * im_w
           + torch.where(in_view, pix_x, zero).long())
    depth_val = depth_im.reshape(-1)[lin]
    color_val = color_im.reshape(-1)[lin]

    depth_diff = depth_val - cam_z
    valid = in_view & (depth_val != 0) & (depth_diff >= -trunc_margin)
    dist = torch.clamp(depth_diff / trunc_margin, max=1.0)

    w_old = weight_vol
    w_new = w_old + obs_weight
    tsdf_new = (tsdf_vol * w_old + obs_weight * dist) / w_new

    def mix(old, new):
        return torch.clamp(_round_half_away((old * w_old + obs_weight * new) / w_new), max=255.0)

    (old_b, old_g, old_r), (new_b, new_g, new_r) = _unpack(color_vol), _unpack(color_val)
    color_new = (mix(old_b, new_b) * COLOR_CONST + mix(old_g, new_g) * 256.0
                 + mix(old_r, new_r))
    return (torch.where(valid, tsdf_new, tsdf_vol), torch.where(valid, w_new, weight_vol),
            torch.where(valid, color_new, color_vol))


def pack_color(color_im: np.ndarray) -> np.ndarray:
    """(H, W, 3) image -> packed ch2*65536 + ch1*256 + ch0 float
    (reference: run-tsdf-reconstruction.py:234)."""
    c = color_im.astype(np.float32)
    return np.floor(c[..., 2] * COLOR_CONST + c[..., 1] * 256.0 + c[..., 0])


def unpack_color(packed: np.ndarray) -> np.ndarray:
    b = np.floor(packed / COLOR_CONST)
    g = np.floor((packed - b * COLOR_CONST) / 256.0)
    r = packed - b * COLOR_CONST - g * 256.0
    return np.stack([r, g, b], axis=-1).astype(np.uint8)


class TSDFVolume:
    """Voxel-grid TSDF with colour on the device (reference:
    run-tsdf-reconstruction.py:30-351). Runs on the card unless
    ``device="cpu"`` is asked for; raises if the card is asked for and
    there is none."""

    def __init__(self, vol_bnds: np.ndarray, voxel_size: float, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"TSDFVolume: device {device!r} asked for, but "
                               "torch.cuda.is_available() is false; pass device=\"cpu\" to run "
                               "on the CPU")
        vol_bnds = np.asarray(vol_bnds, dtype=np.float64).copy()
        if vol_bnds.shape != (3, 2):
            raise ValueError(f"vol_bnds must be (3, 2), got {vol_bnds.shape}")
        self.voxel_size = float(voxel_size)
        self.trunc_margin = 5 * self.voxel_size
        self.vol_dim = np.ceil((vol_bnds[:, 1] - vol_bnds[:, 0]) / voxel_size).astype(int)
        vol_bnds[:, 1] = vol_bnds[:, 0] + self.vol_dim * voxel_size
        self.vol_bnds = vol_bnds
        self.vol_origin = vol_bnds[:, 0].astype(np.float32)

        n_vox = int(np.prod(self.vol_dim))
        self.tsdf = torch.ones((n_vox,), device=self.device)
        self.weight = torch.zeros((n_vox,), device=self.device)
        self.color = torch.zeros((n_vox,), device=self.device)
        self._origin = self._tensor(self.vol_origin)

    def _tensor(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(array, dtype=np.float32)).to(self.device)

    def integrate(self, color_im: np.ndarray, depth_im: np.ndarray, K: np.ndarray,
                  cam_pose: np.ndarray, obs_weight: float = 1.0):
        """Fuse one frame: colour (H, W, 3) or already packed (H, W), depth
        (H, W) in metres (0 = no measurement), K (3, 3), camera-to-world
        pose (4, 4)."""
        packed = color_im if color_im.ndim == 2 else pack_color(color_im)
        self.tsdf, self.weight, self.color = integrate_step(
            self.tsdf, self.weight, self.color, self._origin, self.voxel_size,
            self._tensor(packed), self._tensor(depth_im), self._tensor(K), self._tensor(cam_pose),
            float(obs_weight), self.trunc_margin, tuple(int(d) for d in self.vol_dim))

    def integrate_frames(self, color_ims, depth_ims, K, cam_poses, obs_weight: float = 1.0):
        """Fuse many frames in order (the same result as ``integrate`` on
        each)."""
        for color_im, depth_im, pose in zip(color_ims, depth_ims, cam_poses):
            self.integrate(color_im, depth_im, K, pose, obs_weight)

    def get_volume(self) -> Tuple[np.ndarray, np.ndarray]:
        shape = tuple(int(d) for d in self.vol_dim)
        return (self.tsdf.cpu().numpy().reshape(shape), self.color.cpu().numpy().reshape(shape))

    def get_mesh(self):
        """Marching cubes (native C++) and vertex colours, in world
        coordinates: (verts, faces, normals, rgb uint8)."""
        tsdf, color = self.get_volume()
        verts, faces, norms = marching_cubes(tsdf, level=0.0)
        vind = np.clip(np.round(verts).astype(int), 0, np.array(tsdf.shape) - 1)
        rgb = unpack_color(color[vind[:, 0], vind[:, 1], vind[:, 2]])
        verts_world = verts * self.voxel_size + self.vol_origin
        return verts_world.astype(np.float32), faces, norms, rgb

    def get_point_cloud(self) -> np.ndarray:
        verts, _, _, rgb = self.get_mesh()
        return np.hstack([verts, rgb.astype(np.float32)])


def get_view_frustum(depth_im: np.ndarray, K: np.ndarray, cam_pose: np.ndarray):
    """Corners of the camera view frustum in world coordinates
    (reference: run-tsdf-reconstruction.py:361-372)."""
    im_h, im_w = depth_im.shape
    max_depth = np.max(depth_im)
    pts = np.array([
        (np.array([0, 0, 0, im_w, im_w]) - K[0, 2])
        * np.array([0, max_depth, max_depth, max_depth, max_depth]) / K[0, 0],
        (np.array([0, 0, im_h, 0, im_h]) - K[1, 2])
        * np.array([0, max_depth, max_depth, max_depth, max_depth]) / K[1, 1],
        np.array([0, max_depth, max_depth, max_depth, max_depth]),
    ])
    pts_h = np.vstack([pts, np.ones((1, pts.shape[1]))])
    return (cam_pose @ pts_h)[:3]


def calculate_volume_bounds(depth_maps, poses, K) -> np.ndarray:
    bounds = np.zeros((3, 2))
    for depth, pose in zip(depth_maps, poses):
        pts = get_view_frustum(depth, K, pose)
        bounds[:, 0] = np.minimum(bounds[:, 0], np.amin(pts, axis=1))
        bounds[:, 1] = np.maximum(bounds[:, 1], np.amax(pts, axis=1))
    return bounds
