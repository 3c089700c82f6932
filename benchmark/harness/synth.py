"""Procedural rooms and camera walks: a copy of the port's
``data/synthetic.py`` (``SynthScene``: textured box rooms ray-rendered with
exact z-depth, and smooth camera walks), kept here so that the traffic does
not change when the program does.
"""

from __future__ import annotations

import numpy as np


class Rect:
    """Textured rectangle: corner p0, edge vectors e1, e2 (not necessarily
    unit), texture = f(u, v) with u, v in [0, 1]."""

    def __init__(self, p0, e1, e2, palette, tex_seed, checker=8.0):
        self.p0 = np.asarray(p0, np.float64)
        self.e1 = np.asarray(e1, np.float64)
        self.e2 = np.asarray(e2, np.float64)
        self.n = np.cross(self.e1, self.e2)
        self.n /= np.linalg.norm(self.n)
        self.palette = np.asarray(palette, np.float64)  # (2, 3) in [0,1]
        self.checker = checker
        rs = np.random.RandomState(tex_seed)
        self.noise = rs.rand(9, 9)
        self.stripe_freq = rs.uniform(3.0, 11.0)
        self.stripe_phase = rs.uniform(0, 2 * np.pi)

    def texture(self, u, v):
        """(..., 3) albedo for texture coords in [0, 1]."""
        cu = np.floor(u * self.checker).astype(np.int64)
        cv = np.floor(v * self.checker).astype(np.int64)
        check = ((cu + cv) % 2).astype(np.float64)
        stripe = 0.5 + 0.5 * np.sin(
            self.stripe_freq * 2 * np.pi * u + self.stripe_phase)
        # bilinear smoothed noise over a 9x9 grid
        gu = np.clip(u * 8.0, 0, 7.999)
        gv = np.clip(v * 8.0, 0, 7.999)
        iu, iv = gu.astype(np.int64), gv.astype(np.int64)
        fu, fv = gu - iu, gv - iv
        n = (self.noise[iu, iv] * (1 - fu) * (1 - fv)
             + self.noise[iu + 1, iv] * fu * (1 - fv)
             + self.noise[iu, iv + 1] * (1 - fu) * fv
             + self.noise[iu + 1, iv + 1] * fu * fv)
        w = np.clip(0.55 * check + 0.25 * stripe + 0.4 * n, 0.0, 1.0)
        return (self.palette[0] * (1 - w[..., None])
                + self.palette[1] * w[..., None])


def _box_rects(lo, hi, rs, inward=False):
    """Six textured faces of an axis-aligned box. ``inward`` flips nothing
    geometrically (rects are two-sided here) — kept for readability."""
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    d = hi - lo
    faces = []
    for axis in range(3):
        for side, base in ((0, lo), (1, None)):
            p0 = lo.copy() if side == 0 else lo.copy()
            if side == 1:
                p0[axis] = hi[axis]
            a1, a2 = [i for i in range(3) if i != axis]
            e1 = np.zeros(3)
            e1[a1] = d[a1]
            e2 = np.zeros(3)
            e2[a2] = d[a2]
            palette = rs.uniform(0.15, 0.95, (2, 3))
            faces.append(Rect(p0, e1, e2, palette, rs.randint(1 << 31),
                              checker=rs.choice([4.0, 6.0, 8.0, 12.0])))
    return faces


class SynthScene:
    """A room with random textured boxes and a smooth camera trajectory."""

    def __init__(self, seed: int, n_boxes: int = 6,
                 room=(6.0, 6.0, 3.0)):
        rs = np.random.RandomState(seed)
        self.rs = rs
        self.room = np.asarray(room, np.float64)
        self.rects = _box_rects([0, 0, 0], self.room, rs)
        for _ in range(n_boxes):
            size = rs.uniform(0.3, 1.4, 3)
            size[2] = rs.uniform(0.3, min(1.8, self.room[2] - 0.2))
            lo = np.array([
                rs.uniform(0.3, self.room[0] - 0.3 - size[0]),
                rs.uniform(0.3, self.room[1] - 0.3 - size[1]),
                0.0,
            ])
            self.rects += _box_rects(lo, lo + size, rs)

    def trajectory(self, n_frames: int, step: float = 0.03):
        """Smooth c2w poses: low-pass random-walk positions in the free
        central region, look-at toward a slowly wandering target, small
        roll. ~``step`` m of translation per frame (the keyframe heuristic
        then accepts roughly every 3rd-5th frame, like real video)."""
        rs = self.rs
        cx, cy, cz = self.room * 0.5
        margin = 1.1

        def smooth_walk(n, lo, hi, start, sigma):
            x = np.empty((n, 3))
            x[0] = start
            v = np.zeros(3)
            for i in range(1, n):
                v = 0.92 * v + rs.randn(3) * sigma
                x[i] = np.clip(x[i - 1] + v, lo, hi)
                v = x[i] - x[i - 1]
            return x

        # momentum walks amplify sigma by ~1/sqrt(1-0.92^2) ~ 2.6x per
        # axis; these factors land the COMBINED pose-distance measure
        # (translation + rotation from the moving look-at) near `step`
        pos = smooth_walk(
            n_frames,
            [margin, margin, 1.0], self.room - [margin, margin, 1.0],
            [cx + rs.uniform(-0.5, 0.5), cy + rs.uniform(-0.5, 0.5),
             cz + rs.uniform(-0.3, 0.3)], step * 0.12)
        target = smooth_walk(
            n_frames, [0.5, 0.5, 0.4], self.room - [0.5, 0.5, 0.4],
            [cx, cy, cz], step * 0.2)
        roll = np.cumsum(rs.randn(n_frames) * 0.0015)
        roll -= roll.mean()

        poses = np.empty((n_frames, 4, 4))
        for i in range(n_frames):
            fwd = target[i] - pos[i]
            dist = np.linalg.norm(fwd)
            if dist < 0.8:  # degenerate look-at: push the target away
                fwd = fwd + (0.8 - dist) * np.array([1.0, 0.0, 0.0])
            fwd /= np.linalg.norm(fwd)
            up0 = np.array([0.0, 0.0, 1.0])
            right = np.cross(fwd, up0)
            right /= np.linalg.norm(right)
            down = np.cross(fwd, right)  # +y down (image convention)
            c, s = np.cos(roll[i]), np.sin(roll[i])
            right_r = c * right + s * down
            down_r = -s * right + c * down
            P = np.eye(4)
            P[:3, 0] = right_r
            P[:3, 1] = down_r
            P[:3, 2] = fwd
            P[:3, 3] = pos[i]
            poses[i] = P
        return poses

    def render(self, pose, K, width: int, height: int,
               light=(0.4, 0.25, 0.88)):
        """(rgb uint8 (H, W, 3), z-depth f32 (H, W) in meters)."""
        Kinv = np.linalg.inv(np.asarray(K, np.float64))
        x, y = np.meshgrid(np.arange(width), np.arange(height))
        pix = np.stack([x + 0.0, y + 0.0, np.ones_like(x, np.float64)], -1)
        d_cam = pix @ Kinv.T                      # (H, W, 3), z = 1
        R, o = pose[:3, :3], pose[:3, 3]
        d_world = d_cam @ R.T                     # rows transform

        HW = height * width
        dirs = d_world.reshape(HW, 3)
        best_t = np.full(HW, np.inf)
        best_rgb = np.zeros((HW, 3))
        light = np.asarray(light, np.float64)
        light = light / np.linalg.norm(light)

        for rect in self.rects:
            denom = dirs @ rect.n
            with np.errstate(divide="ignore", invalid="ignore"):
                t = ((rect.p0 - o) @ rect.n) / denom
            h = o[None] + t[:, None] * dirs
            rel = h - rect.p0
            u = rel @ rect.e1 / (rect.e1 @ rect.e1)
            v = rel @ rect.e2 / (rect.e2 @ rect.e2)
            hit = ((t > 1e-4) & (t < best_t)
                   & (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1))
            if not hit.any():
                continue
            shade = 0.55 + 0.45 * abs(float(rect.n @ light))
            rgb = rect.texture(u[hit], v[hit]) * shade
            best_t[hit] = t[hit]
            best_rgb[hit] = rgb

        depth = best_t.reshape(height, width)
        depth[~np.isfinite(depth)] = 0.0
        rgb = np.clip(best_rgb.reshape(height, width, 3) * 255.0,
                      0, 255).astype(np.uint8)
        return rgb, depth.astype(np.float32)


def default_K(width: int, height: int) -> np.ndarray:
    f = 0.95 * width  # ~55 deg horizontal FoV, indoor-camera-like
    return np.array([[f, 0.0, width / 2.0],
                     [0.0, f, height / 2.0],
                     [0.0, 0.0, 1.0]], np.float64)
