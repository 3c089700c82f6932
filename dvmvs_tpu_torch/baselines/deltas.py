"""DELTAS baseline (counterpart of dvmvs_tpu/baselines/deltas.py; reference:
dvmvs/baselines/deltas/), sparse-then-dense depth in three stages:

  1. SuperPoint detection and description over a ResNet-50 trunk: the
     65-way detector head (dustbin, depth-to-space) and the descriptor head
     (concatenated with the trunk's skips) at 1/8; iterative max-pool NMS;
     a fixed number of top-k keypoints; L2-normalised 128-d descriptors
     sampled at the keypoints.
  2. Triangulation: rotated-ROI epipolar matching (each keypoint's search
     box is the epipolar segment between its reprojections at the minimum
     and maximum depth), descriptor correlation, a BatchNorm'd match map,
     confidence = sigmoid(its global max) gated by a valid segment, a 2-D
     soft-argmax mapped back through the ROI, then confidence-weighted
     linear DLT triangulation by SVD (``ops/dlt.py``).
  3. Densification: the sparse depth through a narrow 1-channel ResNet-50
     trunk, its skips concatenated with the image trunk's, Gudi
     up-projections, a dense-cascade ASPP at 1/8 and 1x1 heads; the final
     conv emits raw depth.

The deviations of the JAX package are kept: a plain top-k of a fixed count
(ties go to the lower index: a stable descending sort, as ``lax.top_k``)
instead of threshold, top-k and random refill, and validity masks instead
of data-dependent keypoint lists. The state-dict names are the reference's:
``superpoint``, ``triangulation`` and ``sparse_to_dense`` hold the
checkpoint's ``state_dict``, ``state_dict_tri`` and ``state_dict_depth``.
The reference's ``convD_confa``/``bnconvD_confa`` are not declared: its
inference never applies them, so load ``state_dict_tri`` with
``strict=False``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dvmvs_tpu_torch.baselines.registry import register_baseline
from dvmvs_tpu_torch.baselines.steps import GraphedEstimator, relative_inputs, relative_views
from dvmvs_tpu_torch.models.layers import BN_EPS, BN_MOMENTUM, BatchNorm2d, seeded_model
from dvmvs_tpu_torch.ops import dlt
from dvmvs_tpu_torch.ops.sampling import grid_sample, resize_bilinear_align_corners

N_KEYPOINTS = 512
OUT_LENGTH = 100       # samples along the epipolar segment (reference out_length)
DIST_ORTHO = 1         # rows each side of the segment (reference dist_ortogonal)
MIN_DEPTH, MAX_DEPTH = 0.5, 10.0
NMS_RADIUS, BORDER = 9, 4


def _bn(features: int):
    return BatchNorm2d(features, eps=BN_EPS, momentum=BN_MOMENTUM)


def _conv(in_channels, features, kernel, bias=False, stride=1, dilation=1):
    pad = dilation * (kernel - 1) // 2
    return nn.Conv2d(in_channels, features, kernel, stride=stride, padding=pad,
                     dilation=dilation, bias=bias)


def nearest_indices(n_out: int, n_in: int, device=None) -> torch.Tensor:
    """(n_out,) int64 source indices floor(dst * in/out), the product in
    float32 as the JAX package computes it, made on ``device`` (no host
    upload, so a forward that calls it captures)."""
    scale = float(np.float32(n_in / n_out))  # a float32 value; the product stays float32
    return torch.floor(torch.arange(n_out, dtype=torch.float32, device=device) * scale).long()


def nearest_resize_torch(x, out_h: int, out_w: int):
    """``F.interpolate(mode="nearest")``'s index rule, src = floor(dst *
    in/out) in float32, as the JAX package computes it (the Gudi block's
    resize when the skip's size is not a multiple of the input's)."""
    H, W = x.shape[-2:]
    return x[:, :, nearest_indices(out_h, H, x.device)][:, :, :, nearest_indices(out_w, W,
                                                                                  x.device)]


def unpool_zero(x, out_h: int, out_w: int):
    """Zero-stuffed 2x unpool, then crop: the value at the top left of every
    2x2 cell, zeros elsewhere (the reference's Unpool)."""
    B, C, H, W = x.shape
    up = x.new_zeros((B, C, 2 * H, 2 * W))
    up[:, :, ::2, ::2] = x
    return up[:, :, :out_h, :out_w]


# --------------------------------------------------------- ResNet-50 trunk
class Bottleneck(nn.Module):
    """torchvision's bottleneck: 1x1 -> 3x3 (stride) -> 1x1 (x4) + skip."""

    def __init__(self, in_channels: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1, self.bn1 = _conv(in_channels, features, 1), _bn(features)
        self.conv2, self.bn2 = _conv(features, features, 3, stride=stride), _bn(features)
        self.conv3, self.bn3 = _conv(features, 4 * features, 1), _bn(4 * features)
        self.downsample = None
        if in_channels != 4 * features or stride != 1:
            self.downsample = nn.Sequential(_conv(in_channels, 4 * features, 1, stride=stride),
                                            _bn(4 * features))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu((x if self.downsample is None else self.downsample(x)) + y)


class ResNet50Trunk(nn.Module):
    """conv1..layer4 of ResNet-50 ([3, 4, 6, 3] bottlenecks) with the skip
    pyramid the reference taps. width 64 is the image trunk (stage outputs
    256/512/1024/2048); width 16 the densifier's narrow 1-channel trunk
    (64/128/256/512)."""

    def __init__(self, in_features: int = 3, width: int = 64):
        super().__init__()
        self.conv1 = _conv(in_features, width, 7, stride=2)
        self.bn1 = _bn(width)
        channels = width
        for i, (blocks, features, stride) in enumerate(
                [(3, width, 1), (4, 2 * width, 2), (6, 4 * width, 2), (3, 8 * width, 2)]):
            layer = []
            for b in range(blocks):
                layer.append(Bottleneck(channels, features, stride if b == 0 else 1))
                channels = 4 * features
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))

    def trunk(self, x) -> dict:
        x = F.relu(self.bn1(self.conv1(x)))
        half = x
        quarter = self.layer1(F.max_pool2d(x, 3, stride=2, padding=1))
        eighth = self.layer2(quarter)
        sixteenth = self.layer3(eighth)
        return {"half": half, "quarter": quarter, "eighth": eighth, "sixteenth": sixteenth,
                "features": self.layer4(sixteenth)}


# ------------------------------------------------------------- SuperPoint
class SuperPoint(ResNet50Trunk):
    """Detector and descriptor heads over the image trunk (descriptor_dim
    128). forward: image (B, 3, H, W) -> (scores (B, H/8*8, W/8*8),
    descriptors (B, 128, H/8, W/8), skips)."""

    def __init__(self, descriptor_dim: int = 128):
        super().__init__(3, 64)
        self.convPa, self.bnPa = _conv(2048, 256, 3, bias=True), _bn(256)
        self.convPb, self.bnPb = _conv(256, 128, 3, bias=True), _bn(128)
        self.convPc = _conv(128, 65, 1, bias=True)
        self.convDa, self.bnDa = _conv(2048, 128, 3, bias=True), _bn(128)
        self.convDb, self.bnDb = _conv(640, 256, 1, bias=True), _bn(256)
        self.convDc, self.bnDc = _conv(256, 256, 3, bias=True), _bn(256)
        self.convDd = _conv(576, descriptor_dim, 1, bias=True)

    def forward(self, image):
        H, W = image.shape[-2:]
        h8, w8 = H // 8, W // 8
        skips = self.trunk(image)
        x = skips["features"]

        def resize(t):
            return resize_bilinear_align_corners(t, h8, w8, align_corners=False)

        # detector: convPa at 1/32 -> 1/8, convPb, convPc; dustbin dropped,
        # then depth-to-space of the 64 cells
        cPa = resize(F.relu(self.bnPa(self.convPa(x))))
        logits = self.convPc(F.relu(self.bnPb(self.convPb(cPa))))
        scores = F.pixel_shuffle(F.softmax(logits, dim=1)[:, :64], 8)[:, 0]

        # descriptor: convDa at 1/32 -> 1/8, concat skip_eighth, convDb,
        # convDc, concat the quarter and half skips resized to 1/8, convDd
        cDa = resize(F.relu(self.bnDa(self.convDa(x))))
        cDa = torch.cat([cDa, skips["eighth"]], dim=1)
        cDa = F.relu(self.bnDb(self.convDb(cDa)))
        cDa = F.relu(self.bnDc(self.convDc(cDa)))
        cDa = torch.cat([cDa, resize(skips["quarter"]), resize(skips["half"])], dim=1)
        desc = self.convDd(cDa)
        desc = desc / (torch.linalg.vector_norm(desc, dim=1, keepdim=True) + 1e-8)
        return scores, desc, skips


def simple_nms(scores, radius: int, iterations: int = 2):
    """Max-pool NMS with the reference's iterative refinement: after the
    local-max mask, re-detect maxima among the unsuppressed pixels
    ``iterations`` times. scores (B, H, W)."""
    k = 2 * radius + 1

    def max_pool(x):
        return F.max_pool2d(x[:, None], k, stride=1, padding=radius)[:, 0]

    max_mask = scores == max_pool(scores)
    for _ in range(iterations):
        supp_mask = max_pool(max_mask.to(scores.dtype)) > 0
        supp_scores = torch.where(supp_mask, 0.0, scores)
        new_max_mask = supp_scores == max_pool(supp_scores)
        max_mask = max_mask | (new_max_mask & ~supp_mask)
    return torch.where(max_mask, scores, 0.0)


def top_k_keypoints(scores, k: int, border: int):
    """(B, H, W) scores -> ((B, k, 2) xy keypoints, (B, k) scores): the k
    largest inside the border, ties to the lower flat index (a stable
    descending sort, as ``lax.top_k``)."""
    B, H, W = scores.shape
    ys = torch.arange(H, device=scores.device)[:, None]
    xs = torch.arange(W, device=scores.device)[None, :]
    valid = (xs >= border) & (xs < W - border) & (ys >= border) & (ys < H - border)
    flat = torch.where(valid[None], scores, -1.0).reshape(B, H * W)
    vals, idx = torch.sort(flat, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    kp = torch.stack([(idx % W).to(torch.float32), (idx // W).to(torch.float32)], dim=-1)
    return kp, vals


def sample_descriptors(points, desc, stride: int = 8, normalize: bool = True):
    """Bilinear descriptors at pixel locations points (B, N, 2) from desc
    (B, C, h, w), align_corners=False -> (B, N, C)."""
    B, C, h, w = desc.shape
    kp = points - stride / 2 + 0.5
    gx = kp[..., 0] / (w * stride - stride / 2 - 0.5) * 2 - 1
    gy = kp[..., 1] / (h * stride - stride / 2 - 0.5) * 2 - 1
    grid = torch.stack([gx, gy], dim=-1)[:, :, None, :]  # (B, N, 1, 2)
    out = grid_sample(desc, grid, mode="bilinear", align_corners=False)[:, :, :, 0]
    out = out.transpose(1, 2)
    if normalize:
        out = out / (torch.linalg.vector_norm(out, dim=-1, keepdim=True) + 1e-8)
    return out


# ----------------------------------------------------- epipolar triangulation
def fundamental_matrix(rel_pose, K):
    """F = K^-T [t]x R K^-1, divided by F[2, 2] (rel_pose (B, 4, 4):
    measurement <- reference). ``inv_ex``: ``inv`` checks its result on the
    host, which a capture cannot do; the inverse is the same."""
    Kinv = torch.linalg.inv_ex(K).inverse
    R, t = rel_pose[:, :3, :3], rel_pose[:, :3, 3]
    zero = torch.zeros_like(t[:, 0])
    t_skew = torch.stack([zero, -t[:, 2], t[:, 1],
                          t[:, 2], zero, -t[:, 0],
                          -t[:, 1], t[:, 0], zero], dim=1).reshape(-1, 3, 3)
    F_ = Kinv.transpose(1, 2) @ (t_skew @ R) @ Kinv
    f22 = F_[:, 2:, 2:]
    return F_ / torch.where(f22 == 0.0, 1.0, f22)


def reproject_at_depth(keypoints, rel_pose, K, depth: float):
    """K R K^-1 uv + K t / Z, divided by the third coordinate: keypoints
    (B, N, 2) -> (B, N, 2)."""
    uv1 = torch.cat([keypoints, torch.ones_like(keypoints[..., :1])], dim=-1)
    A = K @ rel_pose[:, :3, :3] @ torch.linalg.inv_ex(K).inverse
    Kt = (K @ rel_pose[:, :3, 3:4])[..., 0]  # (B, 3)
    proj = torch.einsum("bij,bnj->bni", A, uv1) + Kt[:, None] / depth
    return proj[..., :2] / proj[..., 2:3]


def epipolar_roi(keypoints, rel_pose, K, height: int, width: int, min_depth: float,
                 max_depth: float):
    """Rotated search box of each keypoint: the reprojections at the minimum
    and maximum depth ordered by x, zeroed unless both lie in the image
    (align_corners=False bounds). Returns (xc, yc, w, theta), theta =
    atan2(-a, b) of the epiline (a, b, c)."""
    F_ = fundamental_matrix(rel_pose, K)
    uv1 = torch.cat([keypoints, torch.ones_like(keypoints[..., :1])], dim=-1)
    lines = torch.einsum("bij,bnj->bni", F_, uv1)
    theta = torch.atan2(-lines[..., 0], lines[..., 1])

    p2 = reproject_at_depth(keypoints, rel_pose, K, min_depth)
    p3 = reproject_at_depth(keypoints, rel_pose, K, max_depth)
    swap = (p2[..., 0] > p3[..., 0])[..., None]
    lo, hi = torch.where(swap, p3, p2), torch.where(swap, p2, p3)

    def in_bounds(p):
        return ((p[..., 0] >= -0.5) & (p[..., 0] < width - 0.5)
                & (p[..., 1] >= -0.5) & (p[..., 1] < height - 0.5))

    valid = (in_bounds(lo) & in_bounds(hi))[..., None]
    lo, hi = torch.where(valid, lo, 0.0), torch.where(valid, hi, 0.0)
    xc = (lo[..., 0] + hi[..., 0]) / 2.0
    yc = (lo[..., 1] + hi[..., 1]) / 2.0
    w = torch.sqrt(((hi - lo) ** 2).sum(dim=-1))
    return xc, yc, w, theta


def roi_patch_coords(xc, yc, w, theta, out_length: int, distance: int):
    """Sample grid of the rotated ROI: out_length steps of w * linspace(-.5,
    .5) along the segment by rows linspace(-distance, distance) across it,
    rotated by theta about (xc, yc). Returns (..., R, S, 2)."""
    R = 2 * distance + 1
    sx = torch.linspace(-0.5, 0.5, out_length, device=w.device)
    sy = torch.linspace(-float(distance), float(distance), R, device=w.device)
    gx = (w[..., None, None] * sx).expand(w.shape + (R, out_length))
    gy = sy[:, None].expand(w.shape + (R, out_length))
    cos, sin = torch.cos(theta)[..., None, None], torch.sin(theta)[..., None, None]
    u = xc[..., None, None] + cos * gx - sin * gy
    v = yc[..., None, None] + sin * gx + cos * gy
    return torch.stack([u, v], dim=-1)


def soft_argmax_2d(heatmap):
    """Softmax over the flattened map, expected (x, y): heatmap (..., R, S)."""
    shape = heatmap.shape
    m = F.softmax(heatmap.reshape(shape[:-2] + (-1,)), dim=-1).reshape(shape)
    xs = torch.arange(shape[-1], dtype=heatmap.dtype, device=heatmap.device)
    ys = torch.arange(shape[-2], dtype=heatmap.dtype, device=heatmap.device)
    return (m.sum(dim=-2) * xs).sum(dim=-1), (m.sum(dim=-1) * ys).sum(dim=-1)


def dlt_system(proj_matrices, points, confidences):
    """The confidence-weighted DLT system of each keypoint: proj_matrices
    (B, V, 3, 4); points (B, Kn, V, 2); confidences (B, Kn, V) -> (B, Kn,
    2V, 4)."""
    B, Kn, V = points.shape[:3]
    A = points[..., None] * proj_matrices[:, None, :, 2:3]  # (B, Kn, V, 2, 4)
    A = (A - proj_matrices[:, None, :, :2]) * confidences[..., None, None]
    return A.reshape(B, Kn, 2 * V, 4)


def dlt_solve(A):
    """The right singular vectors (B, Kn, 4, 4) of the DLT systems
    (``ops/dlt.py``): on the card the kernel ``csrc/dlt_solve.cu``, which
    syncs nothing with the host, so DELTAS's forward is one CUDA graph; on
    the CPU ``torch.linalg.svd``."""
    return dlt.dlt_solve(A)


def dlt_points(Vh):
    """The least-squares points (B, Kn, 3) from the singular vectors: the
    homogeneous solution divided by its own last coordinate, so the SVD's
    sign does not matter."""
    hom = -Vh[..., 3, :]
    return hom[..., :3] / (hom[..., 3:4] + 1e-12)


def triangulate_dlt(proj_matrices, points, confidences):
    """Confidence-weighted multi-view linear triangulation. proj_matrices
    (B, V, 3, 4); points (B, Kn, V, 2); confidences (B, Kn, V). Returns
    (B, Kn, 3)."""
    return dlt_points(dlt_solve(dlt_system(proj_matrices, points, confidences)))


class TriangulationNet(nn.Module):
    """Rotated-ROI epipolar matching + DLT (dist_ortogonal 1, kernel_size 1,
    out_length 100). Its only parameters are the match map's BatchNorm."""

    def __init__(self, out_length: int = OUT_LENGTH, distance: int = DIST_ORTHO,
                 min_depth: float = MIN_DEPTH, max_depth: float = MAX_DEPTH):
        super().__init__()
        self.out_length, self.distance = out_length, distance
        self.min_depth, self.max_depth = min_depth, max_depth
        self.bn_match_convD = _bn(1)

    def forward(self, keypoints, kp_scores, ref_desc_at_kp, meas_descs, rel_poses, K,
                height: int, width: int, view_mask=None):
        """keypoints (B, Kn, 2); ref_desc_at_kp (B, Kn, C); meas_descs (B, V, C,
        h8, w8); rel_poses (B, V, 4, 4) measurement <- reference. Returns
        (points3d (B, Kn, 3), range_mask (B, Kn))."""
        A, range_mask = self.system(keypoints, kp_scores, ref_desc_at_kp, meas_descs, rel_poses,
                                    K, height, width, view_mask)
        return dlt_points(dlt_solve(A)), range_mask

    def system(self, keypoints, kp_scores, ref_desc_at_kp, meas_descs, rel_poses, K,
               height: int, width: int, view_mask=None):
        """``forward`` up to the DLT: (the systems (B, Kn, 2(V+1), 4),
        range_mask (B, Kn))."""
        B, Kn = keypoints.shape[:2]
        V = meas_descs.shape[1]
        R, S = 2 * self.distance + 1, self.out_length

        matched, confs, widths = [], [], []
        for v in range(V):
            rel = rel_poses[:, v]
            xc, yc, w, theta = epipolar_roi(keypoints, rel, K, height, width, self.min_depth,
                                            self.max_depth)
            coords = roi_patch_coords(xc, yc, w, theta, S, self.distance)  # (B, Kn, R, S, 2)
            cand = sample_descriptors(coords.reshape(B, Kn * R * S, 2), meas_descs[:, v])
            cand = cand.reshape(B, Kn, R, S, -1)
            match = torch.einsum("bkc,bkrsc->bkrs", ref_desc_at_kp, cand)
            match = F.relu(self.bn_match_convD(match.reshape(B * Kn, 1, R, S)))
            match = match.reshape(B, Kn, R, S)

            # confidence: sigmoid of the match map's global max, gated by a
            # non-degenerate segment (+0.001 as the reference)
            gated = (w > 0).to(match.dtype)
            c = torch.sigmoid(match.reshape(B, Kn, -1).amax(dim=-1)) * (gated + 0.001)
            if view_mask is not None:
                c = c * view_mask[:, v][:, None]

            # 2-D soft-argmax in patch coordinates -> through the ROI transform
            mx, my = soft_argmax_2d(match)
            px = (mx / (S - 1.0) - 0.5) * w   # along the segment, scaled by its length
            py = (my / max(R - 1.0, 1.0) - 0.5) * gated  # zero for a null segment
            cos, sin = torch.cos(theta), torch.sin(theta)
            matched.append(torch.stack([xc + cos * px - sin * py, yc + sin * px + cos * py],
                                       dim=-1))
            confs.append(c)
            widths.append(w)

        eye34 = torch.eye(3, 4, dtype=K.dtype, device=K.device)
        projs = torch.stack([K @ eye34] + [K @ rel_poses[:, v, :3, :] for v in range(V)], dim=1)
        all_pts = torch.stack([keypoints] + matched, dim=2)                    # (B, Kn, V+1, 2)
        all_conf = torch.stack([torch.ones_like(kp_scores)] + confs, dim=2)   # (B, Kn, V+1)
        # a keypoint is usable if any view had a real segment
        range_mask = (torch.stack(widths, dim=-1) > 0).any(dim=-1)
        return dlt_system(projs, all_pts, all_conf), range_mask


# ------------------------------------------------------------ densification
class GudiUpProjCat(nn.Module):
    """Gudi up-projection with skip concatenation: zero-stuffed 2x unpool
    (a nearest resize when the skip's height is not a multiple of the
    input's), 5x5 conv, concat the skip, 3x3 + 3x3 convs, 5x5 shortcut from
    the upsampled input, BatchNorm everywhere."""

    def __init__(self, in_channels: int, skip_channels: int, features: int):
        super().__init__()
        self.conv1, self.bn1 = _conv(in_channels, features, 5), _bn(features)
        self.conv1_1 = _conv(features + skip_channels, features, 3)
        self.bn1_1 = _bn(features)
        self.conv2, self.bn2 = _conv(features, features, 3), _bn(features)
        self.sc_conv1, self.sc_bn1 = _conv(in_channels, features, 5), _bn(features)

    def forward(self, x, skip):
        out_h, out_w = skip.shape[-2:]
        if out_h % x.shape[-2] == 0:
            x = unpool_zero(x, out_h, out_w)
        else:
            x = nearest_resize_torch(x, out_h, out_w)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn1_1(self.conv1_1(torch.cat([y, skip], dim=1))))
        y = self.bn2(self.conv2(y))
        return F.relu(y + self.sc_bn1(self.sc_conv1(x)))


class GudiUpProjSimple(nn.Module):
    """Skip-less Gudi up-projection."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.conv1, self.bn1 = _conv(in_channels, features, 5), _bn(features)
        self.conv2, self.bn2 = _conv(features, features, 3), _bn(features)
        self.sc_conv1, self.sc_bn1 = _conv(in_channels, features, 5), _bn(features)

    def forward(self, x, out_h: int, out_w: int):
        x = unpool_zero(x, out_h, out_w)
        y = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        return F.relu(y + self.sc_bn1(self.sc_conv1(x)))


class DilatedConv3x3(nn.Module):
    """1x1 reduce + dilated 3x3, BatchNorm and ReLU after each."""

    def __init__(self, in_channels: int, features: int, rate: int):
        super().__init__()
        self.conv1, self.bn1 = _conv(in_channels, features, 1), _bn(features)
        self.conv2, self.bn2 = _conv(features, features, 3, dilation=rate), _bn(features)

    def forward(self, x):
        return F.relu(self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x))))))


class ASPP(nn.Module):
    """Dense-cascade atrous pyramid: five dilated stages (rates 3/6/12/18/24),
    each fed the running concatenation and emitting features/2; the input
    and all five concatenated -> 3x3 convf + bnf + ReLU."""

    def __init__(self, in_channels: int, features: int = 256):
        super().__init__()
        half = features // 2
        for i, rate in enumerate((3, 6, 12, 18, 24)):
            setattr(self, f"daspp_{i + 1}", DilatedConv3x3(in_channels + i * half, half, rate))
        self.convf = _conv(in_channels + 5 * half, features, 3)
        self.bnf = _bn(features)

    def forward(self, x):
        x_inp, outs = x, []
        for i in range(1, 6):
            y = getattr(self, f"daspp_{i}")(x)
            outs.append(y)
            x = torch.cat([x, y], dim=1)
        return F.relu(self.bnf(self.convf(torch.cat([x_inp] + outs, dim=1))))


class SparseToDenseNet(ResNet50Trunk):
    """The narrow sparse-depth trunk + image-skip concatenation + Gudi
    decoder with dense ASPP at 1/8 and multiscale heads. Skips concatenate
    the sparse trunk first, the bottleneck the image features first; the
    final conv emits raw depth (no output activation)."""

    def __init__(self, min_depth: float = MIN_DEPTH, max_depth: float = MAX_DEPTH):
        super().__init__(1, 16)
        self.min_depth, self.max_depth = min_depth, max_depth
        self.gud_up_proj_layer1 = GudiUpProjCat(2048 + 512, 256 + 1024, 512)
        self.gud_up_proj_layer2 = GudiUpProjCat(512, 128 + 512, 256)
        self.ASPP = ASPP(256, 256)
        self.conv_scale8 = _conv(256, 1, 1, bias=True)
        self.gud_up_proj_layer3 = GudiUpProjCat(256, 64 + 256, 128)
        self.conv_scale4 = _conv(128, 1, 1, bias=True)
        self.gud_up_proj_layer4 = GudiUpProjCat(128, 16 + 64, 64)
        self.conv_scale2 = _conv(64, 1, 1, bias=True)
        self.gud_up_proj_layer5 = GudiUpProjSimple(64, 32)
        self.conv_final = _conv(32, 1, 3, bias=True)

    def forward(self, sparse_depth, sparse_mask, image_skips):
        """sparse_depth (B, H, W) (``sparse_mask`` unused, as in the
        reference) -> (depth (B, H, W), [out2, out4, out8])."""
        H, W = sparse_depth.shape[-2:]
        d = self.trunk(sparse_depth[:, None])

        def cat(name):
            return torch.cat([d[name], image_skips[name]], dim=1)

        x = torch.cat([image_skips["features"], d["features"]], dim=1)
        x = self.gud_up_proj_layer1(x, cat("sixteenth"))
        x = self.ASPP(self.gud_up_proj_layer2(x, cat("eighth")))
        out8 = self.conv_scale8(x)[:, 0]
        x = self.gud_up_proj_layer3(x, cat("quarter"))
        out4 = self.conv_scale4(x)[:, 0]
        x = self.gud_up_proj_layer4(x, cat("half"))
        out2 = self.conv_scale2(x)[:, 0]
        out = self.conv_final(self.gud_up_proj_layer5(x, H, W))[:, 0]
        return out, [out2, out4, out8]


# ------------------------------------------------------------------ model
class DeltasModel(nn.Module):
    def __init__(self, n_keypoints: int = N_KEYPOINTS, nms_radius: int = NMS_RADIUS):
        super().__init__()
        self.n_keypoints, self.nms_radius = n_keypoints, nms_radius
        self.superpoint = SuperPoint()
        self.triangulation = TriangulationNet()
        self.sparse_to_dense = SparseToDenseNet()

    def stages(self, ref_image, meas_images, rel_poses, K, view_mask=None,
               keypoints: Optional[torch.Tensor] = None) -> dict:
        """ref_image (B, 3, H, W); meas_images (B, V, 3, H, W); rel_poses (B,
        V, 4, 4) measurement <- reference; K (B, 3, 3). Every stage's
        result: scores, keypoints, kp_scores, points3d, range_mask,
        sparse_depth, depth. ``keypoints`` (B, Kn, 2) with their scores
        replace the detector's top-k when given (to hold the later stages to
        another run's keypoints)."""
        front = self.front(ref_image, meas_images, rel_poses, K, view_mask, keypoints)
        H, W = ref_image.shape[-2:]
        back = self.back(dlt_solve(front["system"]), front["keypoints"], front["range_mask"],
                         front["image_skips"], H, W)
        return {"scores": front["scores"], "keypoints": front["keypoints"],
                "kp_scores": front["kp_scores"], "range_mask": front["range_mask"], **back}

    def front(self, ref_image, meas_images, rel_poses, K, view_mask=None,
              keypoints: Optional[torch.Tensor] = None) -> dict:
        """``stages`` up to the DLT solve: detection, description and matching
        (scores, keypoints, kp_scores, range_mask, the DLT systems as
        ``system`` and the image trunk's ``image_skips``)."""
        B, V = meas_images.shape[:2]
        H, W = ref_image.shape[-2:]
        scores, ref_desc, image_skips = self.superpoint(ref_image)
        scores = simple_nms(scores, self.nms_radius)
        if keypoints is None:
            kp, kp_scores = top_k_keypoints(scores, self.n_keypoints, BORDER)
        else:
            kp = keypoints
            kp_scores = scores[torch.arange(B, device=kp.device)[:, None], kp[..., 1].long(),
                               kp[..., 0].long()]
        ref_d = sample_descriptors(kp, ref_desc)  # (B, Kn, 128)
        meas_descs = torch.stack([self.superpoint(meas_images[:, v])[1] for v in range(V)],
                                 dim=1)
        system, range_mask = self.triangulation.system(kp, kp_scores, ref_d, meas_descs,
                                                       rel_poses, K, H, W, view_mask)
        return {"scores": scores, "keypoints": kp, "kp_scores": kp_scores, "system": system,
                "range_mask": range_mask, "image_skips": image_skips}

    def back(self, Vh, keypoints, range_mask, image_skips, height: int, width: int) -> dict:
        """``stages`` after the DLT solve: the points from the singular vectors
        ``Vh`` (``dlt_solve``), the sparse depth at the keypoints, and the
        densifier's depth (B, H, W)."""
        H, W = height, width
        B = keypoints.shape[0]
        pts3d = dlt_points(Vh)
        # impute the sparse depth: clamp to [0, max], keep range-valid
        # keypoints inside (min, max)
        dense = self.sparse_to_dense
        z = torch.clamp(pts3d[..., 2], 0.0, dense.max_depth)
        valid = range_mask & (z > dense.min_depth) & (z < dense.max_depth)
        z = z * valid
        lin = keypoints[..., 1].long() * W + keypoints[..., 0].long()
        lin = torch.where(valid, lin, H * W)  # the invalid ones land in a spare slot
        sparse_depth = z.new_zeros((B, H * W + 1)).scatter(1, lin, z)[:, :-1].reshape(B, H, W)
        sparse_mask = z.new_zeros((B, H * W + 1)).scatter(1, lin, torch.ones_like(z))
        depth, _ = dense(sparse_depth, sparse_mask[:, :-1].reshape(B, H, W), image_skips)
        return {"points3d": pts3d, "sparse_depth": sparse_depth, "depth": depth}

    def forward(self, ref_image, meas_images, rel_poses, K, view_mask=None):
        return self.stages(ref_image, meas_images, rel_poses, K, view_mask)["depth"]


@register_baseline("deltas")
class Deltas(GraphedEstimator):
    image_width = 320
    image_height = 240
    scale_rgb = 255.0
    # the reference stacks two normalisations: (x/255 - 0.5)/0.5 in the
    # preprocessing, then ImageNet statistics inside the model; folded into
    # one affine map: mean' = 0.5 + 0.5 m, std' = 0.5 s
    mean_rgb = tuple(0.5 + 0.5 * m for m in (0.485, 0.456, 0.406))
    std_rgb = tuple(0.5 * s for s in (0.229, 0.224, 0.225))

    def __init__(self, n_measurement_frames: int = 2, state_dict=None, seed: int = 0,
                 device="cuda", graphs: bool = True):
        """Runs on the card unless ``device="cpu"``; weights from a generator
        seeded with ``seed``, or ``state_dict`` (the model's keys).
        ``graphs``: ``predict`` as one CUDA graph replay on the card
        (detector and matcher up to the DLT systems, their solve by the
        ``dlt_solve`` kernel, the densifier); else eagerly.

        After a ``predict``, ``outputs`` holds its raw depth (1, H, W)
        before the clip, keypoints (1, Kn, 2) and triangulated points (1,
        Kn, 3) on the device: on the graph path the step's output buffers,
        which the next ``predict`` rewrites, so a caller copies what it
        keeps (a device copy, no host sync)."""
        self.V = n_measurement_frames
        self.model = seeded_model(DeltasModel(), seed, device, state_dict)
        self.device = next(self.model.parameters()).device
        self.outputs: Optional[dict] = None
        self._init_steps(graphs)

    def inputs(self, ref_image, meas_images, ref_pose, meas_poses, K):
        """Host frames and poses -> the model's batch-of-one device tensors
        (ref, meas, rel_poses, K, view_mask), views padded with view 0."""
        host = relative_inputs(self.V, ref_image, meas_images, ref_pose, meas_poses, K)
        return relative_views(**{k: self._fresh(v) for k, v in host.items()})

    def _body(self, **inputs):
        """The whole forward: ``front``, the DLT solve, ``back`` -> the raw
        depth, the keypoints and their points (``outputs``)."""
        height, width = inputs["ref"].shape[:2]
        front = self.model.front(*relative_views(**inputs))
        back = self.model.back(dlt_solve(front["system"]), front["keypoints"],
                               front["range_mask"], front["image_skips"], height, width)
        return {"depth": back["depth"], "keypoints": front["keypoints"],
                "points3d": back["points3d"]}

    @torch.inference_mode()
    def predict(self, ref_image, meas_images: List[np.ndarray], ref_pose, meas_poses,
                K) -> np.ndarray:
        inputs = relative_inputs(self.V, ref_image, meas_images, ref_pose, meas_poses, K)
        self.outputs = self._step("forward", self._body, inputs)
        # the reference feeds the raw output to the metrics; the consumers
        # here (TSDF, inverse-depth metrics) need positive depth, so clamp to
        # the model's range
        return np.clip(self._readback(self.outputs["depth"]), MIN_DEPTH, MAX_DEPTH)
