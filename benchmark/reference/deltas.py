"""Plain PyTorch DELTAS (Sinha et al., Depth Estimation by Learning
Triangulation And densification of Sparse points, ECCV 2020), frozen for the
benchmark, at the sizes of DeepVideoMVS's baseline (dvmvs/baselines/deltas).

One keyframe, three stages:

  1. SuperPoint over a ResNet-50 trunk (width 64): a 65-way detector head
     (softmax, dustbin dropped, depth-to-space) and a 128-d descriptor head
     over the trunk's skips, both at 1/8; iterative max-pool NMS; top-k
     keypoints inside a border; descriptors sampled at the keypoints.
  2. Triangulation: each keypoint's search box in each measurement view is
     the epipolar segment between its reprojections at the least and the
     largest depth, sampled as a rotated ROI; descriptor correlation, the
     match map's BatchNorm and ReLU, confidence sigmoid(max) gated by a
     real segment, a 2-D soft-argmax mapped back through the ROI; then
     confidence-weighted linear (DLT) triangulation.
  3. Densification: the sparse depth at the keypoints through a 1-channel
     ResNet-50 trunk (width 16), its skips concatenated with the image
     trunk's, Gudi up-projections, a dense-cascade ASPP at 1/8, and the
     final 3x3 convolution's raw depth.

The modules keep the state-dict names of the published checkpoint, which
the port keeps too (``superpoint``, ``triangulation``, ``sparse_to_dense``),
so one state dict loads into both. Nothing is fused or captured:
convolutions are ``nn.Conv2d``, BatchNorm is ``nn.BatchNorm2d`` in eval
mode, gathers are ``F.grid_sample``. Run it in float32 with TF32 off
(``loops.ieee``).

Departures from the published model, each as the JAX package makes it:

  - the keypoints are a fixed count, the ``n_keypoints`` largest NMS scores
    inside the border, ties to the lower flat index (a stable descending
    sort, as ``lax.top_k``), instead of a score threshold, a top-k and a
    random refill;
  - a keypoint whose segment leaves the image in every view keeps its
    slot, masked (``range_mask``), instead of leaving a variable-length
    list;
  - the DLT systems are solved by ``torch.linalg.svd`` in float64 (the
    published model solves them in float32), so that the reference's
    points carry no rounding of its own solve;
  - the convD_confa layers of the published triangulation net are left
    out: its inference never applies them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5


def conv(cin: int, cout: int, kernel: int, bias: bool = False, stride: int = 1,
         dilation: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=dilation * (kernel - 1) // 2,
                     dilation=dilation, bias=bias)


def bn(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=BN_EPS)


def unpool(x, out_h: int, out_w: int):
    """Zero-stuffed 2x unpool (each value at the top left of its 2x2 cell),
    cropped to (out_h, out_w)."""
    up = x.new_zeros(x.shape[:2] + (2 * x.shape[-2], 2 * x.shape[-1]))
    up[:, :, ::2, ::2] = x
    return up[:, :, :out_h, :out_w]


# --------------------------------------------------------- ResNet-50 trunk
class Bottleneck(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1, self.bn1 = conv(cin, features, 1), bn(features)
        self.conv2, self.bn2 = conv(features, features, 3, stride=stride), bn(features)
        self.conv3, self.bn3 = conv(features, 4 * features, 1), bn(4 * features)
        self.downsample = None
        if cin != 4 * features or stride != 1:
            self.downsample = nn.Sequential(conv(cin, 4 * features, 1, stride=stride),
                                            bn(4 * features))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


class Trunk(nn.Module):
    """ResNet-50's conv1 and layer1-4 ([3, 4, 6, 3] bottlenecks) of stage
    width ``width``, with the skips at 1/2, 1/4, 1/8 and 1/16."""

    def __init__(self, cin: int, width: int):
        super().__init__()
        self.conv1, self.bn1 = conv(cin, width, 7, stride=2), bn(width)
        channels = width
        for i, (blocks, stride) in enumerate(((3, 1), (4, 2), (6, 2), (3, 2))):
            features = width << i
            layer = []
            for b in range(blocks):
                layer.append(Bottleneck(channels, features, stride if b == 0 else 1))
                channels = 4 * features
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))

    def trunk(self, x) -> dict:
        half = F.relu(self.bn1(self.conv1(x)))
        quarter = self.layer1(F.max_pool2d(half, 3, stride=2, padding=1))
        eighth = self.layer2(quarter)
        sixteenth = self.layer3(eighth)
        return {"half": half, "quarter": quarter, "eighth": eighth, "sixteenth": sixteenth,
                "features": self.layer4(sixteenth)}


# ------------------------------------------------------------- SuperPoint
class SuperPoint(Trunk):
    def __init__(self, width: int, descriptor_dim: int):
        super().__init__(3, width)
        top = 32 * width
        self.convPa, self.bnPa = conv(top, 256, 3, bias=True), bn(256)
        self.convPb, self.bnPb = conv(256, 128, 3, bias=True), bn(128)
        self.convPc = conv(128, 65, 1, bias=True)
        self.convDa, self.bnDa = conv(top, 128, 3, bias=True), bn(128)
        self.convDb, self.bnDb = conv(128 + 8 * width, 256, 1, bias=True), bn(256)
        self.convDc, self.bnDc = conv(256, 256, 3, bias=True), bn(256)
        self.convDd = conv(256 + 4 * width + width, descriptor_dim, 1, bias=True)

    def forward(self, image):
        """image (B, 3, H, W) -> scores (B, H, W), unit descriptors (B, D,
        H/8, W/8), the trunk's skips."""
        h8, w8 = image.shape[-2] // 8, image.shape[-1] // 8
        skips = self.trunk(image)
        x = skips["features"]

        def at_eighth(t):
            if tuple(t.shape[-2:]) == (h8, w8):
                return t
            return F.interpolate(t, size=(h8, w8), mode="bilinear", align_corners=False)

        pa = at_eighth(F.relu(self.bnPa(self.convPa(x))))
        logits = self.convPc(F.relu(self.bnPb(self.convPb(pa))))
        scores = F.pixel_shuffle(F.softmax(logits, dim=1)[:, :64], 8)[:, 0]

        d = at_eighth(F.relu(self.bnDa(self.convDa(x))))
        d = F.relu(self.bnDb(self.convDb(torch.cat([d, skips["eighth"]], dim=1))))
        d = F.relu(self.bnDc(self.convDc(d)))
        d = self.convDd(torch.cat([d, at_eighth(skips["quarter"]), at_eighth(skips["half"])],
                                  dim=1))
        return scores, d / (torch.linalg.vector_norm(d, dim=1, keepdim=True) + 1e-8), skips


def nms(scores, radius: int, iterations: int = 2):
    """Max-pool NMS with SuperPoint's refinement: maxima among the pixels
    the kept maxima do not suppress are kept too, ``iterations`` times."""

    def max_pool(x):
        return F.max_pool2d(x[:, None], 2 * radius + 1, stride=1, padding=radius)[:, 0]

    keep = scores == max_pool(scores)
    for _ in range(iterations):
        suppressed = max_pool(keep.float()) > 0
        rest = torch.where(suppressed, torch.zeros_like(scores), scores)
        keep = keep | ((rest == max_pool(rest)) & ~suppressed)
    return torch.where(keep, scores, torch.zeros_like(scores))


def top_k(scores, k: int, border: int):
    """The k largest scores at least ``border`` pixels inside the frame, ties
    to the lower flat index: ((B, k, 2) xy, (B, k) scores)."""
    B, H, W = scores.shape
    ys = torch.arange(H, device=scores.device)[:, None]
    xs = torch.arange(W, device=scores.device)[None, :]
    inside = (xs >= border) & (xs < W - border) & (ys >= border) & (ys < H - border)
    flat = torch.where(inside, scores, torch.full_like(scores, -1.0)).reshape(B, H * W)
    values, index = torch.sort(flat, dim=1, descending=True, stable=True)
    index = index[:, :k]
    return torch.stack([index % W, index // W], dim=-1).float(), values[:, :k]


def sample_descriptors(points, desc, stride: int = 8):
    """Unit descriptors (B, N, D) at pixel positions (B, N, 2) of a 1/stride
    descriptor map, bilinear (SuperPoint's sampling)."""
    _, _, h, w = desc.shape
    p = points - stride / 2 + 0.5
    grid = torch.stack([p[..., 0] / (w * stride - stride / 2 - 0.5) * 2 - 1,
                        p[..., 1] / (h * stride - stride / 2 - 0.5) * 2 - 1], dim=-1)
    out = F.grid_sample(desc, grid[:, :, None], mode="bilinear", padding_mode="zeros",
                        align_corners=False)[..., 0].transpose(1, 2)
    return out / (torch.linalg.vector_norm(out, dim=-1, keepdim=True) + 1e-8)


# ----------------------------------------------------------- triangulation
def fundamental(rel, K):
    """F = K^-T [t]x R K^-1 over its (2, 2) entry; rel (B, 4, 4) takes the
    reference camera to the measurement camera."""
    Kinv = torch.linalg.inv(K)
    R, t = rel[:, :3, :3], rel[:, :3, 3]
    zero = torch.zeros_like(t[:, 0])
    tx = torch.stack([zero, -t[:, 2], t[:, 1], t[:, 2], zero, -t[:, 0], -t[:, 1], t[:, 0], zero],
                     dim=1).reshape(-1, 3, 3)
    Fm = Kinv.transpose(1, 2) @ (tx @ R) @ Kinv
    f22 = Fm[:, 2:, 2:]
    return Fm / torch.where(f22 == 0, torch.ones_like(f22), f22)


def reproject(points, rel, K, depth: float):
    """Pixels (B, N, 2) of the reference at ``depth`` in the measurement."""
    uv1 = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    A = K @ rel[:, :3, :3] @ torch.linalg.inv(K)
    p = torch.einsum("bij,bnj->bni", A, uv1) + (K @ rel[:, :3, 3:4])[..., 0][:, None] / depth
    return p[..., :2] / p[..., 2:3]


class Triangulation(nn.Module):
    def __init__(self, out_length: int, dist_ortho: int, min_depth: float, max_depth: float):
        super().__init__()
        self.out_length, self.dist_ortho = out_length, dist_ortho
        self.min_depth, self.max_depth = min_depth, max_depth
        self.bn_match_convD = bn(1)

    def match(self, points, ref_desc, meas_desc, rel, K, H: int, W: int, mask):
        """One measurement view: (matched pixels (B, N, 2), confidences (B,
        N), segment lengths (B, N))."""
        B, N = points.shape[:2]
        R, S = 2 * self.dist_ortho + 1, self.out_length
        uv1 = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
        line = torch.einsum("bij,bnj->bni", fundamental(rel, K), uv1)
        theta = torch.atan2(-line[..., 0], line[..., 1])
        near = reproject(points, rel, K, self.min_depth)
        far = reproject(points, rel, K, self.max_depth)
        swap = (near[..., 0] > far[..., 0])[..., None]
        lo, hi = torch.where(swap, far, near), torch.where(swap, near, far)

        def inside(p):
            return (p[..., 0] >= -0.5) & (p[..., 0] < W - 0.5) & (p[..., 1] >= -0.5) & (
                p[..., 1] < H - 0.5)

        real = (inside(lo) & inside(hi))[..., None]
        lo, hi = torch.where(real, lo, torch.zeros_like(lo)), torch.where(real, hi,
                                                                          torch.zeros_like(hi))
        xc, yc = (lo[..., 0] + hi[..., 0]) / 2, (lo[..., 1] + hi[..., 1]) / 2
        length = torch.sqrt(((hi - lo) ** 2).sum(-1))
        cos, sin = torch.cos(theta), torch.sin(theta)

        # the rotated ROI: S steps along the segment by R rows across it
        along = length[..., None, None] * torch.linspace(-0.5, 0.5, S, device=points.device)
        across = torch.linspace(-float(self.dist_ortho), float(self.dist_ortho), R,
                                device=points.device)[:, None]
        along, across = along.expand(B, N, R, S), across.expand(B, N, R, S)
        u = xc[..., None, None] + cos[..., None, None] * along - sin[..., None, None] * across
        v = yc[..., None, None] + sin[..., None, None] * along + cos[..., None, None] * across
        cand = sample_descriptors(torch.stack([u, v], dim=-1).reshape(B, N * R * S, 2), meas_desc)
        corr = torch.einsum("bnc,bnrsc->bnrs", ref_desc, cand.reshape(B, N, R, S, -1))
        corr = F.relu(self.bn_match_convD(corr.reshape(B * N, 1, R, S))).reshape(B, N, R, S)

        gate = (length > 0).float()
        conf = torch.sigmoid(corr.reshape(B, N, -1).amax(-1)) * (gate + 0.001) * mask[:, None]
        prob = F.softmax(corr.reshape(B, N, -1), dim=-1).reshape(B, N, R, S)
        mx = (prob.sum(-2) * torch.arange(S, device=points.device, dtype=prob.dtype)).sum(-1)
        my = (prob.sum(-1) * torch.arange(R, device=points.device, dtype=prob.dtype)).sum(-1)
        px = (mx / (S - 1.0) - 0.5) * length
        py = (my / max(R - 1.0, 1.0) - 0.5) * gate
        matched = torch.stack([xc + cos * px - sin * py, yc + sin * px + cos * py], dim=-1)
        return matched, conf, length


def dlt(projections, points, confidences):
    """Confidence-weighted linear triangulation, solved in float64:
    projections (B, V, 3, 4), points (B, N, V, 2), confidences (B, N, V) ->
    points (B, N, 3) in float64."""
    B, N, V = points.shape[:3]
    A = points[..., None] * projections[:, None, :, 2:3] - projections[:, None, :, :2]
    A = (A * confidences[..., None, None]).reshape(B, N, 2 * V, 4)
    homogeneous = torch.linalg.svd(A.double(), full_matrices=False)[2][..., -1, :]
    return homogeneous[..., :3] / (homogeneous[..., 3:] + 1e-12)


# ------------------------------------------------------------ densification
class GudiUpProjCat(nn.Module):
    def __init__(self, cin: int, skip: int, features: int):
        super().__init__()
        self.conv1, self.bn1 = conv(cin, features, 5), bn(features)
        self.conv1_1, self.bn1_1 = conv(features + skip, features, 3), bn(features)
        self.conv2, self.bn2 = conv(features, features, 3), bn(features)
        self.sc_conv1, self.sc_bn1 = conv(cin, features, 5), bn(features)

    def forward(self, x, skip):
        """Up to the skip's size: unpooled where its height is a multiple of
        the input's, else a nearest resize."""
        out_h, out_w = skip.shape[-2:]
        if out_h % x.shape[-2] == 0:
            x = unpool(x, out_h, out_w)
        else:
            x = F.interpolate(x, size=(out_h, out_w), mode="nearest")
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn1_1(self.conv1_1(torch.cat([y, skip], dim=1))))
        return F.relu(self.bn2(self.conv2(y)) + self.sc_bn1(self.sc_conv1(x)))


class GudiUpProjSimple(nn.Module):
    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv1, self.bn1 = conv(cin, features, 5), bn(features)
        self.conv2, self.bn2 = conv(features, features, 3), bn(features)
        self.sc_conv1, self.sc_bn1 = conv(cin, features, 5), bn(features)

    def forward(self, x, out_h: int, out_w: int):
        x = unpool(x, out_h, out_w)
        y = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        return F.relu(y + self.sc_bn1(self.sc_conv1(x)))


class DilatedConv(nn.Module):
    def __init__(self, cin: int, features: int, rate: int):
        super().__init__()
        self.conv1, self.bn1 = conv(cin, features, 1), bn(features)
        self.conv2, self.bn2 = conv(features, features, 3, dilation=rate), bn(features)

    def forward(self, x):
        return F.relu(self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x))))))


class ASPP(nn.Module):
    """Dense cascade: each of five dilated stages reads the input and every
    earlier stage's output."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        half = features // 2
        for i, rate in enumerate((3, 6, 12, 18, 24)):
            setattr(self, f"daspp_{i + 1}", DilatedConv(cin + i * half, half, rate))
        self.convf, self.bnf = conv(cin + 5 * half, features, 3), bn(features)

    def forward(self, x):
        stack = x
        for i in range(1, 6):
            stack = torch.cat([stack, getattr(self, f"daspp_{i}")(stack)], dim=1)
        return F.relu(self.bnf(self.convf(stack)))


class SparseToDense(Trunk):
    def __init__(self, width: int, image_width: int):
        super().__init__(1, width)
        d, w = width, image_width
        self.gud_up_proj_layer1 = GudiUpProjCat(32 * w + 32 * d, 16 * d + 16 * w, 512)
        self.gud_up_proj_layer2 = GudiUpProjCat(512, 8 * d + 8 * w, 256)
        self.ASPP = ASPP(256, 256)
        self.conv_scale8 = conv(256, 1, 1, bias=True)
        self.gud_up_proj_layer3 = GudiUpProjCat(256, 4 * d + 4 * w, 128)
        self.conv_scale4 = conv(128, 1, 1, bias=True)
        self.gud_up_proj_layer4 = GudiUpProjCat(128, d + w, 64)
        self.conv_scale2 = conv(64, 1, 1, bias=True)
        self.gud_up_proj_layer5 = GudiUpProjSimple(64, 32)
        self.conv_final = conv(32, 1, 3, bias=True)

    def forward(self, sparse_depth, image_skips):
        """(B, H, W) sparse depth and the image trunk's skips -> raw depth
        (B, H, W). (The 1/2, 1/4 and 1/8 heads are the published model's
        training outputs.)"""
        H, W = sparse_depth.shape[-2:]
        s = self.trunk(sparse_depth[:, None])

        def skip(name):
            return torch.cat([s[name], image_skips[name]], dim=1)

        x = self.gud_up_proj_layer1(torch.cat([image_skips["features"], s["features"]], dim=1),
                                    skip("sixteenth"))
        x = self.ASPP(self.gud_up_proj_layer2(x, skip("eighth")))
        x = self.gud_up_proj_layer3(x, skip("quarter"))
        x = self.gud_up_proj_layer4(x, skip("half"))
        return self.conv_final(self.gud_up_proj_layer5(x, H, W))[:, 0]


# ------------------------------------------------------------------- model
class Deltas(nn.Module):
    def __init__(self, sizes: dict):
        super().__init__()
        self.sizes = dict(sizes)
        self.superpoint = SuperPoint(sizes["image_trunk_width"], sizes["descriptor_dim"])
        self.triangulation = Triangulation(sizes["out_length"], sizes["dist_ortho"],
                                           sizes["min_depth"], sizes["max_depth"])
        self.sparse_to_dense = SparseToDense(sizes["densifier_width"],
                                             sizes["image_trunk_width"])

    @torch.no_grad()
    def stages(self, ref, meas, rel, K, mask, keypoints: Optional[torch.Tensor] = None) -> dict:
        """ref (B, 3, H, W); meas (B, V, 3, H, W); rel (B, V, 4, 4), each
        taking the reference camera to a measurement camera; K (B, 3, 3);
        mask (B, V), 0 for a view that only pads. ``keypoints`` (B, N, 2)
        replace the detector's top-k when given. Returns scores (after NMS),
        keypoints, range_mask, points3d (float64), sparse_depth and depth."""
        sizes = self.sizes
        B, V = meas.shape[:2]
        H, W = ref.shape[-2:]
        scores, desc, skips = self.superpoint(ref)
        scores = nms(scores, sizes["nms_radius"])
        if keypoints is None:
            keypoints, _ = top_k(scores, sizes["n_keypoints"], sizes["border"])
        ref_desc = sample_descriptors(keypoints, desc)
        views, confs, lengths = [keypoints], [torch.ones_like(keypoints[..., 0])], []
        for v in range(V):
            m, c, length = self.triangulation.match(keypoints, ref_desc,
                                                    self.superpoint(meas[:, v])[1], rel[:, v], K,
                                                    H, W, mask[:, v])
            views.append(m)
            confs.append(c)
            lengths.append(length)
        eye = torch.eye(3, 4, dtype=K.dtype, device=K.device)
        projections = torch.stack([K @ eye] + [K @ rel[:, v, :3] for v in range(V)], dim=1)
        points = dlt(projections, torch.stack(views, dim=2), torch.stack(confs, dim=2))
        range_mask = (torch.stack(lengths, dim=-1) > 0).any(-1)

        # the sparse depth: each range-valid keypoint whose depth lies
        # strictly between the least and the largest depth, at its pixel
        lo, hi = sizes["min_depth"], sizes["max_depth"]
        z = points[..., 2].float().clamp(0.0, hi)
        valid = range_mask & (z > lo) & (z < hi)
        z = z * valid
        flat = keypoints[..., 1].long() * W + keypoints[..., 0].long()
        flat = torch.where(valid, flat, torch.full_like(flat, H * W))
        sparse = z.new_zeros((B, H * W + 1)).scatter(1, flat, z)[:, :-1].reshape(B, H, W)
        depth = self.sparse_to_dense(sparse, skips)
        return {"scores": scores, "keypoints": keypoints, "range_mask": range_mask,
                "points3d": points, "sparse_depth": sparse, "depth": depth}


def build(sizes: dict) -> Deltas:
    return Deltas(sizes)
