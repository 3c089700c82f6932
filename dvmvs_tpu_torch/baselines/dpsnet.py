"""DPSNet baseline (counterpart of dvmvs_tpu/baselines/dpsnet.py; reference:
dvmvs/baselines/dpsnet/dpsnet.py).

SPP feature extractor (ResNet basic blocks + four pooled branches) at 1/4
resolution; a concatenation cost volume (reference features beside the
measurement features warped to each of ``nlabel`` depths, depth_i =
mindepth * nlabel / (i + 1e-16)); a 3-D residual hourglass and classifier
per measurement view, masked-mean over the views; a dilated 2-D context
network refining each label slice; bilinear upsampling (half-pixel, as
``jax.image.resize``), softmax and soft-argmin over the labels, depth =
mindepth * nlabel / disparity. Stock PyTorch operations throughout (cuDNN's
``conv3d`` on the card); the labels are folded into the batch instead of a
loop. On the card ``predict`` is one CUDA graph replay (the JAX package's
one jit). The state-dict names are the reference's whole-model file
(``feature_extraction.*``, ``dres0.*``, ``classify.*``, ``convs.*``).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dvmvs_tpu_torch.baselines.registry import register_baseline
from dvmvs_tpu_torch.baselines.steps import GraphedEstimator, relative_inputs, relative_views
from dvmvs_tpu_torch.models.layers import (
    BN_EPS,
    BN_MOMENTUM,
    BatchNorm2d,
    BatchNorm3d,
    seeded_model,
)
from dvmvs_tpu_torch.ops.sampling import grid_sample, resize_bilinear_align_corners

SPP_POOLS = (32, 16, 8, 4)  # branch1..branch4


def convbn(in_channels: int, features: int, kernel: int, stride: int = 1, dilation: int = 1):
    pad = dilation if dilation > 1 else (kernel - 1) // 2
    return nn.Sequential(
        nn.Conv2d(in_channels, features, kernel, stride=stride, padding=pad, dilation=dilation,
                  bias=False),
        BatchNorm2d(features, eps=BN_EPS, momentum=BN_MOMENTUM))


def convbn_3d(in_channels: int, features: int):
    return nn.Sequential(nn.Conv3d(in_channels, features, 3, padding=1, bias=False),
                         BatchNorm3d(features, eps=BN_EPS, momentum=BN_MOMENTUM))


class BasicBlock(nn.Module):
    """conv1 = Sequential(convbn, ReLU), conv2 = convbn, optional downsample
    = Sequential(Conv, BN); no ReLU after the sum."""

    def __init__(self, in_channels: int, planes: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Sequential(convbn(in_channels, planes, 3, stride, dilation),
                                   nn.ReLU(inplace=True))
        self.conv2 = convbn(planes, planes, 3, 1, dilation)
        self.downsample = nn.Sequential(
            nn.Conv2d(in_channels, planes, 1, stride=stride, bias=False),
            BatchNorm2d(planes, eps=BN_EPS, momentum=BN_MOMENTUM)) if downsample else None

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        return out + (x if self.downsample is None else self.downsample(x))


def _layer(in_channels, planes, blocks, stride=1, dilation=1):
    down = stride != 1 or in_channels != planes
    return nn.Sequential(BasicBlock(in_channels, planes, stride, dilation, down),
                         *[BasicBlock(planes, planes, 1, dilation) for _ in range(blocks - 1)])


class SPPFeatures(nn.Module):
    """DPSNet's feature_extraction: 32-channel features at 1/4 resolution."""

    def __init__(self):
        super().__init__()
        self.firstconv = nn.Sequential(
            convbn(3, 32, 3, 2), nn.ReLU(inplace=True), convbn(32, 32, 3),
            nn.ReLU(inplace=True), convbn(32, 32, 3), nn.ReLU(inplace=True))
        self.layer1 = _layer(32, 32, 3)
        self.layer2 = _layer(32, 64, 16, stride=2)
        self.layer3 = _layer(64, 128, 3)
        self.layer4 = _layer(128, 128, 3, dilation=2)
        for i, pool in enumerate(SPP_POOLS):
            setattr(self, f"branch{i + 1}", nn.Sequential(
                nn.AvgPool2d(pool, stride=pool), convbn(128, 32, 1), nn.ReLU(inplace=True)))
        self.lastconv = nn.Sequential(convbn(320, 128, 3), nn.ReLU(inplace=True),
                                      nn.Conv2d(128, 32, 1, bias=False))

    def forward(self, image):
        """(B, 3, H, W) -> (B, 32, H/4, W/4); H and W of at least 128."""
        raw = self.layer2(self.layer1(self.firstconv(image)))
        skip = self.layer4(self.layer3(raw))
        H, W = skip.shape[-2:]
        branches = [resize_bilinear_align_corners(getattr(self, f"branch{i}")(skip), H, W,
                                                  align_corners=False) for i in (4, 3, 2, 1)]
        return self.lastconv(torch.cat([raw, skip] + branches, dim=1))


def inverse_warp(feat, depth, rel_pose34, K):
    """The reference's inverse_warp: feat (B, C, h, w), depth (B, h, w),
    rel_pose34 (B, 3, 4) target <- reference, K (B, 3, 3) at the feature
    size. Camera z clamped at 1e-3, (size - 1) normalisers, coordinates out
    of [-1, 1] pushed to 2 before zeros-padded align_corners sampling."""
    B, C, h, w = feat.shape
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=feat.device),
                            torch.arange(w, dtype=torch.float32, device=feat.device),
                            indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)])  # (3, h, w)
    # the 3x3 products as multiply-adds: full float32 whatever the TF32 settings
    Kinv = torch.linalg.inv_ex(K).inverse
    cam = (Kinv[:, :, :, None, None] * pix[None, None]).sum(dim=2) * depth[:, None]
    proj = (K[:, :, :, None] * rel_pose34[:, None, :, :]).sum(dim=2)  # (B, 3, 4)
    p = (proj[:, :, :3, None, None] * cam[:, None]).sum(dim=2) + proj[:, :, 3, None, None]
    X, Y, Z = p[:, 0], p[:, 1], torch.clamp(p[:, 2], min=1e-3)
    xn = 2 * (X / Z) / (w - 1) - 1
    yn = 2 * (Y / Z) / (h - 1) - 1
    xn = torch.where((xn > 1) | (xn < -1), 2.0, xn)
    yn = torch.where((yn > 1) | (yn < -1), 2.0, yn)
    return grid_sample(feat, torch.stack([xn, yn], dim=-1), mode="bilinear",
                       align_corners=True)


def feature_intrinsics(K):
    """K (B, 3, 3) at the frame size -> at the 1/4 feature size: rows 0 and
    1 by 1/4 (exact in float32), without a host tensor, so the forward
    captures."""
    return torch.cat([K[:, :2] * 0.25, K[:, 2:]], dim=1)


class DPSNetModel(nn.Module):
    def __init__(self, nlabel: int = 64, mindepth: float = 0.5):
        super().__init__()
        self.nlabel, self.mindepth = nlabel, mindepth
        self.feature_extraction = SPPFeatures()
        relu = nn.ReLU(inplace=True)
        self.dres0 = nn.Sequential(convbn_3d(64, 32), relu, convbn_3d(32, 32), relu)
        for i in range(1, 5):
            setattr(self, f"dres{i}", nn.Sequential(convbn_3d(32, 32), relu, convbn_3d(32, 32)))
        self.classify = nn.Sequential(convbn_3d(32, 32), relu,
                                      nn.Conv3d(32, 1, 3, padding=1, bias=False))
        channels = [33, 128, 128, 128, 96, 64, 32, 1]
        dilations = [1, 2, 4, 8, 16, 1, 1]
        # every convtext, the last one too, ends in LeakyReLU(0.1)
        self.convs = nn.Sequential(*[nn.Sequential(
            nn.Conv2d(channels[i], channels[i + 1], 3, padding=d, dilation=d, bias=False),
            nn.LeakyReLU(0.1, inplace=True)) for i, d in enumerate(dilations)])

    def hourglass(self, cost):
        """(B, 64, L, h, w) -> (B, 1, L, h, w)."""
        c0 = self.dres0(cost)
        for i in range(1, 5):
            c0 = getattr(self, f"dres{i}")(c0) + c0
        return self.classify(c0)

    def _regress(self, cost, H: int, W: int):
        """(B, L, h, w) costs -> (B, H, W) depth by soft-argmin."""
        labels = torch.arange(self.nlabel, dtype=torch.float32, device=cost.device)
        c = resize_bilinear_align_corners(cost, H, W, align_corners=False)
        disp = (F.softmax(c, dim=1) * labels[None, :, None, None]).sum(dim=1)
        return self.mindepth * self.nlabel / (disp + 1e-16)

    def forward(self, ref, targets, rel_poses, K, view_mask=None):
        """ref (B, 3, H, W); targets (B, V, 3, H, W); rel_poses (B, V, 3, 4)
        target <- reference; K (B, 3, 3) at the frame size; view_mask
        optional (B, V). Returns (depth0, depth), each (B, H, W)."""
        B, V = targets.shape[:2]
        H, W = ref.shape[-2:]
        L = self.nlabel
        K4 = feature_intrinsics(K)
        ref_fea = self.feature_extraction(ref)  # (B, 32, h, w)
        C, h, w = ref_fea.shape[1:]
        labels = torch.arange(L, dtype=torch.float32, device=ref.device)
        # (B*L, h, w): label-major within each batch element
        depth = (self.mindepth * L / (labels + 1e-16))[None, :, None, None].expand(B, L, h, w)
        depth = depth.reshape(B * L, h, w)

        costs, denom = 0.0, 0.0
        for j in range(V):
            tgt_fea = self.feature_extraction(targets[:, j])
            warped = inverse_warp(
                tgt_fea[:, None].expand(B, L, C, h, w).reshape(B * L, C, h, w), depth,
                rel_poses[:, j, None].expand(B, L, 3, 4).reshape(B * L, 3, 4),
                K4[:, None].expand(B, L, 3, 3).reshape(B * L, 3, 3)).reshape(B, L, C, h, w)
            cost = torch.cat([ref_fea[:, None].expand(B, L, C, h, w), warped], dim=2)
            out = self.hourglass(cost.permute(0, 2, 1, 3, 4))[:, 0]  # (B, L, h, w)
            m = 1.0 if view_mask is None else view_mask[:, j, None, None, None]
            costs = costs + out * m
            denom = denom + m
        costs = costs / (denom if view_mask is not None else V)

        # context refinement of each label slice, the labels in the batch
        slices = costs.reshape(B * L, 1, h, w)
        context_in = torch.cat(
            [ref_fea[:, None].expand(B, L, C, h, w).reshape(B * L, C, h, w), slices], dim=1)
        costss = (self.convs(context_in) + slices).reshape(B, L, h, w)
        return self._regress(costs, H, W), self._regress(costss, H, W)


@register_baseline("dpsnet")
class DPSNet(GraphedEstimator):
    image_width = 320
    image_height = 256
    scale_rgb = 255.0
    mean_rgb = (0.5, 0.5, 0.5)
    std_rgb = (0.5, 0.5, 0.5)

    def __init__(self, n_measurement_frames: int = 2, state_dict=None, seed: int = 0,
                 device="cuda", graphs: bool = True):
        """Runs on the card unless ``device="cpu"``; weights from a generator
        seeded with ``seed``, or ``state_dict`` (the reference's keys).
        ``graphs``: ``predict`` as one CUDA graph replay on the card
        (``baselines/steps.py``), else eagerly."""
        self.V = n_measurement_frames
        self.model = seeded_model(DPSNetModel(), seed, device, state_dict)
        self.device = next(self.model.parameters()).device
        self._init_steps(graphs)

    def _forward_body(self, **inputs):
        return self.model(*relative_views(**inputs))[1]

    @torch.inference_mode()
    def predict(self, ref_image, meas_images: List[np.ndarray], ref_pose, meas_poses,
                K) -> np.ndarray:
        inputs = relative_inputs(self.V, ref_image, meas_images, ref_pose, meas_poses, K,
                                 rows=3)
        return self._readback(self._step("forward", self._forward_body, inputs))
