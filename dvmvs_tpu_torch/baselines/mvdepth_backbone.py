"""MVDepthNet U-Net backbone, shared by MVDepthNet and GP-MVS (counterpart
of dvmvs_tpu/baselines/mvdepth_backbone.py; reference:
dvmvs/baselines/mvdepthnet/{encoder,decoder}.py).

Encoder: image (3) + L1 cost volume (64) -> five stride-2 double-conv stages
(channels 128/256/512/512/512, kernels 7/5/3/3/3). Decoder: U-Net with
bilinear x2 up-convolutions (align_corners=True), skip concatenations, four
sigmoid disparity heads scaled by 2 and nearest-upsampled disparity
feedback. ``disp1`` is inverse depth; callers clamp it to [0.02, 2] and
invert. NCHW; the state-dict names are the reference's (``conv1.0.weight``,
``upconv5.1.weight``, ``disp1.0.bias``, ...).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from dvmvs_tpu_torch.models.layers import BN_EPS, BN_MOMENTUM, BatchNorm2d
from dvmvs_tpu_torch.ops.sampling import resize_bilinear_align_corners, resize_nearest

N_LEVELS = 64  # planes of the cost volume, channels of the encoder's input beside the image


def _conv(in_channels: int, features: int, kernel: int, stride: int = 1):
    return [nn.Conv2d(in_channels, features, kernel, stride=stride, padding=(kernel - 1) // 2,
                      bias=False),
            BatchNorm2d(features, eps=BN_EPS, momentum=BN_MOMENTUM), nn.ReLU(inplace=True)]


class DownConv(nn.Sequential):
    """Stride-1 conv + stride-2 conv, each with BatchNorm and ReLU."""

    def __init__(self, in_channels: int, features: int, kernel: int):
        super().__init__(*_conv(in_channels, features, kernel),
                         *_conv(features, features, kernel, stride=2))


class ConvBnRelu(nn.Sequential):
    def __init__(self, in_channels: int, features: int, kernel: int = 3):
        super().__init__(*_conv(in_channels, features, kernel))


class Upsample2x(nn.Module):
    """Bilinear x2, align_corners=True (the reference's ``nn.Upsample``)."""

    def forward(self, x):
        return resize_bilinear_align_corners(x, 2 * x.shape[-2], 2 * x.shape[-1])


class UpConv(nn.Sequential):
    def __init__(self, in_channels: int, features: int, kernel: int = 3):
        super().__init__(Upsample2x(), *_conv(in_channels, features, kernel))


class DispHead(nn.Sequential):
    """3x3 conv with bias + sigmoid."""

    def __init__(self, in_channels: int):
        super().__init__(nn.Conv2d(in_channels, 1, 3, padding=1), nn.Sigmoid())


class MVDepthEncoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = DownConv(3 + N_LEVELS, 128, 7)
        self.conv2 = DownConv(128, 256, 5)
        self.conv3 = DownConv(256, 512, 3)
        self.conv4 = DownConv(512, 512, 3)
        self.conv5 = DownConv(512, 512, 3)

    def forward(self, image, cost_volume):
        """image (B, 3, H, W), cost volume (B, 64, H, W) -> (conv5, conv4,
        conv3, conv2, conv1), at 1/32 .. 1/2 resolution."""
        conv1 = self.conv1(torch.cat([image, cost_volume], dim=1))
        conv2 = self.conv2(conv1)
        conv3 = self.conv3(conv2)
        conv4 = self.conv4(conv3)
        conv5 = self.conv5(conv4)
        return conv5, conv4, conv3, conv2, conv1


def _upsample_disp(disp):
    return resize_nearest(disp, 2 * disp.shape[-2], 2 * disp.shape[-1])


class MVDepthDecoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.upconv5, self.iconv5 = UpConv(512, 512), ConvBnRelu(1024, 512)
        self.upconv4, self.iconv4 = UpConv(512, 512), ConvBnRelu(1024, 512)
        self.upconv3, self.iconv3 = UpConv(512, 256), ConvBnRelu(513, 256)
        self.upconv2, self.iconv2 = UpConv(256, 128), ConvBnRelu(257, 128)
        self.upconv1, self.iconv1 = UpConv(128, 64), ConvBnRelu(65, 64)
        self.disp4, self.disp3 = DispHead(512), DispHead(256)
        self.disp2, self.disp1 = DispHead(128), DispHead(64)

    def forward(self, conv5, conv4, conv3, conv2, conv1) -> Tuple[torch.Tensor, ...]:
        """Encoder features -> (disp1, disp2, disp3, disp4), each (B, 1, h, w)."""
        iconv5 = self.iconv5(torch.cat([self.upconv5(conv5), conv4], dim=1))
        iconv4 = self.iconv4(torch.cat([self.upconv4(iconv5), conv3], dim=1))
        disp4 = 2.0 * self.disp4(iconv4)
        iconv3 = self.iconv3(torch.cat([self.upconv3(iconv4), conv2, _upsample_disp(disp4)],
                                       dim=1))
        disp3 = 2.0 * self.disp3(iconv3)
        iconv2 = self.iconv2(torch.cat([self.upconv2(iconv3), conv1, _upsample_disp(disp3)],
                                       dim=1))
        disp2 = 2.0 * self.disp2(iconv2)
        iconv1 = self.iconv1(torch.cat([self.upconv1(iconv2), _upsample_disp(disp2)], dim=1))
        disp1 = 2.0 * self.disp1(iconv1)
        return disp1, disp2, disp3, disp4
