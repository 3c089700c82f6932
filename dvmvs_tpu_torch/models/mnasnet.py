"""MnasNet-1.0 feature trunk (counterpart of dvmvs_tpu/models/mnasnet.py).

Built by hand with torchvision's layer plan and the original
FeatureExtractor's state-dict names: ``layer1.{0,1,3,4,6,7}`` for the stem,
``layer{2,3}.0.<b>.layers.<i>``, ``layer4.{0,1}.<b>.layers.<i>`` and
``layer5.{0,1}.<b>.layers.<i>`` for the inverted-residual stacks.

Feature taps: l1 = layer1 (16 ch, /2), l2 = layer2 (24, /4), l3 = layer3
(40, /8), l4 = layer4 (96, /16), l5 = layer5 (320, /32).
"""

from __future__ import annotations

import torch.nn as nn

from dvmvs_tpu_torch.models.layers import BatchNorm2d

# torchvision's mnasnet keeps 0.9997 of the running average per update
MNAS_BN_MOMENTUM = 3e-4
BN_EPS = 1e-5


def _bn(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=BN_EPS, momentum=MNAS_BN_MOMENTUM)


class InvertedResidual(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int, expansion: int):
        super().__init__()
        mid = in_ch * expansion
        self.layers = nn.Sequential(
            nn.Conv2d(in_ch, mid, 1, bias=False), _bn(mid), nn.ReLU(inplace=True),
            nn.Conv2d(mid, mid, kernel, stride=stride, padding=kernel // 2, groups=mid,
                      bias=False),
            _bn(mid), nn.ReLU(inplace=True),
            nn.Conv2d(mid, out_ch, 1, bias=False), _bn(out_ch),
        )
        self.apply_residual = in_ch == out_ch and stride == 1

    def forward(self, x):
        y = self.layers(x)
        return x + y if self.apply_residual else y


def _stack(in_ch, out_ch, kernel, stride, expansion, repeats) -> nn.Sequential:
    blocks = [InvertedResidual(in_ch, out_ch, kernel, stride, expansion)]
    blocks += [InvertedResidual(out_ch, out_ch, kernel, 1, expansion)
               for _ in range(repeats - 1)]
    return nn.Sequential(*blocks)


class MnasFeatureExtractor(nn.Module):
    """5-stage trunk: image (N, 3, H, W) -> (l1, ..., l5)."""

    def __init__(self):
        super().__init__()
        self.layer1 = nn.Sequential(
            nn.Conv2d(3, 32, 3, stride=2, padding=1, bias=False), _bn(32), nn.ReLU(inplace=True),
            nn.Conv2d(32, 32, 3, padding=1, groups=32, bias=False), _bn(32),
            nn.ReLU(inplace=True),
            nn.Conv2d(32, 16, 1, bias=False), _bn(16),
        )
        self.layer2 = nn.Sequential(_stack(16, 24, 3, 2, 3, 3))
        self.layer3 = nn.Sequential(_stack(24, 40, 5, 2, 3, 3))
        self.layer4 = nn.Sequential(_stack(40, 80, 5, 2, 6, 3), _stack(80, 96, 3, 1, 6, 2))
        self.layer5 = nn.Sequential(_stack(96, 192, 5, 2, 6, 4), _stack(192, 320, 3, 1, 6, 1))

    def forward(self, image):
        l1 = self.layer1(image)
        l2 = self.layer2(l1)
        l3 = self.layer3(l2)
        l4 = self.layer4(l3)
        l5 = self.layer5(l4)
        return l1, l2, l3, l4, l5
