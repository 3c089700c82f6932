"""Plain PyTorch FusionNet and PairNet (DeepVideoMVS, Duzceker et al., CVPR
2021), frozen for the benchmark.

The modules keep the original model's state-dict names, which the port
keeps too, so one state dict loads into both. Nothing here is fused or
captured: convolutions are ``nn.Conv2d``, the cost volume is the gather
sweep of ``geometry.py`` and the recurrence is a Python loop. BatchNorm in
train mode folds the biased batch variance into its running variance, as
Flax does (the JAX package is the port's reference, and the port follows
it).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference import geometry

BN_MOMENTUM, BN_EPS = 0.1, 1e-5
MNAS_BN_MOMENTUM = 3e-4
MNAS_CHANNELS = (16, 24, 40, 96, 320)


def resize_bilinear(x, out_h: int, out_w: int):
    if tuple(x.shape[-2:]) == (out_h, out_w):
        return x
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=True)


def resize_nearest(x, out_h: int, out_w: int):
    if tuple(x.shape[-2:]) == (out_h, out_w):
        return x
    if x.dim() == 3:
        return F.interpolate(x[:, None], size=(out_h, out_w), mode="nearest")[:, 0]
    return F.interpolate(x, size=(out_h, out_w), mode="nearest")


class BatchNorm2d(nn.BatchNorm2d):
    def forward(self, x):
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class ConvBnRelu(nn.Sequential):
    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, bn_relu: bool = True):
        layers = [nn.Conv2d(cin, cout, k, stride=stride, padding=(k - 1) // 2, bias=False)]
        if bn_relu:
            layers += [BatchNorm2d(cout, eps=BN_EPS, momentum=BN_MOMENTUM), nn.ReLU()]
        super().__init__(*layers)


class StandardLayer(nn.Module):
    def __init__(self, channels: int, k: int, bn_relu: bool = True):
        super().__init__()
        self.conv1 = ConvBnRelu(channels, channels, k)
        self.conv2 = ConvBnRelu(channels, channels, k, 1, bn_relu)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class DownconvolutionLayer(nn.Module):
    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.down_conv = ConvBnRelu(cin, cout, k, 2)

    def forward(self, x):
        return self.down_conv(x)


class EncoderBlock(nn.Module):
    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.down_convolution = DownconvolutionLayer(cin, cout, k)
        self.standard_convolution = StandardLayer(cout, k)

    def forward(self, x):
        return self.standard_convolution(self.down_convolution(x))


class UpconvolutionLayer(nn.Module):
    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.conv = ConvBnRelu(cin, cout, k)

    def forward(self, x):
        return self.conv(resize_bilinear(x, 2 * x.shape[-2], 2 * x.shape[-1]))


class DecoderBlock(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, bn_relu: bool = True, plus_one: bool = True):
        super().__init__()
        self.up_convolution = UpconvolutionLayer(cin, cout, k)
        self.convolution1 = ConvBnRelu(cin + int(plus_one), cout, k)
        self.convolution2 = ConvBnRelu(cout, cout, k, 1, bn_relu)

    def forward(self, x, skip, depth):
        x = self.up_convolution(x)
        if depth is None:
            x = torch.cat([x, skip], dim=1)
        else:
            depth = resize_bilinear(depth, 2 * depth.shape[-2], 2 * depth.shape[-1])
            x = torch.cat([x, skip, depth], dim=1)
        return self.convolution2(self.convolution1(x))


class DepthHead(nn.Sequential):
    def __init__(self, cin: int):
        super().__init__(nn.Conv2d(cin, 1, 3, padding=1), nn.Sigmoid())


def _mnas_bn(channels: int):
    return BatchNorm2d(channels, eps=BN_EPS, momentum=MNAS_BN_MOMENTUM)


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int, expansion: int):
        super().__init__()
        mid = cin * expansion
        self.layers = nn.Sequential(
            nn.Conv2d(cin, mid, 1, bias=False), _mnas_bn(mid), nn.ReLU(),
            nn.Conv2d(mid, mid, k, stride=stride, padding=k // 2, groups=mid, bias=False),
            _mnas_bn(mid), nn.ReLU(),
            nn.Conv2d(mid, cout, 1, bias=False), _mnas_bn(cout))
        self.residual = cin == cout and stride == 1

    def forward(self, x):
        y = self.layers(x)
        return x + y if self.residual else y


def _stack(cin, cout, k, stride, expansion, repeats):
    blocks = [InvertedResidual(cin, cout, k, stride, expansion)]
    blocks += [InvertedResidual(cout, cout, k, 1, expansion) for _ in range(repeats - 1)]
    return nn.Sequential(*blocks)


class MnasFeatureExtractor(nn.Module):
    """MnasNet-1.0's first five stages (torchvision's layer plan)."""

    def __init__(self):
        super().__init__()
        self.layer1 = nn.Sequential(
            nn.Conv2d(3, 32, 3, stride=2, padding=1, bias=False), _mnas_bn(32), nn.ReLU(),
            nn.Conv2d(32, 32, 3, padding=1, groups=32, bias=False), _mnas_bn(32), nn.ReLU(),
            nn.Conv2d(32, 16, 1, bias=False), _mnas_bn(16))
        self.layer2 = nn.Sequential(_stack(16, 24, 3, 2, 3, 3))
        self.layer3 = nn.Sequential(_stack(24, 40, 5, 2, 3, 3))
        self.layer4 = nn.Sequential(_stack(40, 80, 5, 2, 6, 3), _stack(80, 96, 3, 1, 6, 2))
        self.layer5 = nn.Sequential(_stack(96, 192, 5, 2, 6, 4), _stack(192, 320, 3, 1, 6, 1))

    def forward(self, x):
        outs = []
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4, self.layer5):
            x = layer(x)
            outs.append(x)
        return outs


class FeatureShrinker(nn.Module):
    """torchvision's FeaturePyramidNetwork over the five stages; the 1/32
    output is dropped."""

    def __init__(self, out_channels: int):
        super().__init__()
        self.fpn = nn.Module()
        self.fpn.inner_blocks = nn.ModuleList(nn.Conv2d(c, out_channels, 1) for c in MNAS_CHANNELS)
        self.fpn.layer_blocks = nn.ModuleList(
            nn.Conv2d(out_channels, out_channels, 3, padding=1) for _ in MNAS_CHANNELS)

    def forward(self, *taps):
        inners = [blk(x) for blk, x in zip(self.fpn.inner_blocks, taps)]
        outs, last = [None] * 4, inners[4]
        for i in range(3, -1, -1):
            last = inners[i] + resize_nearest(last, inners[i].shape[-2], inners[i].shape[-1])
            outs[i] = self.fpn.layer_blocks[i](last)
        return tuple(outs)


class CostVolumeEncoder(nn.Module):
    def __init__(self, hc: int, fpn: int, planes: int):
        super().__init__()
        self.aggregator0 = ConvBnRelu(fpn + planes, hc, 5)
        self.encoder_block0 = EncoderBlock(hc, hc * 2, 5)
        self.aggregator1 = ConvBnRelu(fpn + hc * 2, hc * 2, 3)
        self.encoder_block1 = EncoderBlock(hc * 2, hc * 4, 3)
        self.aggregator2 = ConvBnRelu(fpn + hc * 4, hc * 4, 3)
        self.encoder_block2 = EncoderBlock(hc * 4, hc * 8, 3)
        self.aggregator3 = ConvBnRelu(fpn + hc * 8, hc * 8, 3)
        self.encoder_block3 = EncoderBlock(hc * 8, hc * 16, 3)

    def forward(self, f_half, f_quarter, f_eighth, f_sixteenth, cv):
        inp0 = self.aggregator0(torch.cat([f_half, cv], 1))
        inp1 = self.aggregator1(torch.cat([f_quarter, self.encoder_block0(inp0)], 1))
        inp2 = self.aggregator2(torch.cat([f_eighth, self.encoder_block1(inp1)], 1))
        inp3 = self.aggregator3(torch.cat([f_sixteenth, self.encoder_block2(inp2)], 1))
        return inp0, inp1, inp2, inp3, self.encoder_block3(inp3)


class CostVolumeDecoder(nn.Module):
    def __init__(self, min_depth: float, max_depth: float, hc: int):
        super().__init__()
        self.inverse_depth_base = 1.0 / max_depth
        self.inverse_depth_multiplier = 1.0 / min_depth - 1.0 / max_depth
        self.decoder_block1 = DecoderBlock(hc * 16, hc * 8, 3, True, False)
        self.decoder_block2 = DecoderBlock(hc * 8, hc * 4, 3)
        self.decoder_block3 = DecoderBlock(hc * 4, hc * 2, 3)
        self.decoder_block4 = DecoderBlock(hc * 2, hc, 5)
        self.refine = nn.Sequential(ConvBnRelu(hc + 4, hc, 5), ConvBnRelu(hc, hc, 5))
        self.depth_layer_one_sixteen = DepthHead(hc * 8)
        self.depth_layer_one_eight = DepthHead(hc * 4)
        self.depth_layer_quarter = DepthHead(hc * 2)
        self.depth_layer_half = DepthHead(hc)
        self.depth_layer_full = DepthHead(hc)

    def forward(self, image, skip0, skip1, skip2, skip3, bottom):
        """-> metric depths (full, half, quarter, one_eight, one_sixteen)."""
        d1 = self.decoder_block1(bottom, skip3, None)
        s16 = self.depth_layer_one_sixteen(d1)
        d2 = self.decoder_block2(d1, skip2, s16)
        s8 = self.depth_layer_one_eight(d2)
        d3 = self.decoder_block3(d2, skip1, s8)
        s4 = self.depth_layer_quarter(d3)
        d4 = self.decoder_block4(d3, skip0, s4)
        s2 = self.depth_layer_half(d4)
        H, W = 2 * s2.shape[-2], 2 * s2.shape[-1]
        combined = self.refine(torch.cat([resize_bilinear(d4, H, W), resize_bilinear(s2, H, W),
                                          image], 1))
        s1 = self.depth_layer_full(combined)
        return tuple(1.0 / (self.inverse_depth_multiplier * s + self.inverse_depth_base)[:, 0]
                     for s in (s1, s2, s4, s8, s16))


class ConvLSTMCell(nn.Module):
    """Bias-free ConvLSTM; layer norm over (H, W) without affine
    parameters on the candidate and the cell state; celu."""

    def __init__(self, cin: int, hidden: int):
        super().__init__()
        self.hidden_dim = hidden
        self.conv = nn.Conv2d(cin + hidden, 4 * hidden, 3, padding=1, bias=False)

    def forward(self, x, h, c):
        gates = self.conv(torch.cat([x, h], 1))
        i, f, o, g = torch.split(gates, self.hidden_dim, 1)
        hw = tuple(gates.shape[-2:])
        c_next = F.layer_norm(torch.sigmoid(f) * c
                              + torch.sigmoid(i) * F.celu(F.layer_norm(g, hw)), hw)
        return torch.sigmoid(o) * F.celu(c_next), c_next


class LSTMFusion(nn.Module):
    def __init__(self, cin: int, hidden: int):
        super().__init__()
        self.lstm_cell = ConvLSTMCell(cin, hidden)

    def forward(self, x, h, c):
        return self.lstm_cell(x, h, c)


class PairNet(nn.Module):
    def __init__(self, sizes: dict):
        super().__init__()
        self.min_depth, self.max_depth = sizes["min_depth"], sizes["max_depth"]
        self.n_depth_levels = sizes["n_depth_levels"]
        self.feature_extractor = MnasFeatureExtractor()
        self.feature_shrinker = FeatureShrinker(sizes["fpn_channels"])
        self.cost_volume_encoder = CostVolumeEncoder(sizes["hyper_channels"], sizes["fpn_channels"],
                                                     self.n_depth_levels)
        self.cost_volume_decoder = CostVolumeDecoder(self.min_depth, self.max_depth,
                                                     sizes["hyper_channels"])

    def extract_features(self, images):
        return self.feature_shrinker(*self.feature_extractor(images))

    def cost_volume(self, f_half, meas_half, ref_pose, meas_poses, K, view_mask):
        """Dot-product cost volume (B, P, h, w) at half resolution, the masked
        mean over the measurement views; K at full resolution."""
        return geometry.multiview_cost_volume(
            f_half, meas_half, ref_pose, meas_poses, geometry.scale_intrinsics(K, 0.5),
            self.min_depth, self.max_depth, self.n_depth_levels, view_mask)

    def predict_depth(self, image, feats, meas_half, ref_pose, meas_poses, K, view_mask):
        cv = self.cost_volume(feats[0], meas_half, ref_pose, meas_poses, K, view_mask)
        return self.cost_volume_decoder(image, *self.cost_volume_encoder(*feats, cv))


class FusionNet(PairNet):
    def __init__(self, sizes: dict):
        super().__init__(sizes)
        bottleneck = sizes["hyper_channels"] * 16
        self.lstm_fusion = LSTMFusion(bottleneck, sizes["lstm_hidden_channels"])

    def predict_depth(self, image, feats, meas_half, ref_pose, meas_poses, K, view_mask,
                      carry, prev_pose, hypothesis):
        """One recurrent step: ``carry`` (h, c) of the previous keyframe, its
        pose and the depth hypothesis (B, H/32, W/32) that warps h. Returns
        (depths, next carry)."""
        cv = self.cost_volume(feats[0], meas_half, ref_pose, meas_poses, K, view_mask)
        skip0, skip1, skip2, skip3, bottom = self.cost_volume_encoder(*feats, cv)
        h = geometry.warp_hidden_state(carry[0], prev_pose, ref_pose, hypothesis,
                                       geometry.scale_intrinsics(K, 1.0 / 32.0))
        h, c = self.lstm_fusion(bottom, h, carry[1])
        return self.cost_volume_decoder(image, skip0, skip1, skip2, skip3, h), (h, c)


def build(kind: str, sizes: dict) -> nn.Module:
    return {"pairnet": PairNet, "fusionnet": FusionNet}[kind](sizes)
