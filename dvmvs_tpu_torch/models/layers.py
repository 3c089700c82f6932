"""Convolution building blocks (counterpart of dvmvs_tpu/models/layers.py).

NCHW ``nn.Module``s whose state-dict names are the original model's
(``conv_layer`` is ``Sequential(Conv2d, BatchNorm2d, ReLU)``, so its keys are
``<name>.0.weight`` and ``<name>.1.*``). Convolutions are bias-free and
followed by BatchNorm + ReLU unless noted. ``BatchNorm2d`` updates its
running variance as Flax does.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from dvmvs_tpu_torch.ops.sampling import resize_bilinear_align_corners
from dvmvs_tpu_torch.parallel.mesh import world_size

# Flax keeps 0.9 of the running average per update; torch's momentum is the
# complement.
BN_MOMENTUM = 0.1
BN_EPS = 1e-5


class _FlaxRunningStats:
    """Train-mode forward of a torch BatchNorm that updates like
    ``flax.linen.BatchNorm``: it normalises with the biased batch statistics
    (as both frameworks do) and folds the biased batch variance into
    ``running_var`` with the module's momentum; stock torch folds in the
    unbiased one, n/(n-1) larger (8/7 for the 1/32 blocks of a 64x64 batch
    of 2). Eval mode and the state-dict names are torch's."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        # the running buffers stay out of the autograd graph: a module called
        # at every step of a BPTT loop updates them between forward and backward
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, *range(2, x.dim())), correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class BatchNorm2d(_FlaxRunningStats, nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with Flax's running-statistics update."""


class BatchNorm3d(_FlaxRunningStats, nn.BatchNorm3d):
    """``nn.BatchNorm3d`` with Flax's running-statistics update (statistics
    over N, D, H, W)."""


class _AllReduceSum(torch.autograd.Function):
    """Sum over a process group; the gradient of each rank's input is the
    sum of the ranks' output gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class SyncBatchNorm2d(BatchNorm2d):
    """``BatchNorm2d`` whose train-mode statistics are those of the global
    batch of a data-parallel group, as under pjit. Each rank's biased
    variance and mean are combined as Chan's parallel update does, with two
    all-reduces whose backward all-reduces the gradient, so it reaches every
    rank's input:

        M = sum_r n_r m_r / N,    V = sum_r n_r (v_r + (m_r - M)^2) / N

    and the biased V is folded into ``running_var``, as Flax does (stock
    ``nn.SyncBatchNorm`` folds in the unbiased one, and needs CUDA). With
    no group, or a group of one, it is ``BatchNorm2d``."""

    process_group = None

    def forward(self, x):
        group = self.process_group
        if not self.training or group is None or world_size(group) == 1:
            return super().forward(x)
        dims = (0, *range(2, x.dim()))
        var, mean = torch.var_mean(x, dim=dims, correction=0)
        n = torch.full_like(mean[:1], x.numel() / x.shape[1])
        mean_n = _AllReduceSum.apply(torch.cat([mean * n, n]), group)
        total = mean_n[-1]
        mean_g = mean_n[:-1] / total
        var_g = _AllReduceSum.apply(n * (var + (mean - mean_g) ** 2), group) / total
        with torch.no_grad():
            self.running_mean.lerp_(mean_g, self.momentum)
            self.running_var.lerp_(var_g, self.momentum)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        scale = torch.rsqrt(var_g + self.eps) * self.weight
        return (x - mean_g.view(shape)) * scale.view(shape) + self.bias.view(shape)


def convert_sync_batchnorm(model: nn.Module, group) -> nn.Module:
    """Replace every ``BatchNorm2d`` of ``model`` by a ``SyncBatchNorm2d``
    over ``group``, in place, with its parameters and buffers: the
    state-dict names stay. Returns the model."""
    for name, child in model.named_children():
        if type(child) is BatchNorm2d:
            sync = SyncBatchNorm2d(child.num_features, eps=child.eps, momentum=child.momentum)
            sync.to(child.weight.device, child.weight.dtype).train(child.training)
            sync.load_state_dict(child.state_dict())
            sync.process_group = group
            setattr(model, name, sync)
        else:
            convert_sync_batchnorm(child, group)
    return model


class ConvBnRelu(nn.Sequential):
    """conv_layer: Conv2d(k, stride, padding (k-1)//2, no bias) [+ BN + ReLU]."""

    def __init__(self, in_channels: int, features: int, kernel_size: int, stride: int = 1,
                 apply_bn_relu: bool = True):
        layers = [nn.Conv2d(in_channels, features, kernel_size, stride=stride,
                            padding=(kernel_size - 1) // 2, bias=False)]
        if apply_bn_relu:
            layers += [BatchNorm2d(features, eps=BN_EPS, momentum=BN_MOMENTUM),
                       nn.ReLU(inplace=True)]
        super().__init__(*layers)


class StandardLayer(nn.Module):
    """Two same-channel convs."""

    def __init__(self, channels: int, kernel_size: int, apply_bn_relu: bool = True):
        super().__init__()
        self.conv1 = ConvBnRelu(channels, channels, kernel_size, 1, True)
        self.conv2 = ConvBnRelu(channels, channels, kernel_size, 1, apply_bn_relu)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class DownconvolutionLayer(nn.Module):
    def __init__(self, in_channels: int, features: int, kernel_size: int):
        super().__init__()
        self.down_conv = ConvBnRelu(in_channels, features, kernel_size, 2)

    def forward(self, x):
        return self.down_conv(x)


class EncoderBlock(nn.Module):
    """Stride-2 down conv + StandardLayer."""

    def __init__(self, in_channels: int, features: int, kernel_size: int):
        super().__init__()
        self.down_convolution = DownconvolutionLayer(in_channels, features, kernel_size)
        self.standard_convolution = StandardLayer(features, kernel_size)

    def forward(self, x):
        return self.standard_convolution(self.down_convolution(x))


class UpconvolutionLayer(nn.Module):
    """Bilinear x2 (align_corners) + conv."""

    def __init__(self, in_channels: int, features: int, kernel_size: int):
        super().__init__()
        self.conv = ConvBnRelu(in_channels, features, kernel_size, 1)

    def forward(self, x):
        H, W = x.shape[-2:]
        return self.conv(resize_bilinear_align_corners(x, 2 * H, 2 * W))


class DecoderBlock(nn.Module):
    """Upsample + skip (+ upsampled depth) aggregation."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 apply_bn_relu: bool = True, plus_one: bool = True):
        super().__init__()
        self.up_convolution = UpconvolutionLayer(in_channels, features, kernel_size)
        # the skip has ``features`` channels, so the concat has in_channels (+1)
        self.convolution1 = ConvBnRelu(in_channels + int(plus_one), features, kernel_size)
        self.convolution2 = ConvBnRelu(features, features, kernel_size, 1, apply_bn_relu)

    def forward(self, x, skip, depth):
        x = self.up_convolution(x)
        if depth is None:
            x = torch.cat([x, skip], dim=1)
        else:
            H, W = depth.shape[-2:]
            depth = resize_bilinear_align_corners(depth, 2 * H, 2 * W)
            x = torch.cat([x, skip, depth], dim=1)
        return self.convolution2(self.convolution1(x))


class DepthHead(nn.Sequential):
    """3x3 conv (with bias) + sigmoid."""

    def __init__(self, in_channels: int):
        super().__init__(nn.Conv2d(in_channels, 1, 3, padding=1), nn.Sigmoid())


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator):
    """Seeded initialisation: every conv (2-D or 3-D) gets PyTorch's default
    distribution (uniform in +-1/sqrt(fan_in)) drawn from ``generator``;
    BatchNorm starts at identity."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d)):
            fan_in = m.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d)):
            m.reset_parameters()


def seeded_model(model: nn.Module, seed: int, device="cuda", state_dict=None) -> nn.Module:
    """``model`` initialised from a ``torch.Generator`` seeded with ``seed``
    (``init_parameters``), then loaded from ``state_dict`` when given
    (strict), moved to ``device`` and put in eval mode. Raises if the card
    is asked for and there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{type(model).__name__}: device {str(device)!r} asked for, but "
                           "torch.cuda.is_available() is false; pass device=\"cpu\" to run on "
                           "the CPU")
    init_parameters(model, torch.Generator().manual_seed(seed))
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model.to(device).eval()
