"""Feature pyramid network, FeatureShrinker (counterpart of dvmvs_tpu/models/fpn.py).

torchvision's FeaturePyramidNetwork over the five MnasNet stages with
out_channels=32: 1x1 lateral convs (with bias), nearest top-down merge to
the lateral's size, 3x3 output convs (with bias). Names follow the original
checkpoint (``fpn.inner_blocks.i``, ``fpn.layer_blocks.i``). The 1/32 output
is dropped, so ``fpn.layer_blocks.4`` holds weights that no output uses.
"""

from __future__ import annotations

import torch.nn as nn

from dvmvs_tpu_torch.ops.sampling import resize_nearest

MNAS_CHANNELS = (16, 24, 40, 96, 320)


class FeatureShrinker(nn.Module):
    def __init__(self, in_channels=MNAS_CHANNELS, out_channels: int = 32):
        super().__init__()
        self.fpn = nn.Module()
        self.fpn.inner_blocks = nn.ModuleList(
            [nn.Conv2d(c, out_channels, 1) for c in in_channels])
        self.fpn.layer_blocks = nn.ModuleList(
            [nn.Conv2d(out_channels, out_channels, 3, padding=1) for _ in in_channels])

    def forward(self, l1, l2, l3, l4, l5):
        """-> (half, quarter, one_eight, one_sixteen)."""
        inners = [blk(x) for blk, x in zip(self.fpn.inner_blocks, (l1, l2, l3, l4, l5))]
        outs = [None] * 4
        last = inners[4]
        for i in range(3, -1, -1):
            lateral = inners[i]
            last = lateral + resize_nearest(last, lateral.shape[-2], lateral.shape[-1])
            outs[i] = self.fpn.layer_blocks[i](last)
        return tuple(outs)
