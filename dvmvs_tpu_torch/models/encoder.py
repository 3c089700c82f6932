"""Cost-volume hourglass encoder (counterpart of dvmvs_tpu/models/encoder.py).

At each of four scales: concat the FPN skip with the incoming tensor,
aggregate with a conv, then a stride-2 EncoderBlock. Channels 32 -> 64 ->
128 -> 256 -> 512; kernel 5 at half resolution, 3 elsewhere.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from dvmvs_tpu_torch.models.layers import ConvBnRelu, EncoderBlock

HYPER_CHANNELS = 32


class CostVolumeEncoder(nn.Module):
    def __init__(self, hyper_channels: int = HYPER_CHANNELS, fpn_channels: int = 32,
                 n_depth_levels: int = 64):
        super().__init__()
        hc = hyper_channels
        self.aggregator0 = ConvBnRelu(fpn_channels + n_depth_levels, hc, 5)
        self.encoder_block0 = EncoderBlock(hc, hc * 2, 5)
        self.aggregator1 = ConvBnRelu(fpn_channels + hc * 2, hc * 2, 3)
        self.encoder_block1 = EncoderBlock(hc * 2, hc * 4, 3)
        self.aggregator2 = ConvBnRelu(fpn_channels + hc * 4, hc * 4, 3)
        self.encoder_block2 = EncoderBlock(hc * 4, hc * 8, 3)
        self.aggregator3 = ConvBnRelu(fpn_channels + hc * 8, hc * 8, 3)
        self.encoder_block3 = EncoderBlock(hc * 8, hc * 16, 3)

    def forward(self, features_half, features_quarter, features_one_eight,
                features_one_sixteen, cost_volume):
        """-> (skip0, skip1, skip2, skip3, bottom at 1/32)."""
        inp0 = self.aggregator0(torch.cat([features_half, cost_volume], dim=1))
        out0 = self.encoder_block0(inp0)
        inp1 = self.aggregator1(torch.cat([features_quarter, out0], dim=1))
        out1 = self.encoder_block1(inp1)
        inp2 = self.aggregator2(torch.cat([features_one_eight, out1], dim=1))
        out2 = self.encoder_block2(inp2)
        inp3 = self.aggregator3(torch.cat([features_one_sixteen, out2], dim=1))
        out3 = self.encoder_block3(inp3)
        return inp0, inp1, inp2, inp3, out3
