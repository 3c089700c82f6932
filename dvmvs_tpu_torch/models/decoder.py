"""Cost-volume decoder with per-scale depth heads (counterpart of
dvmvs_tpu/models/decoder.py).

Four DecoderBlocks (512 -> 256 -> 128 -> 64 -> 32), each followed by a
sigmoid depth head whose map feeds the next block. A full-resolution refine
head takes the upsampled decoder output, the upsampled sigmoid depth and the
RGB image. A sigmoid s maps to depth by 1/d = s (1/min - 1/max) + 1/max.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from dvmvs_tpu_torch.models.layers import ConvBnRelu, DecoderBlock, DepthHead
from dvmvs_tpu_torch.ops.sampling import resize_bilinear_align_corners

HYPER_CHANNELS = 32


class CostVolumeDecoder(nn.Module):
    def __init__(self, min_depth: float = 0.25, max_depth: float = 20.0,
                 hyper_channels: int = HYPER_CHANNELS):
        super().__init__()
        hc = hyper_channels
        self.inverse_depth_base = 1.0 / max_depth
        self.inverse_depth_multiplier = 1.0 / min_depth - 1.0 / max_depth
        self.decoder_block1 = DecoderBlock(hc * 16, hc * 8, 3, True, False)
        self.decoder_block2 = DecoderBlock(hc * 8, hc * 4, 3, True, True)
        self.decoder_block3 = DecoderBlock(hc * 4, hc * 2, 3, True, True)
        self.decoder_block4 = DecoderBlock(hc * 2, hc, 5, True, True)
        self.refine = nn.Sequential(ConvBnRelu(hc + 4, hc, 5), ConvBnRelu(hc, hc, 5))
        self.depth_layer_one_sixteen = DepthHead(hc * 8)
        self.depth_layer_one_eight = DepthHead(hc * 4)
        self.depth_layer_quarter = DepthHead(hc * 2)
        self.depth_layer_half = DepthHead(hc)
        self.depth_layer_full = DepthHead(hc)

    def forward(self, image, skip0, skip1, skip2, skip3, bottom):
        """image (B, 3, H, W) -> depths (full, half, quarter, one_eight,
        one_sixteen), each (B, h, w) float32 in metres."""
        d1 = self.decoder_block1(bottom, skip3, None)
        sig_one_sixteen = self.depth_layer_one_sixteen(d1)
        d2 = self.decoder_block2(d1, skip2, sig_one_sixteen)
        sig_one_eight = self.depth_layer_one_eight(d2)
        d3 = self.decoder_block3(d2, skip1, sig_one_eight)
        sig_quarter = self.depth_layer_quarter(d3)
        d4 = self.decoder_block4(d3, skip0, sig_quarter)
        sig_half = self.depth_layer_half(d4)

        Hh, Wh = sig_half.shape[-2:]
        scaled_depth = resize_bilinear_align_corners(sig_half, 2 * Hh, 2 * Wh)
        scaled_decoder = resize_bilinear_align_corners(d4, 2 * Hh, 2 * Wh)
        combined = self.refine(torch.cat([scaled_decoder, scaled_depth, image], dim=1))
        sig_full = self.depth_layer_full(combined)

        # metric depths always leave the network in f32
        return tuple(
            1.0 / (self.inverse_depth_multiplier * s.float() + self.inverse_depth_base)[:, 0]
            for s in (sig_full, sig_half, sig_quarter, sig_one_eight, sig_one_sixteen))
