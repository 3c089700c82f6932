"""FusionNet: PairNet + ConvLSTM fusion at the 1/32 bottleneck (counterpart
of dvmvs_tpu/models/fusionnet.py).

The LSTM carry (h, c) plus the previous keyframe's pose is passed in and
returned explicitly. Zero h/c with an identity previous pose and a zero
depth hypothesis reproduce the original's empty-state first step: warping a
zero hidden state gives zero, and a zero hypothesis invalidates every pixel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from dvmvs_tpu_torch.models.convlstm import LSTMFusion, warp_hidden_state
from dvmvs_tpu_torch.models.pairnet import PairNet, scale_intrinsics


class LSTMCarry(NamedTuple):
    h: torch.Tensor  # (B, 512, H/32, W/32)
    c: torch.Tensor  # (B, 512, H/32, W/32)


def init_lstm_carry(batch: int, height: int, width: int, hidden: int = 512,
                    device=None) -> LSTMCarry:
    shape = (batch, hidden, height // 32, width // 32)
    return LSTMCarry(torch.zeros(shape, device=device), torch.zeros(shape, device=device))


class FusionNet(PairNet):
    """Adds ``lstm_fusion`` to the PairNet submodules."""

    def __init__(self, min_depth: float = 0.25, max_depth: float = 20.0,
                 n_depth_levels: int = 64, hidden_channels: int = 512):
        super().__init__(min_depth, max_depth, n_depth_levels)
        self.lstm_fusion = LSTMFusion(512, hidden_channels)

    def predict_depth(self, ref_image, ref_features: Tuple[torch.Tensor, ...],
                      meas_feature_half, ref_pose, meas_poses, K, carry: LSTMCarry,
                      prev_pose, depth_hypothesis_1_32,
                      view_mask: Optional[torch.Tensor] = None):
        """Recurrent step; prev_pose (B, 4, 4) is the previous keyframe's pose
        (identity after a reset) and depth_hypothesis_1_32 (B, H/32, W/32)
        warps the hidden state. Returns (five depth maps, next carry)."""
        f_half, f_quarter, f_one_eight, f_one_sixteen = ref_features
        cv = self.cost_volume(f_half, meas_feature_half, ref_pose, meas_poses, K, view_mask)
        skip0, skip1, skip2, skip3, bottom = self.cost_volume_encoder(
            f_half, f_quarter, f_one_eight, f_one_sixteen, cv)
        h_warped = warp_hidden_state(carry.h, prev_pose, ref_pose, depth_hypothesis_1_32,
                                     scale_intrinsics(K, 1.0 / 32.0))
        h_next, c_next = self.lstm_fusion(bottom, h_warped, carry.c)
        depths = self.cost_volume_decoder(ref_image, skip0, skip1, skip2, skip3, h_next)
        return depths, LSTMCarry(h_next, c_next)
