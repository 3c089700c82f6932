"""Layer-norm ConvLSTM cell with depth-based hidden-state warping
(counterpart of dvmvs_tpu/models/convlstm.py).

The cell is bias-free, layer-norms the candidate and the next cell state
over (H, W) only with no affine parameters, and uses celu. Before the gates
the hidden state is warped from the previous keyframe into the current one
with the current 1/32 depth estimate; pixels whose estimate is <= 0.01 m are
zeroed.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from dvmvs_tpu_torch.ops.geometry import inverse_pose, matmul_f32
from dvmvs_tpu_torch.ops.warp import warp_frame_depth


def warp_hidden_state(h_cur, previous_pose, current_pose, estimated_current_depth,
                      camera_matrix):
    """Warp h_cur (B, C, H, W) into the current viewpoint; depth (B, H, W)
    and camera_matrix (B, 3, 3) at the hidden-state resolution."""
    transformation = matmul_f32(inverse_pose(previous_pose), current_pose)
    warped = warp_frame_depth(h_cur, estimated_current_depth, transformation, camera_matrix)
    valid = (estimated_current_depth > 0.01)[:, None]
    return warped * valid.to(warped.dtype)


class MVSLayernormConvLSTMCell(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int, kernel_size: int = 3):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.conv = nn.Conv2d(input_dim + hidden_dim, 4 * hidden_dim, kernel_size,
                              padding=kernel_size // 2, bias=False)

    def forward(self, input_tensor, h_cur, c_cur):
        gates = self.conv(torch.cat([input_tensor, h_cur], dim=1))
        cc_i, cc_f, cc_o, cc_g = torch.split(gates, self.hidden_dim, dim=1)
        i = torch.sigmoid(cc_i)
        f = torch.sigmoid(cc_f)
        o = torch.sigmoid(cc_o)
        hw = tuple(gates.shape[-2:])
        g = F.celu(F.layer_norm(cc_g, hw))
        c_next = F.layer_norm(f * c_cur + i * g, hw)
        h_next = o * F.celu(c_next)
        return h_next, c_next


class LSTMFusion(nn.Module):
    """Holds the cell; the caller applies the hidden-state warp."""

    def __init__(self, input_dim: int = 512, hidden_dim: int = 512):
        super().__init__()
        self.lstm_cell = MVSLayernormConvLSTMCell(input_dim, hidden_dim, 3)

    def forward(self, current_encoding, h_cur, c_cur):
        return self.lstm_cell(current_encoding, h_cur, c_cur)
