"""PairNet, the stateless backbone (counterpart of dvmvs_tpu/models/pairnet.py).

features -> plane-sweep cost volume -> hourglass encoder -> decoder, with two
entry methods: ``extract_features`` (MnasNet + FPN, run once per keyframe
and cached) and ``predict_depth`` (cost volume -> encoder -> decoder from
cached features, a fixed view count V with a validity mask).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from dvmvs_tpu_torch.models.decoder import CostVolumeDecoder
from dvmvs_tpu_torch.models.encoder import CostVolumeEncoder
from dvmvs_tpu_torch.models.fpn import FeatureShrinker
from dvmvs_tpu_torch.models.mnasnet import MnasFeatureExtractor
from dvmvs_tpu_torch.ops.cost_volume import cost_volume_fused


def scale_intrinsics(K: torch.Tensor, factor: float) -> torch.Tensor:
    """Scale fx, fy, cx, cy (the first two rows) of (B, 3, 3) by ``factor``
    (no host-to-device copy, so no synchronisation)."""
    return torch.cat([K[:, :2] * factor, K[:, 2:]], dim=1)


class PairNet(nn.Module):
    def __init__(self, min_depth: float = 0.25, max_depth: float = 20.0,
                 n_depth_levels: int = 64):
        super().__init__()
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.n_depth_levels = n_depth_levels
        self.feature_extractor = MnasFeatureExtractor()
        self.feature_shrinker = FeatureShrinker(out_channels=32)
        self.cost_volume_encoder = CostVolumeEncoder(32, 32, n_depth_levels)
        self.cost_volume_decoder = CostVolumeDecoder(min_depth, max_depth, 32)

    def extract_features(self, images: torch.Tensor):
        """images (N, 3, H, W) -> (half, quarter, one_eight, one_sixteen)."""
        return self.feature_shrinker(*self.feature_extractor(images))

    def cost_volume(self, f_half, meas_feature_half, ref_pose, meas_poses, K, view_mask):
        return cost_volume_fused(
            f_half, meas_feature_half, ref_pose, meas_poses, scale_intrinsics(K, 0.5),
            self.min_depth, self.max_depth, self.n_depth_levels,
            dot_product=True, view_mask=view_mask).to(f_half.dtype)

    def predict_depth(self, ref_image, ref_features: Tuple[torch.Tensor, ...],
                      meas_feature_half, ref_pose, meas_poses, K,
                      view_mask: Optional[torch.Tensor] = None):
        """ref_image (B, 3, H, W); ref_features from ``extract_features``;
        meas_feature_half (B, V, C, H/2, W/2); poses (B, 4, 4) and
        (B, V, 4, 4); K full-resolution (B, 3, 3). Returns five depth maps
        (full .. one_sixteen), each (B, h, w)."""
        f_half, f_quarter, f_one_eight, f_one_sixteen = ref_features
        cv = self.cost_volume(f_half, meas_feature_half, ref_pose, meas_poses, K, view_mask)
        skip0, skip1, skip2, skip3, bottom = self.cost_volume_encoder(
            f_half, f_quarter, f_one_eight, f_one_sixteen, cv)
        return self.cost_volume_decoder(ref_image, skip0, skip1, skip2, skip3, bottom)
