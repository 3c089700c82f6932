"""Training-mode forward passes (counterpart of
dvmvs_tpu/models/training_heads.py).

  - ``fusionnet_train_sequence``: FusionNet over a length-S subsequence,
    back-propagated through time. A Python loop over the S-1 steps takes the
    place of the JAX package's ``nn.scan``; the LSTM carry starts at zero and
    the hidden state is warped with the ground-truth depth nearest-downsampled
    to 1/32.
  - ``pairnet_train_pair``: PairNet on a pair, one or two directions, with
    the width flip after the cost volume driven by an explicit flip mask.

Inputs keep the JAX package's layout (images (B, S, H, W, 3)), so the tests
compare like with like; the networks run NCHW. BatchNorm follows the
modules' train/eval mode. As in the JAX package, features of all B*S images
come from one backbone pass, so train-mode BatchNorm statistics in the
backbone are taken over B*S images.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from dvmvs_tpu_torch.models.convlstm import warp_hidden_state
from dvmvs_tpu_torch.models.fusionnet import init_lstm_carry
from dvmvs_tpu_torch.models.pairnet import scale_intrinsics
from dvmvs_tpu_torch.ops.cost_volume import plane_sweep_cost_volume_train
from dvmvs_tpu_torch.ops.sampling import resize_nearest


def _features(model, images):
    """images (B, S, H, W, 3) -> NCHW images (B, S, 3, H, W) and the four
    feature maps, each (B, S, C, h, w), from one backbone pass."""
    B, S, H, W, _ = images.shape
    nchw = images.permute(0, 1, 4, 2, 3)
    feats = model.extract_features(nchw.reshape(B * S, 3, H, W))
    return nchw, [f.reshape((B, S) + f.shape[1:]) for f in feats]


def fusionnet_train_sequence(model, images, depths, poses, K) -> Tuple[torch.Tensor, ...]:
    """images (B, S, H, W, 3), depths (B, S, H, W), poses (B, S, 4, 4), K
    (B, 3, 3) full resolution. Returns the five prediction scales (full ..
    one_sixteen) for frames 1..S-1, each (S-1, B, h, w)."""
    B, S, H, W, _ = images.shape
    nchw, (f_half, f_quarter, f_one_eight, f_one_sixteen) = _features(model, images)
    half_K = scale_intrinsics(K, 0.5)
    lstm_K = scale_intrinsics(K, 1.0 / 32.0)
    hyps = resize_nearest(depths.reshape(B * S, H, W), H // 32, W // 32)
    hyps = hyps.reshape(B, S, H // 32, W // 32)

    h, c = init_lstm_carry(B, H, W, model.lstm_fusion.lstm_cell.hidden_dim, images.device)
    steps = []
    for t in range(1, S):
        cv = plane_sweep_cost_volume_train(
            f_half[:, t], f_half[:, t - 1], poses[:, t], poses[:, t - 1], half_K,
            model.min_depth, model.max_depth, model.n_depth_levels)
        skip0, skip1, skip2, skip3, bottom = model.cost_volume_encoder(
            f_half[:, t], f_quarter[:, t], f_one_eight[:, t], f_one_sixteen[:, t], cv)
        h_warped = warp_hidden_state(h, poses[:, t - 1], poses[:, t], hyps[:, t], lstm_K)
        h, c = model.lstm_fusion(bottom, h_warped, c)
        steps.append(model.cost_volume_decoder(nchw[:, t], skip0, skip1, skip2, skip3, h))
    return tuple(torch.stack(scale) for scale in zip(*steps))


def pairnet_train_pair(model, images, depths, poses, K, flip_mask: Sequence[bool],
                       two_way: bool = False) -> List[Tuple[Tuple[torch.Tensor, ...], torch.Tensor]]:
    """images (B, 2, H, W, 3), depths (B, 2, H, W), poses (B, 2, 4, 4), K
    (B, 3, 3); flip_mask: one host bool per direction (one, or two with
    ``two_way``). A flipped direction mirrors the reference features, the
    cost volume, the image and the ground truth along the width after the
    cost volume. Returns [(five prediction scales, ground truth (B, H, W))]
    per direction."""
    B, S, H, W, _ = images.shape
    if S != 2:
        raise ValueError(f"pairnet trains on pairs, got subsequences of {S}")
    nchw, (f_half, f_quarter, f_one_eight, f_one_sixteen) = _features(model, images)
    half_K = scale_intrinsics(K, 0.5)
    directions = [(0, 1), (1, 0)] if two_way else [(1, 0)]
    if len(flip_mask) != len(directions):
        raise ValueError(f"need one flip flag per direction ({len(directions)}), "
                         f"got {len(flip_mask)}")
    outputs = []
    for (i1, i2), flip in zip(directions, flip_mask):
        cv = plane_sweep_cost_volume_train(
            f_half[:, i1], f_half[:, i2], poses[:, i1], poses[:, i2], half_K,
            model.min_depth, model.max_depth, model.n_depth_levels)
        ref = [f_half[:, i1], f_quarter[:, i1], f_one_eight[:, i1], f_one_sixteen[:, i1],
               cv, nchw[:, i1], depths[:, i1]]
        if flip:  # NCHW and (B, H, W): the width is the last axis
            ref = [torch.flip(x, dims=[-1]) for x in ref]
        fh, fq, fe, fs, cv, image, gt = ref
        skip0, skip1, skip2, skip3, bottom = model.cost_volume_encoder(fh, fq, fe, fs, cv)
        preds = model.cost_volume_decoder(image, skip0, skip1, skip2, skip3, bottom)
        outputs.append((preds, gt))
    return outputs
