"""Training steps with the reference's staged-unfreeze schedule, on one
device (counterpart of dvmvs_tpu/parallel/train.py).

Each stage trains a subset of the top-level modules (fusionnet: LSTM +
decoder, then + FPN + encoder, then everything; pairnet: two stages). The
JAX package masks optax updates by module; here each stage gets a fresh
``torch.optim.Adam`` (``AdamW`` with weight decay) over the parameters of
its modules, which also resets the moments, as the JAX driver's
``tx.init`` does. Gradients are still computed for every parameter, and
frozen modules stay in train mode, so their BatchNorm statistics keep
updating as in the JAX step; only ``freeze_bn`` puts BatchNorm in eval
mode.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from dvmvs_tpu_torch.config import MEAN_RGB, SCALE_RGB, STD_RGB
from dvmvs_tpu_torch.models.training_heads import fusionnet_train_sequence, pairnet_train_pair
from dvmvs_tpu_torch.utils.losses import multi_scale_loss

# Unfreeze schedules (top-level module names), per reference driver.
FUSIONNET_STAGES: List[List[str]] = [
    ["lstm_fusion", "cost_volume_decoder"],
    ["feature_shrinker", "cost_volume_encoder", "lstm_fusion", "cost_volume_decoder"],
    ["feature_extractor", "feature_shrinker", "cost_volume_encoder", "lstm_fusion",
     "cost_volume_decoder"],
]
PAIRNET_STAGES: List[List[str]] = [
    ["feature_shrinker", "cost_volume_encoder", "cost_volume_decoder"],
    ["feature_extractor", "feature_shrinker", "cost_volume_encoder",
     "cost_volume_decoder"],
]


def decode_wire_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Decode the compact wire format on the device: uint8 images are cast
    and ImageNet-normalised, float16 depths cast to float32; float32 batches
    pass through unchanged."""
    if batch["images"].dtype == torch.uint8:
        x = batch["images"].to(torch.float32) / SCALE_RGB
        # per-channel Python scalars: no host-to-device copy, so no sync
        channels = [(x[..., c] - MEAN_RGB[c]) / STD_RGB[c] for c in range(3)]
        batch = dict(batch, images=torch.stack(channels, dim=-1))
    if batch["depths"].dtype != torch.float32:
        batch = dict(batch, depths=batch["depths"].to(torch.float32))
    return batch


def make_optimizer(model, trainable_modules: Sequence[str], learning_rate: float = 1e-4,
                   beta1: float = 0.9, beta2: float = 0.999,
                   weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """Adam (optax's settings: eps 1e-8, no eps inside the root) over the
    parameters of ``trainable_modules``; AdamW when ``weight_decay`` > 0."""
    params = [p for name in trainable_modules for p in getattr(model, name).parameters()]
    if weight_decay == 0.0:
        return torch.optim.Adam(params, lr=learning_rate, betas=(beta1, beta2), eps=1e-8)
    return torch.optim.AdamW(params, lr=learning_rate, betas=(beta1, beta2), eps=1e-8,
                             weight_decay=weight_decay)


def _per_step_loss(preds: Sequence[torch.Tensor], gt: torch.Tensor, loss_type: str):
    """Sum over scales of loss_sum / valid_count; gt (B, H, W). The metrics
    are those of the last scale in the decoder's order, which is 1/16 (the
    JAX package's comment calls it full resolution; its order is full ..
    one_sixteen)."""
    return multi_scale_loss(preds, [1.0] * len(preds), gt, loss_type)


def fusionnet_loss_fn(model, batch, loss_type: str = "L1-inv"):
    """Loss over a subsequence batch (images (B, S, H, W, 3), depths
    (B, S, H, W), poses (B, S, 4, 4), K (B, 3, 3)) -> (loss, metrics of the
    last step)."""
    preds = fusionnet_train_sequence(model, batch["images"], batch["depths"], batch["poses"],
                                     batch["K"])
    total, metrics = 0.0, {}
    for t in range(preds[0].shape[0]):
        loss, metrics = _per_step_loss([p[t] for p in preds], batch["depths"][:, t + 1],
                                       loss_type)
        total = total + loss
    return total, {"loss": total, **metrics}


def pairnet_loss_fn(model, batch, flip_mask: Sequence[bool], loss_type: str = "L1-inv",
                    two_way: bool = False):
    outputs = pairnet_train_pair(model, batch["images"], batch["depths"], batch["poses"],
                                 batch["K"], flip_mask, two_way)
    total, metrics = 0.0, {}
    for preds, gt in outputs:
        loss, metrics = _per_step_loss(preds, gt, loss_type)
        total = total + loss
    return total, {"loss": total, **metrics}


def train_step(model, optimizer, batch, kind: str = "fusionnet", loss_type: str = "L1-inv",
               two_way: bool = False, flip_mask: Sequence[bool] = (False,)):
    """One optimizer step on a decoded-or-wire batch already on the device.
    Gradients reach every parameter; ``optimizer`` updates its stage's.
    Returns the metrics as 0-dim device tensors (no host synchronisation)."""
    batch = decode_wire_batch(batch)
    model.zero_grad(set_to_none=True)  # frozen modules' gradients too
    if kind == "fusionnet":
        loss, metrics = fusionnet_loss_fn(model, batch, loss_type)
    else:
        loss, metrics = pairnet_loss_fn(model, batch, flip_mask, loss_type, two_way)
    loss.backward()
    optimizer.step()
    return {k: v.detach() for k, v in metrics.items()}


@torch.no_grad()
def eval_step(model, batch, kind: str = "fusionnet", loss_type: str = "L1-inv"):
    """Validation metrics with the model as the caller left it (the driver
    puts BatchNorm in eval mode); pairnet unflipped, one direction."""
    batch = decode_wire_batch(batch)
    if kind == "fusionnet":
        _, metrics = fusionnet_loss_fn(model, batch, loss_type)
    else:
        _, metrics = pairnet_loss_fn(model, batch, (False,), loss_type, False)
    return metrics
