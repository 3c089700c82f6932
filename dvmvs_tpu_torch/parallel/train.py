"""Training steps with the reference's staged-unfreeze schedule, on one
device or data-parallel over a process group (counterpart of
dvmvs_tpu/parallel/train.py).

Each stage trains a subset of the top-level modules (fusionnet: LSTM +
decoder, then + FPN + encoder, then everything; pairnet: two stages). The
JAX package masks optax updates by module; here each stage gets a fresh
``torch.optim.Adam`` (``AdamW`` with weight decay) over the parameters of
its modules, which also resets the moments, as the JAX driver's
``tx.init`` does. Gradients are still computed for every parameter, and
frozen modules stay in train mode, so their BatchNorm statistics keep
updating as in the JAX step; only ``freeze_bn`` puts BatchNorm in eval
mode.

Data parallel (``group``, see ``parallel/mesh.py``): every rank holds the
same parameters (``make_data_parallel``) and its rows of the global batch.
The step is that of the global batch, as the JAX step under pjit: the
BatchNorm statistics are the global batch's (``SyncBatchNorm2d``), each
scale's loss divides this rank's sum by the global valid count, so the
ranks' losses sum to the global loss, and the gradients are summed (not
averaged) over the ranks. The metrics returned are summed too, so they are
the global batch's on every rank. With no group the step is the one-device
step, unchanged.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

from dvmvs_tpu_torch.config import MEAN_RGB, SCALE_RGB, STD_RGB
from dvmvs_tpu_torch.models.layers import convert_sync_batchnorm
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


def make_data_parallel(model, group):
    """Make ``model`` a replica of rank 0's over ``group``: its BatchNorm
    layers synced (``convert_sync_batchnorm``; do it before an optimizer
    is made over its parameters), then its parameters and buffers
    broadcast from rank 0. Returns the model."""
    convert_sync_batchnorm(model, group)
    broadcast_state(model, group)
    return model


def broadcast_state(model, group, optimizer=None):
    """Broadcast rank 0's parameters, buffers and the optimizer's state
    tensors on the model's device (Adam's step counts stay on the host)."""
    src = dist.get_global_rank(group, 0)
    for t in model.state_dict().values():
        dist.broadcast(t, src, group=group)
    if optimizer is not None:
        device = next(model.parameters()).device
        for state in optimizer.state.values():
            for v in state.values():
                if torch.is_tensor(v) and v.device == device:
                    dist.broadcast(v, src, group=group)


def all_reduce_gradients(model, group):
    """Sum every parameter's gradient over the group (one all-reduce of one
    flat buffer; a missing gradient counts as zero)."""
    params = list(model.parameters())
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    dist.all_reduce(flat, group=group)
    offset = 0
    for p in params:
        p.grad = flat[offset:offset + p.numel()].view_as(p)
        offset += p.numel()


def _sum_metrics(metrics: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    keys = sorted(metrics)
    summed = torch.stack([metrics[k].detach() for k in keys])
    dist.all_reduce(summed, group=group)
    return dict(zip(keys, summed))


def _per_step_loss(preds: Sequence[torch.Tensor], gt: torch.Tensor, loss_type: str, group=None):
    """Sum over scales of loss_sum / valid_count; gt (B, H, W). The metrics
    are those of the last scale in the decoder's order, which is 1/16 (the
    JAX package's comment calls it full resolution; its order is full ..
    one_sixteen)."""
    return multi_scale_loss(preds, [1.0] * len(preds), gt, loss_type, group)


def fusionnet_loss_fn(model, batch, loss_type: str = "L1-inv", group=None):
    """Loss over a subsequence batch (images (B, S, H, W, 3), depths
    (B, S, H, W), poses (B, S, 4, 4), K (B, 3, 3)) -> (loss, metrics of the
    last step)."""
    preds = fusionnet_train_sequence(model, batch["images"], batch["depths"], batch["poses"],
                                     batch["K"])
    total, metrics = 0.0, {}
    for t in range(preds[0].shape[0]):
        loss, metrics = _per_step_loss([p[t] for p in preds], batch["depths"][:, t + 1],
                                       loss_type, group)
        total = total + loss
    return total, {"loss": total, **metrics}


def pairnet_loss_fn(model, batch, flip_mask: Sequence[bool], loss_type: str = "L1-inv",
                    two_way: bool = False, group=None):
    outputs = pairnet_train_pair(model, batch["images"], batch["depths"], batch["poses"],
                                 batch["K"], flip_mask, two_way)
    total, metrics = 0.0, {}
    for preds, gt in outputs:
        loss, metrics = _per_step_loss(preds, gt, loss_type, group)
        total = total + loss
    return total, {"loss": total, **metrics}


def train_step(model, optimizer, batch, kind: str = "fusionnet", loss_type: str = "L1-inv",
               two_way: bool = False, flip_mask: Sequence[bool] = (False,), group=None):
    """One optimizer step on a decoded-or-wire batch already on the device
    (with ``group``: this rank's rows of the global batch, and a model made
    by ``make_data_parallel``). Gradients reach every parameter;
    ``optimizer`` updates its stage's. Returns the metrics as 0-dim device
    tensors (no host synchronisation)."""
    batch = decode_wire_batch(batch)
    model.zero_grad(set_to_none=True)  # frozen modules' gradients too
    if kind == "fusionnet":
        loss, metrics = fusionnet_loss_fn(model, batch, loss_type, group)
    else:
        loss, metrics = pairnet_loss_fn(model, batch, flip_mask, loss_type, two_way, group)
    loss.backward()
    if group is not None:
        all_reduce_gradients(model, group)
    optimizer.step()
    if group is not None:
        return _sum_metrics(metrics, group)
    return {k: v.detach() for k, v in metrics.items()}


@torch.no_grad()
def eval_step(model, batch, kind: str = "fusionnet", loss_type: str = "L1-inv", group=None):
    """Validation metrics with the model as the caller left it (the driver
    puts BatchNorm in eval mode); pairnet unflipped, one direction. With
    ``group`` they are summed over the ranks' rows."""
    batch = decode_wire_batch(batch)
    if kind == "fusionnet":
        _, metrics = fusionnet_loss_fn(model, batch, loss_type, group)
    else:
        _, metrics = pairnet_loss_fn(model, batch, (False,), loss_type, False, group)
    return metrics if group is None else _sum_metrics(metrics, group)
