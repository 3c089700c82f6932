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

CUDA graphs (``GraphedTrainStep``): the JAX package jits its train step
with the state donated and its eval step (dvmvs_tpu/parallel/train.py:157-227);
here each optimizer step is one replay of a graph that holds the forward,
``loss.backward()`` and ``optimizer.step()``, and each validation step one
replay of another. ``train_step`` and ``eval_step`` are themselves the
bodies the graphs capture: they read only their arguments, the weights and
the optimizer's state, never synchronise with the host, and write the
weights, the BatchNorm statistics and the Adam state in place. What makes
that hold for the optimizer: ``make_optimizer`` makes a capturable Adam
on the card (its step count lives on the device), and
``utils/optim.py::init_optimizer_state`` makes every state tensor before
the first step, so the capture sees them at fixed addresses and the warm-up
runs before it can be undone. ``model.zero_grad(set_to_none=True)`` at the
top of the step runs on the card only while the graph is captured: the
captured backward allocates every ``.grad`` from the graph's pool and each
replay overwrites it.

With a ``group`` the graphs hold the step's collectives too: the forward's
``SyncBatchNorm2d`` all-reduces and their backward ones, the loss's global
valid counts, the gradients' sum and the metrics' sum (NCCL kernels on the
stream, captured like any other; on the CPU, gloo has no capture and the
bodies run on the static buffers). What that needs: the NCCL communicator
exists before the capture (``make_data_parallel``'s broadcast makes it, and
the warm-up runs every collective of the step); every rank captures and
replays the same graphs in the same order, which holds because every rank
takes the same steps on batches of one shape (``run_training`` draws the
same global batches, drops the last partial one and cuts equal rows); and
the gradients live in one flat buffer that outlives the graph
(``flat_gradients``): the backward adds into its views and one all-reduce
sums it in place, so nothing the update reads is allocated per step.
``broadcast_state`` writes in place, so a resume state broadcast after a
capture reaches the graph.

Both steps, forward and backward, compute in IEEE float32, the reference's
mode, whatever the process's TF32 flags are (``utils/precision.py``), and
so do their graphs, captured in that mode.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from dvmvs_tpu_torch.apps.graphs import StepGraph, fill
from dvmvs_tpu_torch.config import MEAN_RGB, SCALE_RGB, STD_RGB
from dvmvs_tpu_torch.models.layers import convert_sync_batchnorm
from dvmvs_tpu_torch.models.training_heads import fusionnet_train_sequence, pairnet_train_pair
from dvmvs_tpu_torch.utils.losses import multi_scale_loss
from dvmvs_tpu_torch.utils.optim import init_optimizer_state
from dvmvs_tpu_torch.utils.precision import ieee_float32
from dvmvs_tpu_torch.utils.profiling import span

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
    parameters of ``trainable_modules``; AdamW when ``weight_decay`` > 0.

    On the card it is capturable: the step count lives on the device and the
    update never synchronises with the host, so a CUDA graph can capture it
    (torch refuses that on the CPU). Its update orders the arithmetic
    otherwise than the default one (the last bits differ), so steps compared
    bit for bit run on one device."""
    params = [p for name in trainable_modules for p in getattr(model, name).parameters()]
    kwargs = dict(lr=learning_rate, betas=(beta1, beta2), eps=1e-8,
                  capturable=params[0].device.type == "cuda")
    if weight_decay == 0.0:
        return torch.optim.Adam(params, **kwargs)
    return torch.optim.AdamW(params, weight_decay=weight_decay, **kwargs)


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
    tensors on the model's device (the default Adam's step counts stay on
    the host), each in place, so a graph captured before it reads the
    result."""
    src = dist.get_global_rank(group, 0)
    for t in model.state_dict().values():
        dist.broadcast(t, src, group=group)
    if optimizer is not None:
        device = next(model.parameters()).device
        for state in optimizer.state.values():
            for v in state.values():
                if torch.is_tensor(v) and v.device == device:
                    dist.broadcast(v, src, group=group)


def flat_gradients(model) -> torch.Tensor:
    """The one flat buffer that every parameter's gradient is a view of, in
    parameter order. Where the gradients are not such views (the first
    step, or after ``zero_grad(set_to_none=True)``), a new buffer is made
    from them (a missing gradient as zeros) and they are rebound to it;
    after that the backward adds into the views in place, so the buffer
    lives as long as the gradients do."""
    params = list(model.parameters())
    flat = params[0].grad._base if params[0].grad is not None else None
    offset = 0
    for p in params:
        if flat is None or p.grad is None or p.grad._base is not flat \
                or p.grad.storage_offset() != offset:
            flat = None
            break
        offset += p.numel()
    if flat is not None and offset == flat.numel():
        return flat
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    offset = 0
    for p in params:
        p.grad = flat[offset:offset + p.numel()].view_as(p)
        offset += p.numel()
    return flat


def all_reduce_gradients(model, group):
    """Sum every parameter's gradient over the group in place: one
    all-reduce of ``flat_gradients`` (a missing gradient counts as zero)."""
    dist.all_reduce(flat_gradients(model), group=group)


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


def pairnet_loss_fn(model, batch, flip_mask, loss_type: str = "L1-inv",
                    two_way: bool = False, group=None):
    """Loss over the pair's directions; ``flip_mask`` as
    ``pairnet_train_pair`` takes it (host bools or a device bool tensor)."""
    outputs = pairnet_train_pair(model, batch["images"], batch["depths"], batch["poses"],
                                 batch["K"], flip_mask, two_way)
    total, metrics = 0.0, {}
    for preds, gt in outputs:
        loss, metrics = _per_step_loss(preds, gt, loss_type, group)
        total = total + loss
    return total, {"loss": total, **metrics}


@ieee_float32()
def train_step(model, optimizer, batch, kind: str = "fusionnet", loss_type: str = "L1-inv",
               two_way: bool = False, flip_mask=(False,), group=None):
    """One optimizer step on a decoded-or-wire batch already on the device
    (with ``group``: this rank's rows of the global batch, and a model made
    by ``make_data_parallel``). Gradients reach every parameter;
    ``optimizer`` updates its stage's. Returns the metrics as 0-dim device
    tensors (no host synchronisation). Without a group this is also the body
    of the graphed step (module doc): ``flip_mask`` may then be a device
    bool tensor, one flag per pairnet direction. With ``group`` the
    gradients are zeroed in their flat buffer (``flat_gradients``) and the
    backward adds into it; the values are those of fresh gradients."""
    batch = decode_wire_batch(batch)
    if group is None:
        model.zero_grad(set_to_none=True)  # frozen modules' gradients too
    else:
        flat_gradients(model).zero_()
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


@ieee_float32()
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


class GraphedTrainStep:
    """``train_step`` and ``eval_step`` of one model, each run as an
    ``apps/graphs.py::StepGraph`` on static buffers (module doc): on the
    card one graph replay a step, on the CPU the same body on the same
    buffers without capture. With ``group`` (a model made by
    ``make_data_parallel``) the steps are the data-parallel ones, their
    collectives inside the graphs.

    A graph is keyed on its step, the train or eval mode of every module
    (read when the step is asked for, so a mode changed after a capture
    means another graph) and the batch's shapes and dtypes (the wire format:
    uint8 images and float16 depths, or float32). The train graphs belong
    to one optimizer, one a stage: a new optimizer drops them, sets the
    gradients (which live in the old graph's pool) to None and gives the
    pool back before its own capture. Every parameter, buffer and optimizer
    state tensor is restored after the warm-up runs, so warming up does not
    train. The metrics returned are buffers that the next step rewrites:
    read them before it. Loads of weights (``load_state_dict``) and of the
    optimizer state (``utils/checkpoint.py::load_optimizer_state``) copy in
    place, so they take effect in a graph captured before them. A capture or
    replay that fails raises; nothing runs eagerly instead. Under
    ``torch.profiler`` the batch's copy-in is the span ``dvmvs.train.fill``,
    the step ``dvmvs.graph.run``."""

    def __init__(self, model, kind: str = "fusionnet", loss_type: str = "L1-inv",
                 two_way: bool = False, group=None):
        self.model, self.kind, self.loss_type, self.two_way = model, kind, loss_type, two_way
        self.group = group
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.graphs: Dict[tuple, StepGraph] = {}

    def train(self, optimizer, batch: Dict[str, torch.Tensor], flip_mask=None):
        """One optimizer step on ``batch`` (device tensors); pairnet's
        ``flip_mask``: one bool a direction (a host tensor or sequence)."""
        if optimizer is not self.optimizer:
            self.drop()
            self.optimizer = optimizer
        step = self._graph("train", batch)
        if self.kind != "fusionnet":
            if flip_mask is None:
                raise ValueError("pairnet's graphed step needs a flip flag a direction")
            fill(step.args["flip_mask"], torch.as_tensor(flip_mask, dtype=torch.bool))
        return self._run(step, batch)

    def eval(self, batch: Dict[str, torch.Tensor]):
        """``eval_step`` on ``batch`` with the modules' modes as they are."""
        return self._run(self._graph("eval", batch), batch)

    def drop(self):
        """Drop the train graphs and their pools (a new stage)."""
        self.graphs = {k: g for k, g in self.graphs.items() if k[0] != "train"}
        self.optimizer = None
        self.model.zero_grad(set_to_none=True)
        if next(self.model.parameters()).is_cuda:
            torch.cuda.empty_cache()

    def _graph(self, name: str, batch) -> StepGraph:
        key = (name, tuple(m.training for m in self.model.modules()),
               tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(batch.items())))
        step = self.graphs.get(key)
        if step is None:
            args = {"batch": {k: torch.empty_like(v) for k, v in batch.items()}}
            state = [*self.model.parameters(), *self.model.buffers()]
            if name == "train":
                state += init_optimizer_state(self.optimizer)
                if self.group is not None:  # made here, on this stream, as the Adam state
                    flat_gradients(self.model)
                if self.kind != "fusionnet":
                    args["flip_mask"] = torch.zeros(2 if self.two_way else 1, dtype=torch.bool,
                                                    device=next(iter(batch.values())).device)
                body = functools.partial(train_step, self.model, self.optimizer,
                                         kind=self.kind, loss_type=self.loss_type,
                                         two_way=self.two_way, group=self.group)
            else:
                body = functools.partial(eval_step, self.model, kind=self.kind,
                                         loss_type=self.loss_type, group=self.group)
            step = self.graphs[key] = StepGraph(
                name, body, args, state, owner="run_training's",
                eager="run_training --no-graphs")
        return step

    def _run(self, step: StepGraph, batch):
        with span("dvmvs.train.fill"):
            for k, v in batch.items():
                fill(step.args["batch"][k], v)
        return step.run()
