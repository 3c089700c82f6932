"""Training driver for pairnet / fusionnet, on one device or data-parallel
over several (counterpart of dvmvs_tpu/apps/run_training.py; reference:
dvmvs/train.py, dvmvs/{pairnet,fusionnet}/run-training.py).

The reference schedule: staged unfreeze (pairnet 2 stages, fusionnet 3),
Adam(1e-4), L1-inv loss over 5 scales, per-epoch validation with BatchNorm in
eval mode, a checkpoint on improvement and a resume state after every epoch,
with a double-buffered host->device input pipeline. Fusionnet's validation
also writes depth panels of its first batch (``panels/epoch<N>_{pred,gt}.png``
in the run directory, the turbo map of ``utils/visualization.py``), as the
JAX driver does.

    python -m dvmvs_tpu_torch.apps.run_training --model fusionnet --dataset DIR

DIR holds the training layout of scripts/make_synth_scenes.py (per-frame
``.npz`` archives, ``poses.txt``, ``K.txt``, ``train.txt`` and
``validation.txt``). Frames stored at another size than the training size
are resized on the host (``data/preprocess.py::resize``).

Data parallel, one process a card (``parallel/mesh.py``):

    torchrun --nproc-per-node N -m dvmvs_tpu_torch.apps.run_training --n-devices N ...

or, without torchrun, ``--multihost --coordinator-address HOST:PORT
--num-processes N --process-id R`` in each process. ``--batch-size`` is the
global batch and must divide by N. Every rank draws the same shuffled
global batch (so the augmentation streams are those of one process) and
uploads its rows; the step is that of the global batch
(``parallel/train.py``). Rank 0 alone writes the run directory, the
checkpoints, ``metrics.jsonl`` and the resume state. ``--n-devices 1``
runs the data-parallel path in one process.

Each optimizer step is one CUDA graph replay and each validation step
another (``parallel/train.py::GraphedTrainStep``), the JAX package's jitted
and donated train step and jitted eval step, on one device and on each rank
of a data-parallel group (the collectives inside the graphs, as the JAX
package jits its steps over the mesh); on the CPU the same bodies run on
static buffers. Each stage's new optimizer means a new capture, and the
previous stage's graph and its pool are dropped first. ``--no-graphs`` is
the eager path. A capture or replay that fails raises: nothing carries on
eagerly.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from dvmvs_tpu_torch.config import TrainConfig
from dvmvs_tpu_torch.data.dataset import MVSSequenceDataset, batch_iterator, device_prefetch
from dvmvs_tpu_torch.data.io import write_png
from dvmvs_tpu_torch.models.fusionnet import FusionNet
from dvmvs_tpu_torch.models.layers import init_parameters
from dvmvs_tpu_torch.models.pairnet import PairNet
from dvmvs_tpu_torch.models.training_heads import fusionnet_train_sequence
from dvmvs_tpu_torch.parallel import mesh
from dvmvs_tpu_torch.parallel.train import (
    FUSIONNET_STAGES,
    PAIRNET_STAGES,
    GraphedTrainStep,
    broadcast_state,
    decode_wire_batch,
    eval_step,
    make_data_parallel,
    make_optimizer,
    train_step,
)
from dvmvs_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_resume_state,
    read_resume_meta,
    save_checkpoint,
    write_resume_state,
)
from dvmvs_tpu_torch.utils.losses import LossMeter
from dvmvs_tpu_torch.utils.precision import describe, ieee_float32
from dvmvs_tpu_torch.utils.run_logging import RunLogger, snapshot_code
from dvmvs_tpu_torch.utils.visualization import colorize_depth

VALIDATION_KEYS = ("l1", "l1_inv", "l1_rel", "huber")


def stage_epoch_budget(n_stages: int, stage_i: int, epoch: int,
                       finetune_epochs: int, total_epochs: int) -> int:
    """Epochs left to run in stage ``stage_i`` given the global ``epoch``
    counter. Every non-last stage runs exactly ``finetune_epochs``; the last
    stage runs whatever remains of ``total_epochs``. On a mid-stage
    ``--resume`` the global counter is past the stage's start, so subtract
    the epochs this stage already completed."""
    if stage_i == n_stages - 1:
        return total_epochs - epoch
    return finetune_epochs - max(0, epoch - stage_i * finetune_epochs)


def make_model(kind: str, cfg: TrainConfig, device, seed: int = 0):
    """PairNet or FusionNet with weights drawn from a seeded generator."""
    d = cfg.depth
    net = FusionNet if kind == "fusionnet" else PairNet
    model = net(d.min_depth, d.max_depth, d.n_depth_levels)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device)


def rank_batches(dataset, batch_size: int, shuffle: bool, seed: int = 0, group=None):
    """The global batches of ``batch_iterator``, each cut to this rank's
    rows when there is a group."""
    batches = batch_iterator(dataset, batch_size, shuffle=shuffle, seed=seed)
    if group is None:
        return batches
    r, w = mesh.rank(group), mesh.world_size(group)
    return (mesh.shard_rows(b, r, w) for b in batches)


def run_epoch(model, optimizer, dataset, cfg: TrainConfig, device, seed: int, kind: str,
              two_way: bool, flip_generator: torch.Generator, freeze_bn: bool = False,
              print_frequency: int = 100, max_steps=None, logger=None,
              group=None, steps: GraphedTrainStep = None) -> LossMeter:
    """One pass over the shuffled training set (at most ``max_steps``
    optimizer steps), each step a replay of ``steps``' graph when given,
    else eager. Every ``print_frequency`` steps the loss is read back
    (the only host synchronisation) and printed, and the step's wall time
    logged (rank 0 prints; the caller gives rank 0 alone a ``logger``)."""
    meter = LossMeter()
    model.train(not freeze_bn)
    batches = device_prefetch(rank_batches(dataset, cfg.batch_size, True, seed, group), device)
    t0 = t_last = time.time()
    n = n_last = 0
    try:
        for batch in batches:
            if max_steps is not None and n >= max_steps:
                break
            # pairnet's flip per direction, drawn on the host (no device
            # sync), the same draws on both paths
            flip_mask = torch.rand(2 if two_way else 1, generator=flip_generator) > 0.5
            if steps is None:
                metrics = train_step(model, optimizer, batch, kind, cfg.loss_type, two_way,
                                     flip_mask.tolist(), group)
            else:
                metrics = steps.train(optimizer, batch, flip_mask)
            n += 1
            if n % print_frequency == 0:
                loss = float(metrics["loss"])
                meter.update(loss, 1)
                now = time.time()
                rate = n * cfg.batch_size / (now - t0)
                step_ms = (now - t_last) * 1e3 / (n - n_last)
                t_last, n_last = now, n
                if mesh.rank(group) == 0:
                    print(f"  step {n}: loss {loss:.4f} ({meter.avg:.4f} avg) {rate:.1f} "
                          f"samples/s ({step_ms:.1f} ms/step)", flush=True)
                if logger is not None:
                    logger.log(n, "train", {"loss": loss, "samples_per_s": rate,
                                            "step_ms": step_ms})
    finally:
        batches.close()
    return meter


@torch.no_grad()
def validate(model, dataset, cfg: TrainConfig, device, kind: str, freeze_bn: bool = False,
             group=None, panels=None, epoch: int = 0, steps: GraphedTrainStep = None):
    """Mean l1 / l1-inv / l1-rel / huber (of the last scale, see
    parallel/train.py) over the validation set, BatchNorm in eval mode;
    the model goes back to its training mode afterwards; each step a replay
    of ``steps``' eval graph when given. With a group each
    rank runs its rows and the sums are the global batches'. With
    ``panels`` (a directory) fusionnet's full-resolution depth of the first
    batch's first sample at its last step is written beside its ground
    truth, coloured (the reference's periodic image grid, dvmvs/train.py:47-77)."""
    meters = {k: LossMeter() for k in VALIDATION_KEYS}
    first = None
    model.eval()
    try:
        for batch in device_prefetch(rank_batches(dataset, cfg.batch_size, False, group=group),
                                     device):
            first = batch if first is None else first
            if steps is None:
                metrics = eval_step(model, batch, kind, cfg.loss_type, group)
            else:
                metrics = steps.eval(batch)
            count = max(float(metrics["valid_count"]), 1.0)
            for k in meters:
                meters[k].update(float(metrics[k]), count)
        if panels is not None and kind == "fusionnet" and first is not None:
            batch = decode_wire_batch(first)
            with ieee_float32():
                full = fusionnet_train_sequence(model, batch["images"], batch["depths"],
                                                batch["poses"], batch["K"])[0]
            os.makedirs(panels, exist_ok=True)
            for name, depth in (("pred", full[-1, 0]), ("gt", batch["depths"][0, -1])):
                write_png(os.path.join(panels, f"epoch{epoch:04d}_{name}.png"),
                          colorize_depth(depth.float().cpu().numpy()))
    finally:
        model.train(not freeze_bn)
    return [meters[k].avg for k in VALIDATION_KEYS]


def _run_directory(root: str) -> str:
    base = os.path.join(root, time.strftime("%Y%m%d-%H%M%S"))
    path, i = base, 0
    while os.path.exists(path):
        i += 1
        path = f"{base}-{i}"
    os.makedirs(path)
    return path


def main(argv=None) -> str:
    """Train; returns the run directory."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", choices=["pairnet", "fusionnet"], default="fusionnet")
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--run-directory", default="training-runs")
    ap.add_argument("--warm-start", default=None,
                    help="checkpoint of the port or of the JAX package (Flax msgpack) to "
                         "initialise from, module by module")
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--finetune-epochs", type=int, default=None,
                    help="epochs per non-final unfreeze stage (default: the reference "
                         "schedule, 2 for pairnet, 1 for fusionnet)")
    ap.add_argument("--print-frequency", type=int, default=None,
                    help="log every N steps (default TrainConfig.print_frequency; 2 under "
                         "--max-steps)")
    ap.add_argument("--no-validate", action="store_true",
                    help="skip per-epoch validation (checkpoint every epoch)")
    ap.add_argument("--seed", type=int, default=0,
                    help="weights, sample order, augmentation and pairnet flips")
    ap.add_argument("--image-size", type=int, nargs=2, default=None, metavar=("W", "H"),
                    help="override train resolution")
    ap.add_argument("--subsequence-length", type=int, default=None)
    ap.add_argument("--max-steps", type=int, default=None,
                    help="cap optimizer steps per epoch (smoke runs)")
    ap.add_argument("--freeze-bn", action="store_true",
                    help="freeze BatchNorm (running stats, no updates)")
    ap.add_argument("--resume", default=None,
                    help="resume state (<kind>_latest.state.pt) to continue from")
    ap.add_argument("--wire-compact", action="store_true",
                    help="ship uint8 images + f16 depths to the device and normalise there")
    ap.add_argument("--data-workers", type=int, default=1,
                    help="crawler worker processes")
    ap.add_argument("--no-graphs", action="store_true",
                    help="run each train and validation step eagerly instead of as a CUDA "
                         "graph replay")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises if there is no card) or cpu")
    ap.add_argument("--n-devices", type=int, default=None,
                    help="data parallel over this many devices, one process each (the "
                         "world size of torchrun or --multihost; 1 runs the data-parallel "
                         "path in this process)")
    ap.add_argument("--multihost", action="store_true",
                    help="join a process group at --coordinator-address without torchrun")
    ap.add_argument("--coordinator-address", default=None, help="host:port of rank 0")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    args = ap.parse_args(argv)

    kind = args.model
    overrides = dict(
        subsequence_length=args.subsequence_length or (8 if kind == "fusionnet" else 2),
        batch_size=args.batch_size or (4 if kind == "fusionnet" else 14),
        seed=args.seed,
        data_pipeline_workers=args.data_workers,
        finetune_epochs=(args.finetune_epochs if args.finetune_epochs is not None
                         else (2 if kind == "pairnet" else 1)),
    )
    if args.epochs is not None:
        overrides["epochs"] = args.epochs
    if args.image_size is not None:
        overrides["image_width"], overrides["image_height"] = args.image_size
    if args.print_frequency is not None:
        overrides["print_frequency"] = args.print_frequency
    if args.no_validate:
        overrides["validate"] = False
    cfg = TrainConfig(**overrides)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"run_training: --device {args.device} asked for, but "
                           "torch.cuda.is_available() is false; pass --device cpu to train on "
                           "the CPU")
    freeze_bn = args.freeze_bn or cfg.freeze_batch_normalization
    group = None
    if args.n_devices is not None or args.multihost or "WORLD_SIZE" in os.environ:
        group, device = mesh.init_data_parallel(args.n_devices, args.multihost,
                                                args.coordinator_address, args.num_processes,
                                                args.process_id, args.device)
        if cfg.batch_size % mesh.world_size(group):
            raise SystemExit(f"--batch-size {cfg.batch_size} must divide by the "
                             f"{mesh.world_size(group)} devices")
    try:
        return _train(args, kind, cfg, device, freeze_bn, group)
    finally:
        if group is not None:
            mesh.destroy()


def _train(args, kind: str, cfg: TrainConfig, device, freeze_bn: bool, group) -> str:
    lead = mesh.rank(group) == 0
    run_dir = _run_directory(args.run_directory) if lead else None
    if lead:
        print(f"run directory: {run_dir} (device {device}, {mesh.world_size(group)} "
              f"process(es); {describe()})", flush=True)
    model = make_model(kind, cfg, device, args.seed)
    if args.warm_start:
        fresh = load_checkpoint(args.warm_start, model, partial=True)
        if lead:
            print(f"warm-started from {args.warm_start}; fresh: {fresh or 'none'}")
    if group is not None:
        make_data_parallel(model, group)

    train_set = MVSSequenceDataset(
        args.dataset, "TRAINING", cfg.subsequence_length, cfg,
        geometric_scale_augmentation=True, seed=args.seed, wire_compact=args.wire_compact)
    val_set = MVSSequenceDataset(
        args.dataset, "VALIDATION", cfg.subsequence_length, cfg,
        seed=args.seed, wire_compact=args.wire_compact)
    if lead:
        print(f"{len(train_set)} train samples, {len(val_set)} val samples", flush=True)
        logger = RunLogger(run_dir)
        snapshot_code(run_dir)
    else:
        logger = None
    stages = FUSIONNET_STAGES if kind == "fusionnet" else PAIRNET_STAGES
    two_way = kind == "pairnet" and cfg.predict_two_way
    steps = None
    if not args.no_graphs:
        steps = GraphedTrainStep(model, kind, cfg.loss_type, two_way, group)
    flip_generator = torch.Generator().manual_seed(args.seed)
    print_freq = cfg.print_frequency
    if args.max_steps is not None and args.print_frequency is None:
        print_freq = 2

    best_loss = [np.inf] * len(VALIDATION_KEYS)
    epoch = resume_stage = 0
    if args.resume:
        meta = read_resume_meta(args.resume)
        epoch, resume_stage = meta["epoch"], meta["stage"]
        best_loss = meta.get("best_loss", best_loss)
        print(f"resuming from {args.resume}: epoch {epoch}, stage {resume_stage}")

    try:
        for stage_i, modules in enumerate(stages):
            if stage_i < resume_stage:
                continue
            # a fresh optimizer per stage: new parameter set, zero moments
            optimizer = make_optimizer(model, modules, cfg.learning_rate, cfg.adam_beta1,
                                       cfg.adam_beta2, cfg.weight_decay)
            if args.resume and stage_i == resume_stage:
                load_resume_state(args.resume, model, optimizer)
                if group is not None:
                    broadcast_state(model, group, optimizer)
            n_epochs = stage_epoch_budget(len(stages), stage_i, epoch, cfg.finetune_epochs,
                                          cfg.epochs)
            for _ in range(n_epochs):
                if lead:
                    print(f"\nEPOCH {epoch} (stage {stage_i}: {modules})", flush=True)
                run_epoch(model, optimizer, train_set, cfg, device, args.seed + epoch, kind,
                          two_way, flip_generator, freeze_bn, print_freq, args.max_steps,
                          logger, group, steps)
                # the resume state is written before validation, so a run
                # killed while validating resumes after this epoch
                if lead:
                    write_resume_state(run_dir, kind, model, optimizer, epoch + 1, stage_i,
                                       best_loss)
                improved = True
                if cfg.validate:
                    losses = validate(model, val_set, cfg, device, kind, freeze_bn, group,
                                      os.path.join(run_dir, "panels") if lead else None, epoch,
                                      steps)
                    improved = any(v < b for v, b in zip(losses, best_loss))
                    if improved:
                        best_loss = [min(v, b) for v, b in zip(losses, best_loss)]
                    if lead:
                        print("  validation l1/l1-inv/l1-rel/huber: "
                              + " ".join(f"{v:.4f}" for v in losses), flush=True)
                        logger.log(epoch, "validation", dict(zip(VALIDATION_KEYS, losses)),
                                   epoch=epoch)
                        if improved:
                            write_resume_state(run_dir, kind, None, None, epoch + 1, stage_i,
                                               best_loss)
                if improved and lead:
                    ckpt = os.path.join(run_dir, f"{kind}_epoch{epoch}.pt")
                    save_checkpoint(ckpt, model)
                    print("  saved", ckpt, flush=True)
                epoch += 1
    finally:
        if logger is not None:
            logger.close()
    return run_dir


if __name__ == "__main__":
    main()
