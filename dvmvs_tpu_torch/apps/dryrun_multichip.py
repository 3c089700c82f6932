"""Data-parallel dry run at the smallest shapes (counterpart of
``dryrun_multichip`` in the JAX package's ``__graft_entry__.py``).

At world size n, with B = n (one row a rank), S = 2 and 64x64 frames, each
rank runs:

  1. one data-parallel fusionnet train step (``parallel/train.py``, every
     module trainable), a CUDA graph replay on the card as ``run_training``
     runs it (``GraphedTrainStep``), after which the parameters must be
     equal on every rank;
  2. one sharded pairnet prediction step (``InferenceEngine.predict_batch``
     on its rows, gathered);
  3. two sharded lockstep fusionnet steps (``fusion_step_batch``), the
     last scene's keep flag 0 in the first, so its state resets.

Every output must be finite and of the global batch's shape.

    torchrun --nproc-per-node N -m dvmvs_tpu_torch.apps.dryrun_multichip --n-devices N
    python -m dvmvs_tpu_torch.apps.dryrun_multichip --n-devices 1 [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

from dvmvs_tpu_torch.apps.engine import InferenceEngine
from dvmvs_tpu_torch.apps.run_training import make_model
from dvmvs_tpu_torch.config import TestConfig, TrainConfig
from dvmvs_tpu_torch.parallel import mesh
from dvmvs_tpu_torch.parallel.train import (
    FUSIONNET_STAGES,
    GraphedTrainStep,
    make_data_parallel,
    make_optimizer,
)
from dvmvs_tpu_torch.utils.precision import describe

S, H, W, V = 2, 64, 64, 2


def dryrun_batch(B: int) -> dict:
    """The JAX dry run's inputs: identity poses with a small x shift, depths
    in 0.5-8 m, images of std 0.1."""
    rs = np.random.RandomState(0)
    poses = np.stack([[np.eye(4, dtype=np.float32)] * S] * B)
    poses[:, 1:, 0, 3] += rs.uniform(0.1, 0.2, (B, S - 1)).astype(np.float32)
    K = np.array([[16.0, 0, W / 2], [0, 16.0, H / 2], [0, 0, 1]], np.float32)
    return {"images": rs.randn(B, S, H, W, 3).astype(np.float32) * 0.1,
            "depths": rs.uniform(0.5, 8.0, (B, S, H, W)).astype(np.float32),
            "poses": poses, "K": np.stack([K] * B)}


def _equal_on_every_rank(t: torch.Tensor, group) -> bool:
    ref = t.clone()
    dist.broadcast(ref, dist.get_global_rank(group, 0), group=group)
    same = torch.tensor([float(torch.equal(ref, t))], device=t.device)
    dist.all_reduce(same, op=dist.ReduceOp.MIN, group=group)
    return bool(same.item())


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(mesh.world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """Run the three steps at world size ``n_devices`` on the default group
    (joined here, and left again, unless the caller holds one). Returns the
    loss and the gathered depths; raises if a check fails."""
    own = not (dist.is_available() and dist.is_initialized())
    if own:
        group, dev = mesh.init_data_parallel(n_devices, device=device)
    else:
        group = dist.group.WORLD
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
    try:
        return _dryrun(group, dev, n_devices)
    finally:
        if own:
            mesh.destroy()


def _dryrun(group, dev, n_devices: int) -> dict:
    world, rank = mesh.world_size(group), mesh.rank(group)
    if world != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) in a group of {world}")
    B = n_devices
    global_batch = dryrun_batch(B)
    rows = mesh.shard_rows(global_batch, rank, world)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in rows.items()}

    model = make_model("fusionnet", TrainConfig(), dev, seed=0)
    make_data_parallel(model, group)
    optimizer = make_optimizer(model, FUSIONNET_STAGES[2])
    loss = float(GraphedTrainStep(model, group=group).train(optimizer, batch)["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    if not _equal_on_every_rank(flat, group):
        raise AssertionError("parameters differ between ranks after the step")
    print(f"dryrun_multichip({n_devices}): one data-parallel train step OK, loss={loss:.4f}",
          flush=True)

    cfg = TestConfig(image_width=W, image_height=H, n_measurement_frames=V)
    ref = batch["images"][:, 0].permute(0, 3, 1, 2).contiguous()
    meas_pose = batch["poses"][:, 1:2].repeat(1, V, 1, 1)
    mask = torch.ones((len(ref), V), device=dev)

    pair = InferenceEngine("pairnet", cfg, device=str(dev), seed=1)
    feats = pair.encode_batch(ref)
    meas_half = torch.stack([feats[0]] * V, dim=1)
    depth = _gather(pair.predict_batch(ref, feats, meas_half, batch["poses"][:, 0], meas_pose,
                                       batch["K"], mask), group)
    if depth.shape != (B, H, W) or not torch.isfinite(depth).all():
        raise AssertionError(f"sharded serving step: {tuple(depth.shape)}, finite "
                             f"{bool(torch.isfinite(depth).all())}")
    print(f"dryrun_multichip({n_devices}): one sharded serving step OK", flush=True)

    fusion = InferenceEngine("fusionnet", cfg, device=str(dev), seed=0)
    feats = fusion.encode_batch(ref)
    meas_half = torch.stack([feats[0]] * V, dim=1)
    state = fusion.init_batch_state(len(ref))
    keep_global = torch.ones((B,), device=dev)
    keep_global[-1] = 0.0  # the last scene loses tracking: its state resets
    keep = mesh.shard_rows({"k": keep_global}, rank, world)["k"]
    for _ in range(2):  # two steps, so the carry and previous depth recur
        out, state = fusion.fusion_step_batch(ref, feats, meas_half, batch["poses"][:, 0],
                                              meas_pose, batch["K"], mask, state, keep)
        keep = torch.ones_like(keep)
    fused = _gather(out, group)
    if fused.shape != (B, H, W) or not torch.isfinite(fused).all():
        raise AssertionError(f"lockstep serving steps: {tuple(fused.shape)}")
    print(f"dryrun_multichip({n_devices}): two sharded lockstep recurrent steps OK", flush=True)
    return {"loss": loss, "pair_depth": depth.cpu(), "fusion_depth": fused.cpu()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n-devices", type=int, required=True)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    print(f"dryrun_multichip({args.n_devices}) on {args.device}; {describe()}", flush=True)
    dryrun_multichip(args.n_devices, args.device)


if __name__ == "__main__":
    main()
