"""Data-parallel process groups over ``torch.distributed`` (counterpart of
dvmvs_tpu/parallel/mesh.py).

The JAX package runs one program over a 1-D ``data`` mesh and lets the
shardings place the all-reduces. Here each device is driven by its own
process (rank r on ``cuda:{local rank}``): the parameters are replicated,
each rank takes its contiguous rows of the global batch (``shard_rows``),
and the training step reduces the BatchNorm statistics, the loss
normalisers and the gradients over the group (``parallel/train.py``,
``models/layers.py::SyncBatchNorm2d``).

The backend follows the device asked for: NCCL on cards, gloo on the CPU.
Under ``torchrun`` the group comes from its environment (``env://``);
otherwise from a ``tcp://`` coordinator (``--multihost``), or, for one
process, a free local port.
"""

from __future__ import annotations

import os
import socket
from typing import Optional, Tuple

import torch
import torch.distributed as dist


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_data_parallel(n_devices: Optional[int] = None, multihost: bool = False,
                       coordinator_address: Optional[str] = None,
                       num_processes: Optional[int] = None, process_id: Optional[int] = None,
                       device: str = "cuda") -> Tuple[object, torch.device]:
    """Join (or start) the default process group; returns (group, this
    rank's device).

    - under ``torchrun`` (``WORLD_SIZE`` in the environment): ``env://``;
    - ``multihost``: ``tcp://<coordinator_address>`` with ``num_processes``
      ranks, this one ``process_id``;
    - otherwise one process: world size 1 on a free local port, so
      ``n_devices`` may only be 1 (more devices take more processes).

    ``n_devices``, where given, must equal the world size; on cards it may
    not exceed the cards there are. Rank r binds to ``cuda:{LOCAL_RANK}``
    (``process_id`` modulo the local cards under ``multihost``)."""
    kind = torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"init_data_parallel: device {device!r} asked for, but "
                           "torch.cuda.is_available() is false")
    if kind == "cuda" and n_devices is not None and not multihost \
            and n_devices > torch.cuda.device_count():
        raise ValueError(f"requested {n_devices} devices, only {torch.cuda.device_count()} "
                         "available")
    if "WORLD_SIZE" in os.environ:
        init, world, rank = "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    elif multihost:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("--multihost needs --coordinator-address, --num-processes and "
                             "--process-id (or a torchrun launch)")
        init, world, rank = f"tcp://{coordinator_address}", num_processes, process_id
        local_rank = rank % max(torch.cuda.device_count(), 1) if kind == "cuda" else rank
    else:
        if n_devices not in (None, 1):
            raise ValueError(f"--n-devices {n_devices} needs {n_devices} processes: launch "
                             f"with torchrun --nproc-per-node {n_devices} (or --multihost)")
        init, world, rank, local_rank = f"tcp://127.0.0.1:{_free_port()}", 1, 0, 0
    if n_devices is not None and n_devices != world:
        raise ValueError(f"--n-devices {n_devices} but the group has {world} processes")
    if kind == "cuda":
        torch.cuda.set_device(local_rank)
        dev = torch.device("cuda", local_rank)
    else:
        dev = torch.device("cpu")
    dist.init_process_group("nccl" if kind == "cuda" else "gloo", init_method=init,
                            world_size=world, rank=rank)
    return dist.group.WORLD, dev


def world_size(group=None) -> int:
    """The group's size; 1 where there is no process group."""
    return dist.get_world_size(group) if dist.is_available() and dist.is_initialized() else 1


def rank(group=None) -> int:
    """This process's rank in the group; 0 where there is no process group."""
    return dist.get_rank(group) if dist.is_available() and dist.is_initialized() else 0


def shard_rows(batch, rank: int, world: int):
    """This rank's contiguous rows of a global batch (a dict of arrays or
    tensors with the batch first); the batch must divide by ``world``."""
    n = len(next(iter(batch.values())))
    if n % world:
        raise ValueError(f"a batch of {n} does not divide over {world} ranks")
    rows = n // world
    return {k: v[rank * rows:(rank + 1) * rows] for k, v in batch.items()}


def destroy():
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
