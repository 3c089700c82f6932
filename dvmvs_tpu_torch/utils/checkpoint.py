"""Checkpoints of the port (counterpart of dvmvs_tpu/utils/checkpoint.py).

A model checkpoint is ``torch.save`` of ``{module name: state_dict}`` under
the reference's module names (``feature_extractor``, ``feature_shrinker``,
``cost_volume_encoder``, ``lstm_fusion``, ``cost_volume_decoder``), whose
keys are the original per-module checkpoints' own. A resume state adds the
optimizer's state, and a ``.meta.json`` beside it holds the epoch, the stage
and the best validation losses. Every file is written to a temporary name
and moved into place with ``os.replace``, so a run killed at any instant
leaves the previous file or the new one, never half of one. Loading maps
tensors to the model's device; a partial load (pairnet into fusionnet's
shared modules) goes module by module.

The JAX package's checkpoints (``dvmvs_tpu/utils/checkpoint.py``: the
Flax ``{"params", "batch_stats"}`` tree as msgpack) are read and written
here without flax (``utils/msgpack.py``) through the weight bridge
(``utils/weights.py``). ``load_checkpoint`` tells the two formats apart by
content (``is_jax_checkpoint``), so every ``--checkpoint`` and
``--warm-start`` takes either.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import torch

from dvmvs_tpu_torch.utils import msgpack
from dvmvs_tpu_torch.utils.weights import jax_variables, load_jax_variables

MODULE_NAMES = ("feature_extractor", "feature_shrinker", "cost_volume_encoder",
                "lstm_fusion", "cost_volume_decoder")


def _atomic_save(obj, path: str, save=torch.save):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    save(obj, tmp)
    os.replace(tmp, path)


def _modules(model) -> Dict[str, torch.nn.Module]:
    return {name: getattr(model, name) for name in MODULE_NAMES if hasattr(model, name)}


def model_state(model) -> Dict[str, dict]:
    return {name: module.state_dict() for name, module in _modules(model).items()}


def save_checkpoint(path: str, model):
    _atomic_save(model_state(model), path)


def _device(model) -> torch.device:
    return next(model.parameters()).device


def load_checkpoint(path: str, model, partial: bool = False) -> Sequence[str]:
    """Load a checkpoint of the port or of the JAX package into ``model``;
    with ``partial`` a module the checkpoint lacks keeps its values (a
    pairnet checkpoint warm-starts fusionnet, whose ``lstm_fusion`` stays
    fresh). Returns the names of the modules kept fresh."""
    if is_jax_checkpoint(path):
        return load_jax_checkpoint(path, model, partial)
    state = torch.load(path, map_location=_device(model), weights_only=True)
    fresh = []
    for name, module in _modules(model).items():
        if name in state:
            module.load_state_dict(state[name], strict=True)
        elif partial:
            fresh.append(name)
        else:
            raise KeyError(f"{path} holds no {name!r} (modules: {sorted(state)})")
    return fresh


def is_jax_checkpoint(path: str) -> bool:
    """Whether ``path`` holds a msgpack map with a str key first, as Flax
    writes a variables tree. The port's ``torch.save`` files are zip archives
    ("PK"); a legacy pickle starts with 0x80, which as msgpack is an empty
    map and is refused here."""
    with open(path, "rb") as f:
        head = f.read(6)
    if not head:
        return False
    b, skip = head[0], {0xde: 3, 0xdf: 5}.get(head[0], 1)
    if not (0x81 <= b <= 0x8f or b in (0xde, 0xdf)) or len(head) <= skip:
        return False
    key = head[skip]
    return 0xa0 <= key <= 0xbf or key in (0xd9, 0xda, 0xdb)


def _numpy(tree):
    """Tensor leaves of a decoded tree as NumPy arrays (bfloat16, which NumPy
    lacks, as float32)."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return (tree.float() if tree.dtype == torch.bfloat16 else tree).numpy()
    return tree


def read_jax_variables(path: str) -> dict:
    """The raw tree of a Flax msgpack file, NumPy leaves (the JAX package's
    ``load_checkpoint(path, None)``)."""
    with open(path, "rb") as f:
        return _numpy(msgpack.unpackb(f.read()))


def load_jax_checkpoint(path: str, model, partial: bool = False) -> Sequence[str]:
    """Load a checkpoint written by the JAX package (``save_checkpoint`` of
    its PairNet or FusionNet variables) into ``model``, on the model's
    device. With ``partial`` (``load_checkpoint_partial``, the warm start) a
    module the file lacks keeps its values and is printed as the JAX package
    prints it. Returns the names of the modules kept fresh."""
    variables = read_jax_variables(path)
    params, stats = variables.get("params", {}), variables.get("batch_stats", {})
    fresh = [name for name in _modules(model) if name not in params]
    if fresh and not partial:
        raise KeyError(f"{path} holds no {fresh[0]!r} (modules: {sorted(params)})")
    for name in fresh:
        print(f"warm-start: keeping fresh init for /params/{name}")
    load_jax_variables(model, variables, skip=fresh)
    return fresh


def save_jax_checkpoint(path: str, model):
    """Write ``model``'s weights as the JAX package's ``save_checkpoint``
    writes its variables: the bytes Flax writes for the same tree."""
    def write(tree, tmp):
        with open(tmp, "wb") as f:
            f.write(msgpack.packb(tree))

    _atomic_save(jax_variables(model), path, save=write)


def resume_path(run_dir: str, kind: str) -> str:
    return os.path.join(run_dir, f"{kind}_latest.state.pt")


def write_resume_state(run_dir: str, kind: str, model, optimizer: Optional[torch.optim.Optimizer],
                       next_epoch: int, stage: int, best_loss: Sequence[float]) -> str:
    """Write the model and optimizer state, then the meta file; with
    ``model=None`` only the meta file is rewritten (a new best loss after
    validation). Returns the state's path."""
    path = resume_path(run_dir, kind)
    if model is not None:
        _atomic_save({"model": model_state(model), "optimizer": optimizer.state_dict()}, path)
    meta = f"{path}.meta.json"
    with open(f"{meta}.tmp", "w") as f:
        json.dump({"epoch": next_epoch, "stage": stage,
                   "best_loss": [float(b) for b in best_loss]}, f)
    os.replace(f"{meta}.tmp", meta)
    return path


def read_resume_meta(path: str) -> dict:
    with open(f"{path}.meta.json") as f:
        return json.load(f)


def load_resume_state(path: str, model, optimizer: torch.optim.Optimizer):
    """Restore the model and the optimizer of the stage being resumed."""
    state = torch.load(path, map_location=_device(model), weights_only=True)
    for name, module in _modules(model).items():
        module.load_state_dict(state["model"][name], strict=True)
    optimizer.load_state_dict(state["optimizer"])
