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
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import torch

MODULE_NAMES = ("feature_extractor", "feature_shrinker", "cost_volume_encoder",
                "lstm_fusion", "cost_volume_decoder")


def _atomic_save(obj, path: str):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(obj, tmp)
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
    """Load a checkpoint into ``model``; with ``partial`` a module the
    checkpoint lacks keeps its values (a pairnet checkpoint warm-starts
    fusionnet, whose ``lstm_fusion`` stays fresh). Returns the names of the
    modules kept fresh."""
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
