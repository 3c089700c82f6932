"""Faults planted underneath the timed path, to show that the checks catch
them (``tests/test_bench_faults.py``, and ``run.py --fault`` on the chip).
Each patches the program's classes or functions in this process only, and
``plant`` returns the function that takes the patch off.

  - ``frozen_state``: a step that returns its state unchanged (the online
    recurrent state is never written; the training step skips the
    optimizer's update).
  - ``frozen_buffers``: the training step leaves BatchNorm's running
    statistics unchanged (every BatchNorm's momentum 0); train-mode
    BatchNorm normalises with the batch's statistics, so the loss and the
    parameters do not show it.
  - ``half_batch``: half of the batch left out (a bulk step computes the
    first half of its rows and repeats them; the training loss is the mean
    over the first half of the rows).
  - ``altered_answer``: an answer altered where it is produced (each depth,
    or the training loss, scaled by 1 + 1e-3).
"""

from __future__ import annotations

import torch

SCALE = 1.0 + 1e-3


def _patch(owner, name, value, undo: list):
    undo.append((owner, name, owner.__dict__[name]))
    setattr(owner, name, value)


def plant(name: str):
    from dvmvs_tpu_torch.apps import engine as engine_module
    from dvmvs_tpu_torch.parallel import train as train_module

    Engine = engine_module.InferenceEngine
    undo: list = []
    if name == "frozen_state":
        _patch(Engine, "_write_state", lambda self, state, new: None, undo)
        real_step = train_module.train_step

        class NoUpdate:
            def __init__(self, optimizer):
                self.optimizer = optimizer

            def step(self):
                pass

        _patch(train_module, "train_step",
               lambda model, optimizer, *a, **k: real_step(model, NoUpdate(optimizer), *a, **k),
               undo)
    elif name == "frozen_buffers":
        real_step = train_module.train_step

        def frozen(model, *a, **k):
            for module in model.modules():
                if isinstance(module, torch.nn.modules.batchnorm._BatchNorm):
                    module.momentum = 0.0
            return real_step(model, *a, **k)

        _patch(train_module, "train_step", frozen, undo)
    elif name == "half_batch":
        real_body = Engine._pair_batch_body

        def half_rows(self, *args):
            n = args[0].shape[0] // 2
            cut = [tuple(t[:n] for t in a) if isinstance(a, tuple) else a[:n] for a in args]
            out = real_body(self, *cut)
            return torch.cat([out, out])

        _patch(Engine, "_pair_batch_body", half_rows, undo)
        real_loss = train_module.fusionnet_loss_fn

        def half_loss(model, batch, *a, **k):
            n = batch["images"].shape[0] // 2
            return real_loss(model, {key: v[:n] for key, v in batch.items()}, *a, **k)

        _patch(train_module, "fusionnet_loss_fn", half_loss, undo)
    elif name == "altered_answer":
        real_readback = Engine.__dict__["_readback"].__func__
        _patch(Engine, "_readback", staticmethod(lambda depth: real_readback(depth) * SCALE), undo)
        real_steps = Engine._pair_steps_body
        _patch(Engine, "_pair_steps_body",
               lambda self, *a, **k: real_steps(self, *a, **k) * SCALE, undo)
        real_loss = train_module.fusionnet_loss_fn

        def scaled_loss(*a, **k):
            loss, metrics = real_loss(*a, **k)
            return loss * SCALE, dict(metrics, loss=loss * SCALE)

        _patch(train_module, "fusionnet_loss_fn", scaled_loss, undo)
    else:
        raise ValueError(f"unknown fault {name!r}")

    def take_off():
        for owner, attr, value in reversed(undo):
            setattr(owner, attr, value)
    return take_off
