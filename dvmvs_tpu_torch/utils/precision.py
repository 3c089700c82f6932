"""The port's arithmetic mode: convolutions and matmuls in IEEE float32.

The reference every check holds the port to is the JAX package on the CPU,
where XLA computes convolutions and matmuls in IEEE float32. torch's
defaults on the card are not that: cuDNN convolutions run in TF32
(``torch.backends.cudnn.conv.fp32_precision == "tf32"``), which rounds each
operand to 10 mantissa bits. So the port sets the mode where it issues
device work, not in its callers: the eager step bodies, the CUDA graph
captures (a replay runs the kernels chosen while it was captured) and the
training steps run inside ``ieee_float32()``, whatever the process's
defaults are, and leave the caller's mode as it was.

What the context sets: cuDNN's convolution and RNN flags and cuBLAS's
matmul flag, all to ``"ieee"``, through the ``fp32_precision`` API only.
Mixing it with the legacy ``allow_tf32`` flags is a trap: once a cuDNN flag
is set through the new API to anything but ``"tf32"``, reading
``torch.backends.cudnn.allow_tf32`` raises (torch 2.11 and 2.13), so the
port reads the mode through ``current`` and ``describe`` only.
(``torch.backends.cudnn.flags(...)`` is no substitute either: it switches
cuDNN off unless ``enabled=True`` is passed.) The flags are process-global,
not thread-local: enter the context on the thread that launches the step;
autograd's backward threads read the same flags.
"""

from __future__ import annotations

import contextlib

import torch

# False only inside ``unpinned()``
_pinning = True


def _flags():
    """The flags the port pins, by name."""
    b = torch.backends
    return {"cudnn.conv": b.cudnn.conv, "cudnn.rnn": b.cudnn.rnn, "cuda.matmul": b.cuda.matmul}


def current() -> dict:
    """The process's mode now: ``fp32_precision`` of each pinned flag."""
    return {name: flag.fp32_precision for name, flag in _flags().items()}


@contextlib.contextmanager
def ieee_float32():
    """Within the block (or the decorated function), convolutions and
    matmuls on the card compute in IEEE float32; the caller's flags are
    restored on exit, also when the block raises."""
    if not _pinning:
        yield
        return
    flags = _flags()
    saved = [flag.fp32_precision for flag in flags.values()]
    for flag in flags.values():
        flag.fp32_precision = "ieee"
    try:
        yield
    finally:
        for flag, value in zip(flags.values(), saved):
            flag.fp32_precision = value


@contextlib.contextmanager
def unpinned():
    """For measurements and planted faults only: within the block
    ``ieee_float32`` leaves the flags as they are, so the steps compute in
    the process's own mode (torch's TF32 convolutions by default), as they
    did before the port pinned its mode."""
    global _pinning
    saved, _pinning = _pinning, False
    try:
        yield
    finally:
        _pinning = saved


def describe() -> str:
    """One line for a run's header: the mode the steps run in, and the
    process's own flags, which the steps do not use."""
    defaults = ", ".join(f"{name} {value}" for name, value in current().items())
    return (f"arithmetic: IEEE float32 convolutions and matmuls in every step "
            f"(process flags, unused by the steps: {defaults})")
