"""The port's arithmetic mode: convolutions and matmuls in IEEE float32,
each convolution on the cuDNN algorithm timed fastest for its shape.

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

The same context picks each convolution's cuDNN algorithm by timing:
within it ``torch.backends.cudnn.benchmark`` is True, so the first
convolution of each shape times cuDNN's candidates on the card and torch
caches the fastest for that shape (in the process; torch's cuDNN v8 path
keeps one cache per thread, so autograd's backward thread has its own)
instead of taking cuDNN's heuristic guess, which runs some float32 shapes
on FFT and legacy (``ALGO_0``) kernels that lose to implicit GEMM when
timed. The arithmetic stays IEEE float32; only the algorithm changes. The
search times the first ``SEARCH_CANDIDATES`` of cuDNN's ranked candidates
(``torch.backends.cudnn.benchmark_limit``). It runs at a shape's first
call, which on the graph path is ``StepGraph``'s warm-up before the
capture, so a capture and its replays run the measured algorithm; a shape
first seen inside a capture would time its candidates there, which a
capture refuses: the capture raises. ``unpinned()`` leaves the search on,
so that it differs from the port by precision alone.
"""

from __future__ import annotations

import contextlib

import torch

# False only inside ``unpinned()``
_pinning = True

# candidates the search times for each shape. On an H100 (700 W), medians
# of 3 runs, the fusionnet training step (B=4, S=8, 256x256) took 169.1 ms at
# 3, 168.9 at 4 and 167.4 at 6 (198.0 on cuDNN's heuristic), and the search
# added 2.6, 2.6 and 3.7 s to its warm-up and capture, whose set-up is about
# 30 s; at torch's default of 10 it added 9.8 s
SEARCH_CANDIDATES = 4


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
    matmuls on the card compute in IEEE float32, and each convolution runs
    the cuDNN algorithm timed fastest for its shape (module doc); the
    caller's flags are restored on exit, also when the block raises."""
    cudnn = torch.backends.cudnn
    flags = _flags() if _pinning else {}
    saved = [flag.fp32_precision for flag in flags.values()]
    saved_search = cudnn.benchmark, cudnn.benchmark_limit
    for flag in flags.values():
        flag.fp32_precision = "ieee"
    cudnn.benchmark, cudnn.benchmark_limit = True, SEARCH_CANDIDATES
    try:
        yield
    finally:
        cudnn.benchmark, cudnn.benchmark_limit = saved_search
        for flag, value in zip(flags.values(), saved):
            flag.fp32_precision = value


@contextlib.contextmanager
def unpinned():
    """For measurements and planted faults only: within the block
    ``ieee_float32`` leaves the precision flags as they are, so the steps
    compute in the process's own mode (torch's TF32 convolutions by
    default), as they did before the port pinned its mode; the algorithm
    search stays on."""
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
    return (f"arithmetic: IEEE float32 convolutions and matmuls in every step, each "
            f"convolution's cuDNN algorithm timed at its shape's first call "
            f"(process flags, unused by the steps: {defaults})")
