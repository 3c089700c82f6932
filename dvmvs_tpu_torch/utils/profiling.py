"""Profiling and tracing (counterpart of dvmvs_tpu/utils/profiling.py; the
reference's only tool is its InferenceTimer, dvmvs/utils.py:369-402).

Three tools, all host-side:

  - ``device_trace(log_dir)``: a ``torch.profiler`` trace of a block, written
    as ``log_dir/trace.json``. Open it in Perfetto or chrome://tracing; with
    a card present it holds the CUDA kernels, copies and fills beside the
    host operations, on one clock.
  - ``span(name)``: a named host range in that trace. The port opens
    ``dvmvs.<part>.<what>`` spans where its host work happens (the online
    driver's keyframe buffer, the engine's input packing, copy-in and
    readback, each graph run and capture, the bulk driver's index, frames,
    schedule and readback, the training step's copy-in), so the trace says
    what the host was doing while the card sat idle. A span is free when
    nothing profiles: it returns one shared null context. A span inside a
    captured step body would run at the capture only, never at a replay, so
    none is put there.
  - ``counters``: named counts of work in this process (kernel launches,
    graph builds, captures and evictions, bank allocations, bytes copied
    in and out, bulk slots computed and padded). ``snapshot()`` and
    ``since(snapshot)`` give the counts over a stretch; ``predict_scene``
    and ``run_testing`` print them at the end of a run.

Usage:
    with device_trace("/tmp/trace"):
        depth = engine.encode_and_predict(...)   # returns host arrays
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict

import torch

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A host range ``name`` in the running ``torch.profiler`` trace; the
    shared null context when no profiler runs (about 0.1-0.4 us, against
    several for an idle ``record_function``)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


class Counters:
    """Named whole-number counts; a name never counted reads 0."""

    def __init__(self):
        self._counts: Dict[str, int] = {}

    def add(self, name: str, n: int = 1):
        self._counts[name] = self._counts.get(name, 0) + n

    def __getitem__(self, name: str) -> int:
        return self._counts.get(name, 0)

    def snapshot(self) -> Dict[str, int]:
        return dict(self._counts)

    def since(self, snapshot: Dict[str, int]) -> Dict[str, int]:
        """The counts that moved after ``snapshot``, by how much."""
        return {k: v - snapshot.get(k, 0) for k, v in sorted(self._counts.items())
                if v != snapshot.get(k, 0)}


# the process's counters (the kernel wrappers, StepGraph, the engine and the
# bulk evaluators count into them)
counters = Counters()


def describe_counts(counts: Dict[str, int]) -> str:
    """One line of counts, as the drivers print them."""
    return "counters: " + (", ".join(f"{k} {v}" for k, v in sorted(counts.items())) or "none")


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the body with ``torch.profiler`` (CPU activity, and CUDA activity
    when a card is present) and write ``log_dir/trace.json``. The body must
    end in a host readback or ``torch.cuda.synchronize()`` for its device
    work to fall inside the trace."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
