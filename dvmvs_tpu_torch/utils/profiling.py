"""Profiling and tracing (counterpart of dvmvs_tpu/utils/profiling.py; the
reference's only tool is its InferenceTimer, dvmvs/utils.py:369-402).

Usage:
    with device_trace("/tmp/trace"):
        depth = engine.encode_and_predict(...)   # returns host arrays
Open the Chrome trace it writes (``trace.json``) in Perfetto or
chrome://tracing. With a card present the trace holds the CUDA kernels
beside the host operations.
"""

from __future__ import annotations

import contextlib
import os

import torch

from dvmvs_tpu_torch.utils.results import InferenceTimer


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


class StepTimer:
    """Per-step wall times with a warm-up skip (``InferenceTimer``) as a
    context manager. The step must end in a host readback or a
    ``torch.cuda.synchronize()``: the card runs behind the host."""

    def __init__(self, n_skip: int = 20):
        self._timer = InferenceTimer(n_skip)

    def __enter__(self):
        self._timer.record_start_time()
        return self

    def __exit__(self, *exc):
        self._timer.record_end_time_and_elapsed_time()

    def print_statistics(self):
        self._timer.print_statistics()
