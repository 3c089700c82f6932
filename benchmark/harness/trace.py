"""The traced window: a ``torch.profiler`` trace of part of a run, and the
arithmetic that reads it (``union_length``, ``api_calls`` and the kernel
sums are copies of the port's ``apps/profile_step.py``).

The window is the host range ``WINDOW``. Device operations are kernels,
copies and fills; the device is busy where any of them runs (the union of
their intervals), idle elsewhere in the window. Host ranges that the
benchmark opens around the calls it makes into the program (``span``)
name what the host was doing in each idle gap.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import re
import tempfile
from typing import Dict, List, Optional

import torch

WINDOW = "bench.window"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
KERNEL_LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                      "cuLaunchKernelEx")
TOP = 10


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def merged(intervals) -> List[tuple]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [tuple(x) for x in out]


def span(name: str):
    """A host range in the trace (a no-op when nothing profiles)."""
    return torch.profiler.record_function(name)


def spanned(obj, names, prefix: str = "engine."):
    """Wrap the methods ``names`` of one object (the instance only) in host
    ranges ``prefix + name``; ``unspanned`` takes them off."""
    for name in names:
        method = getattr(obj, name)

        def call(*args, _method=method, _label=prefix + name, **kwargs):
            with span(_label):
                return _method(*args, **kwargs)

        setattr(obj, name, call)
    return obj


def unspanned(obj, names):
    for name in names:
        obj.__dict__.pop(name, None)


class Trace:
    """The events of a traced window."""

    def __init__(self, events: list):
        self.events = [e for e in events if e.get("ph") == "X"]
        window = [e for e in self.events
                  if e.get("cat") == "user_annotation" and e["name"] == WINDOW]
        if not window:
            raise RuntimeError("the trace holds no window range")
        self.t0, self.t1 = window[0]["ts"], window[0]["ts"] + window[0]["dur"]
        self.device = [e for e in self.events if e.get("cat") in DEVICE_CATEGORIES
                       and self.t0 <= e["ts"] < self.t1]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_intervals(self):
        return merged((e["ts"], min(e["ts"] + e["dur"], self.t1)) for e in self.device)

    @property
    def busy_s(self) -> float:
        return union_length((e["ts"], min(e["ts"] + e["dur"], self.t1))
                            for e in self.device) / 1e6

    def kernel_s(self, prefixes) -> float:
        """Device seconds of the kernels whose function name is one of
        ``prefixes``, template arguments and namespaces aside."""
        pattern = re.compile("|".join(rf"(?<![\w]){re.escape(p)}[<(]" for p in prefixes))
        return sum(e["dur"] for e in self.device
                   if e["cat"] == "kernel" and pattern.search(e["name"])) / 1e6

    def api_calls(self, range_name: str) -> dict:
        """Host CUDA API calls by name inside the host ranges ``range_name``,
        and the number of those ranges."""
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in self.events
                       if e.get("cat") == "user_annotation" and e["name"] == range_name)
        calls = collections.Counter()
        for e in self.events:
            if e.get("cat") in ("cuda_runtime", "cuda_driver") and any(
                    a <= e["ts"] <= b for a, b in spans):
                calls[e["name"]] += 1
        return {"ranges": len(spans), "calls": dict(calls)}

    def launches_per_range(self, range_name: str) -> Optional[float]:
        """Graph launches plus kernel launches per host range ``range_name``."""
        calls = self.api_calls(range_name)
        if not calls["ranges"]:
            return None
        c = calls["calls"]
        n = c.get("cudaGraphLaunch", 0) + sum(v for k, v in c.items() if k in KERNEL_LAUNCH_APIS)
        return n / calls["ranges"]

    def breakdown(self) -> dict:
        """The device operations that took most time, and the longest idle
        gaps summed by the innermost benchmark range open on the host when
        the gap began."""
        ops = collections.Counter()
        for e in self.device:
            ops[e["name"][:120]] += e["dur"] / 1e6
        ranges = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in self.events
                         if e.get("cat") == "user_annotation" and e["name"] != WINDOW),
                        key=lambda r: r[1] - r[0])
        gaps = collections.Counter()
        edge = self.t0
        for start, end in self.busy_intervals() + [(self.t1, self.t1)]:
            if start > edge:
                owner = next((r[2] for r in ranges if r[0] <= edge < r[1]), "host outside spans")
                gaps[owner] += (start - edge) / 1e6
            edge = max(edge, end)
        return {"device_ops": [[k, v] for k, v in ops.most_common(TOP)],
                "idle_gaps": [[k, v] for k, v in gaps.most_common(TOP)]}


@contextlib.contextmanager
def traced(holder: Dict, device):
    """Profile the block (host, and the card's device) inside the window
    range; on exit ``holder["trace"]`` is its ``Trace``."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        with span(WINDOW):
            yield
            sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            holder["trace"] = Trace(json.load(f)["traceEvents"])
    finally:
        os.remove(path)
