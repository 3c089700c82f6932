"""The port's own spans in the traced window, and the device's idle time
charged to them.

The port opens host ranges named ``dvmvs.<part>.<what>``
(``dvmvs_tpu_torch/utils/profiling.py::span``) around its host work: the
online driver's keyframe buffer, the engine's input packing, copy-in,
graph runs and captures, readback and bank allocation, the bulk driver's
index, frames, schedule and readback. They land in the same trace, on the
same clock, as the device's kernels, copies and fills.

Idle time is charged by overlap: each stretch of the window in which no
device operation runs goes to the innermost program span of the window's
thread open over it, or to ``OUTSIDE``. (``Trace.breakdown`` gives a whole
gap to the range open where it begins.) Every reader returns None for a
trace without device operations (a CPU run) or without the spans it
divides by (a program that opens none).

The profiler converts the device's timestamps to the host's clock, and the
two drift apart within a window (by -17 to +105 ppm on an H100, and by
more than a millisecond in some traces), which moves idle time from one
span to the next. So before charging, each ``STRETCH_US`` of the window
moves the device's operations by the least amount that restores what one
clock must show: every operation starts after the host call that issued
it, and a copy to pageable host memory ends before its call returns.
"""

from __future__ import annotations

import collections
import math
from typing import Dict, List, Optional, Tuple

from benchmark.harness.trace import WINDOW, merged

PREFIX = "dvmvs."
OUTSIDE = "outside program spans"
ENGINE = ("dvmvs.engine.", "dvmvs.graph.")
DRIVER = ("dvmvs.bulk.",)
STRETCH_US = 100e3
HOST_CALLS = ("cuda_runtime", "cuda_driver")


def program_spans(trace) -> List[Tuple[float, float, str]]:
    """(start, end, name) of the window thread's ``dvmvs.*`` ranges that
    start inside the window, clipped to it, by start (an enclosing range
    before the ranges it holds)."""
    window = next(e for e in trace.events
                  if e.get("cat") == "user_annotation" and e["name"] == WINDOW)
    thread = (window.get("pid"), window.get("tid"))
    return sorted(((e["ts"], min(e["ts"] + e["dur"], trace.t1), e["name"]) for e in trace.events
                   if e.get("cat") == "user_annotation" and e["name"].startswith(PREFIX)
                   and (e.get("pid"), e.get("tid")) == thread and trace.t0 <= e["ts"] < trace.t1),
                  key=lambda s: (s[0], -s[1]))


def device_lead(trace) -> Dict[int, float]:
    """By stretch of the window (``STRETCH_US``, counted from its start),
    the device clock's lead over the host's in us: 0 where the stretch's
    operations keep to one clock, else the least lead that makes them keep
    to it (the middle, where no lead can)."""
    calls = {e["args"]["correlation"]: e for e in trace.events
             if e.get("cat") in HOST_CALLS and "correlation" in (e.get("args") or {})}
    most, least = {}, {}
    for d in trace.device:
        call = calls.get((d.get("args") or {}).get("correlation"))
        if call is None:
            continue
        k = int((call["ts"] - trace.t0) // STRETCH_US)
        most[k] = min(most.get(k, math.inf), d["ts"] - call["ts"])
        if "DtoH" in d["name"] and "Pageable" in d["name"]:
            late = d["ts"] + d["dur"] - call["ts"] - call["dur"]
            least[k] = max(least.get(k, -math.inf), late)
    lead = {}
    for k in set(most) | set(least):
        lo, hi = least.get(k, -math.inf), most.get(k, math.inf)
        lead[k] = min(max(0.0, lo), hi) if lo <= hi else (lo + hi) / 2
    return lead


def busy_intervals(trace) -> List[Tuple[float, float]]:
    """``Trace.busy_intervals`` on the host's clock (``device_lead``)."""
    lead = device_lead(trace)
    spans = []
    for e in trace.device:
        shift = lead.get(int((e["ts"] - trace.t0) // STRETCH_US), 0.0)
        start, end = e["ts"] - shift, min(e["ts"] + e["dur"], trace.t1) - shift
        spans.append((max(start, trace.t0), min(end, trace.t1)))
    return merged(s for s in spans if s[1] > s[0])


def idle_intervals(trace) -> List[Tuple[float, float]]:
    """The stretches of the window with no device operation running."""
    out, edge = [], trace.t0
    for start, end in busy_intervals(trace):
        if start > edge:
            out.append((edge, min(start, trace.t1)))
        edge = max(edge, end)
    if edge < trace.t1:
        out.append((edge, trace.t1))
    return out


def idle_by_span(trace) -> Dict[str, float]:
    """Idle seconds of the window by the innermost program span open over
    them (the span that started last), or ``OUTSIDE``."""
    spans, idle = program_spans(trace), idle_intervals(trace)
    points = sorted({p for s in spans for p in s[:2]} | {p for i in idle for p in i})
    charged = collections.Counter()
    opened, live, k = 0, [], 0
    for a, b in zip(points, points[1:]):
        while opened < len(spans) and spans[opened][0] <= a:
            live.append(spans[opened])
            opened += 1
        live = [s for s in live if s[1] > a]
        while k < len(idle) and idle[k][1] <= a:
            k += 1
        if k < len(idle) and idle[k][0] <= a:
            owner = max(live, key=lambda s: (s[0], -s[1]))[2] if live else OUTSIDE
            charged[owner] += (b - a) / 1e6
    return dict(charged)


def counts(trace) -> collections.Counter:
    return collections.Counter(name for _, _, name in program_spans(trace))


def self_ms(trace, name: str) -> float:
    """Milliseconds inside the spans ``name`` not covered by another program
    span nested in them."""
    spans = program_spans(trace)
    total = 0.0
    for i, (start, end, n) in enumerate(spans):
        if n != name:
            continue
        covered, reach, j = 0.0, start, i + 1
        while j < len(spans) and spans[j][0] < end:
            a, b = spans[j][0], min(spans[j][1], end)
            if b > reach:
                covered += b - max(a, reach)
                reach = b
            j += 1
        total += end - start - covered
    return total / 1e3


def _traced(run):
    return run.trace is not None and bool(run.trace.device)


def _idle_ms_per(run, prefixes, per: str) -> Optional[float]:
    if not _traced(run):
        return None
    n = counts(run.trace)[per]
    if not n:
        return None
    idle = idle_by_span(run.trace)
    return 1e3 * sum(v for k, v in idle.items() if k.startswith(prefixes)) / n


def online_engine_idle_ms_per_kf(run) -> Optional[float]:
    return _idle_ms_per(run, ENGINE, "dvmvs.engine.readback")


def buffer_ms_per_frame(run) -> Optional[float]:
    if not _traced(run):
        return None
    n = counts(run.trace)["dvmvs.stream.buffer"]
    return self_ms(run.trace, "dvmvs.stream.buffer") / n if n else None


def bulk_engine_idle_ms_per_chunk(run) -> Optional[float]:
    return _idle_ms_per(run, ENGINE, "dvmvs.bulk.readback")


def bulk_driver_idle_ms_per_chunk(run) -> Optional[float]:
    return _idle_ms_per(run, DRIVER, "dvmvs.bulk.readback")


def rebuilds(trace) -> Optional[float]:
    """Graph captures and bank allocations a scene (``dvmvs.bulk.index``)."""
    c = counts(trace)
    if not c["dvmvs.bulk.index"]:
        return None
    return (c["dvmvs.graph.capture"] + c["dvmvs.engine.bank_alloc"]) / c["dvmvs.bulk.index"]


def rebuilds_per_scene(run) -> Optional[float]:
    return rebuilds(run.trace) if _traced(run) else None
