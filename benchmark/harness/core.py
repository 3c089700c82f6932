"""What every cell shares: finding a cell's files by name, seeds, the run's
record, the result line and the checks that a run may report one.

A cell (``workloads/<cell>.json``) names its configuration
(``configs/<config>.json``), its traffic mix (``traffic/<mix>.json``, read
by ``harness/traffic.py``), the driver that runs it (``drivers/<name>.py``,
a ``run(ctx)`` function) and the limits of its correctness checks. A metric
is ``metrics/<metric>.py``, a ``read(run)`` function of the run's record
that returns a number or None when the run has nothing to read. So a new
configuration, mix, cell or metric is a new file.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
# top-level module names the benchmark's process may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "dvmvs_tpu")


def load_json(kind: str, name: str, base: Path = BENCH) -> dict:
    """``benchmark/<kind>/<name>.json`` (``base`` is the benchmark's folder)."""
    with open(Path(base) / kind / f"{name}.json") as f:
        return json.load(f)


def spec(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def load_code(kind: str, name: str, base: Path = BENCH):
    """The module ``benchmark/<kind>/<name>.py``, loaded by path (a metric's
    name may hold dots)."""
    path = Path(base) / kind / f"{name}.py"
    module_name = f"benchmark_{kind}_" + "".join(c if c.isalnum() else "_" for c in name)
    loaded = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(loaded)
    loaded.loader.exec_module(module)
    return module


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})


def seeds(seed: int, n: int) -> List[int]:
    """``n`` independent 32-bit seeds drawn from the run's seed (any whole
    number)."""
    return [int(s) for s in np.random.SeedSequence(abs(int(seed))).generate_state(n)]


def percentile(values, q: float) -> Optional[float]:
    return float(np.percentile(np.asarray(values, np.float64), q)) if len(values) else None


@dataclasses.dataclass
class Run:
    """What one run of a cell records; metric readers read it.

    ``values``: named numbers (``setup_s``, ``window_s``, counts of work);
    ``samples``: named lists (per-keyframe times); ``trace``: the traced
    window (``harness/trace.py::Trace``) or None; ``sweeps``: per kernel
    ("forward", "backward") the geometry of each call made in the traced
    window, grouped by shape (``roofline.stack_calls``); ``checks``: name ->
    (reading, limit)."""

    cell: str
    device: str
    values: Dict[str, float] = dataclasses.field(default_factory=dict)
    samples: Dict[str, list] = dataclasses.field(default_factory=dict)
    trace: Any = None
    sweeps: Dict[str, list] = dataclasses.field(default_factory=dict)
    checks: Dict[str, tuple] = dataclasses.field(default_factory=dict)

    def check(self, name: str, reading: float, limit: float):
        self.checks[name] = (float(reading), float(limit))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            math.isfinite(r) and r <= lim for r, lim in self.checks.values())


@dataclasses.dataclass
class Context:
    """A cell as its driver gets it."""

    cell: str
    workload: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float

    def mark(self, phase: str):
        """Note on standard error when a phase of set-up ended."""
        print(f"setup {phase} done at {time.perf_counter() - self.t0:.3f} s", file=sys.stderr,
              flush=True)


def context(bench: dict, cell: str, seed: int, seconds: float, trace: bool, device: str,
            t0: float, base: Path = BENCH) -> Context:
    """The context of ``cell`` as ``BENCHMARK.json`` names its files."""
    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    return Context(cell=cell, workload=load_json("workloads", cell, base),
                   config=load_json("configs", entry["config"], base),
                   traffic=load_json("traffic", entry["traffic"], base), seed=seed,
                   seconds=seconds, trace=trace, device=device, t0=t0)


def run_cell(ctx: Context, base: Path = BENCH) -> Run:
    return load_code("drivers", ctx.workload["driver"], base).run(ctx)


def metric_entries(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or with
    ``trace`` its per-layer ones (an entry without ``workloads`` is every
    cell's)."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]


def read_metrics(bench: dict, run: Run, trace: bool, base: Path = BENCH) -> Dict[str, dict]:
    out = {}
    for entry in metric_entries(bench, run.cell, trace):
        value = load_code("metrics", entry["name"], base).read(run)
        if value is not None:
            out[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    return out


def result_line(bench: dict, run: Run, trace: bool, device: dict,
                breakdown: Optional[dict] = None) -> dict:
    line = {"correct": run.correct, "attempted": int(run.values.get("attempted", 0)),
            "failed": int(run.values.get("failed", 0)),
            "metrics": read_metrics(bench, run, trace), "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {k: {"value": r, "limit": lim} for k, (r, lim) in run.checks.items()}
    return line


def report_checks(run: Run, stream=sys.stderr):
    for name, (reading, limit) in run.checks.items():
        print(f"check {name} {reading!r} limit {limit!r} "
              f"{'ok' if reading <= limit else 'FAILED'}", file=stream)
    stream.flush()
