"""A configuration, a traffic mix, a cell and a per-layer metric added as
new files only: the harness finds each by its name, and no file that was
there is edited (a copy of ``benchmark/`` in a temporary folder stands for
the checkout)."""

import json
import shutil
import time

import torch

from benchmark.harness import core
from benchmark.tests import tiny


def test_new_files_are_found_by_name(tmp_path):
    base = tmp_path / "benchmark"
    shutil.copytree(core.BENCH, base, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    bench = core.spec()

    # a configuration (pairnet at the CPU test size), a mix and a cell that
    # runs pairnet through the online driver, and a metric of frames a second
    (base / "configs" / "pairnet_small.json").write_text(json.dumps(tiny.config("pairnet.bulk")))
    (base / "traffic" / "short_walks.json").write_text(json.dumps(tiny.TRAFFIC["fusionnet.online"]))
    workload = core.load_json("workloads", "fusionnet.online")
    workload.update(tiny.OVERRIDES["fusionnet.online"])
    del workload["limits"]["state_gap"]  # pairnet carries no recurrent state
    (base / "workloads" / "pairnet_small.online.json").write_text(json.dumps(workload))
    (base / "metrics" / "online.frames_per_s.py").write_text(
        "def read(run):\n    return run.values['frames'] / run.values['window_s']\n")
    bench["configs"].append({"name": "pairnet_small", "source": "x",
                             "file": "benchmark/configs/pairnet_small.json", "reduced": [],
                             "why": "x"})
    bench["workloads"].append({"name": "pairnet_small.online", "config": "pairnet_small",
                               "traffic": "short_walks", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "online.frames_per_s", "unit": "frames/s",
                               "better": "higher", "source": "host_clock", "layer": "online driver",
                               "moves": "online_kf_per_s",
                               "workloads": ["pairnet_small.online"]})
    bench["end_to_end"][1]["workloads"].append("pairnet_small.online")
    bench["end_to_end"][0]["workloads"].append("pairnet_small.online")

    torch.set_num_threads(2)
    ctx = core.context(bench, "pairnet_small.online", 5, 1.0, False, "cpu", time.perf_counter(),
                       base)
    assert ctx.config["model"] == "pairnet" and ctx.traffic["frames"] == 30
    run = core.run_cell(ctx, base)
    assert run.correct and "state_gap" not in run.checks, run.checks
    per_layer = core.read_metrics(bench, run, True, base)
    assert per_layer["online.frames_per_s"]["value"] > 0
    assert set(core.read_metrics(bench, run, False, base)) == {
        "online_kf_ms_p95", "online_kf_per_s", "setup_s"}
    assert all(p.read_bytes() == data for p, data in before.items())
