"""BENCHMARK.json against the contract's rules on names, units and
references, and every file it names present under ``benchmark/``."""

import re

import pytest

from benchmark.harness import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KINDS = ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.fixture(scope="module")
def bench():
    return core.spec()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert bench["command"][1] == "benchmark/run.py"
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)


def test_names_and_units(bench):
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w[k] for w in bench["workloads"] for k in ("config", "traffic")]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    for name in names:
        assert NAME.match(name), name
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher") and m["source"] in KINDS
    metric_names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)


def test_entries_have_only_their_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_every_named_file_exists(bench):
    for c in bench["configs"]:
        assert (core.ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        core.load_json("traffic", w["traffic"])
        work = core.load_json("workloads", w["name"])
        assert (core.BENCH / "drivers" / f"{work['driver']}.py").is_file()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(core.load_code("metrics", m["name"]).read)


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(bench):
    for w in bench["workloads"]:
        e2e = [m["name"] for m in core.metric_entries(bench, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert core.metric_entries(bench, w["name"], True)
        for m in core.metric_entries(bench, w["name"], True):
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_a_metric_of_a_layer_names_the_layer_alike(bench):
    layers = {m["layer"] for m in bench["per_layer"]}
    assert layers == {"online driver", "bulk driver", "engine and graphs", "model step", "kernels",
                      "device"}
    for m in bench["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
