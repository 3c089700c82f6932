"""Each cell at a size the CPU runs in seconds (``tiny.py``): its traffic
made alike from one seed and otherwise from another, its driver through
the port's real entry points, the readers of its records, and the port
against the plain reference (``correct``)."""

import numpy as np
import pytest
import torch

from benchmark.harness import core, synth, traffic
from benchmark.tests import tiny

CELLS = ("fusionnet.online", "pairnet.bulk", "fusionnet.train")
E2E = {"fusionnet.online": ("online_kf_ms_p95", "online_kf_per_s"),
       "pairnet.bulk": ("bulk_kf_per_s",), "fusionnet.train": ("train_step_ms",)}


@pytest.fixture(autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("cell", CELLS)
def test_traffic_is_made_from_the_seed(cell):
    config = tiny.config(cell)
    a = traffic.make(tiny.TRAFFIC[cell], config, 2 ** 31 + 11)
    b = traffic.make(tiny.TRAFFIC[cell], config, 2 ** 31 + 11)
    c = traffic.make(tiny.TRAFFIC[cell], config, 12)
    if "batches" in a:
        first = lambda d: d["batches"][0]["images"]
        assert len(a["batches"]) == tiny.TRAFFIC[cell]["batches"]
        B, S = config["train"]["batch_size"], config["train"]["subsequence_length"]
        assert first(a).shape == (B, S, 64, 64, 3)
        rows = a["batches"][0]["poses"].reshape(-1, 16)
        assert len({r.tobytes() for r in rows}) == B * S  # no frame repeated
    else:
        first = lambda d: d["pool"]
        assert a["pool"].shape == (tiny.TRAFFIC[cell]["pool"], 64, 96, 3)
        np.testing.assert_array_equal(np.stack(a["poses"]), np.stack(b["poses"]))
        # every seed walks rooms of its own, with the same keyframes a walk
        others = [traffic.make(tiny.TRAFFIC[cell], config, s)["poses"] for s in (13, 14, 15)]
        assert any(not np.array_equal(np.stack(a["poses"]), np.stack(o)) for o in others)
        counts = lambda d: sorted(traffic.count_keyframes(p, config["test"]) for p in d["poses"])
        assert counts(a) == counts(c) == sorted(w["keyframes"] for w in tiny.TRAFFIC[cell]["walks"])
    np.testing.assert_array_equal(first(a), first(b))
    assert not np.array_equal(first(a), first(c))


@pytest.mark.parametrize("mix", ["online_walks", "bulk_walks"])
def test_each_room_of_a_mix_gives_its_walks_keyframes(mix):
    spec, test = core.load_json("traffic", mix), core.load_json("configs", "fusionnet")["test"]
    for walk in spec["walks"]:
        for room in walk["rooms"][::5]:
            poses = synth.SynthScene(room).trajectory(spec["frames"], step=spec["step_m"])
            assert traffic.count_keyframes(poses, test) == walk["keyframes"], (mix, room)


def test_subsequence_pick_keeps_the_pose_window():
    poses = np.stack([np.eye(4)] * 10)
    poses[:, 0, 3] = np.arange(10) * 0.06
    assert traffic.pick_subsequence(poses, 3, 0.125, 0.325, 0.05, 0) == [0, 3, 6]
    assert traffic.pick_subsequence(poses, 5, 0.125, 0.325, 0.05, 0) is None


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_agrees_with_the_reference(cell):
    run = tiny.run(cell, seconds=1.0)
    assert run.correct, run.checks
    assert run.values["attempted"] > 0 and run.values["setup_s"] > 0
    metrics = core.read_metrics(core.spec(), run, False)
    assert set(metrics) == {"setup_s", *E2E[cell]}
    if cell == "fusionnet.online":
        assert len(run.samples["kf_ms"]) == run.values["keyframes"]
        assert run.values["frames"] > run.values["keyframes"]
        assert core.read_metrics(core.spec(), run, True)["online.host_ms_per_frame"]["value"] > 0
    if cell == "pairnet.bulk":
        assert run.values["slots"] >= run.values["keyframes"]
        assert 0 <= core.read_metrics(core.spec(), run, True)["bulk.pad_share"]["value"] < 100


def test_traced_run_on_the_cpu_reads_no_device_metric():
    run = tiny.run("fusionnet.online", seconds=0.5, trace=True)
    assert run.trace is not None and run.trace.device == []
    per_layer = core.read_metrics(core.spec(), run, True)
    assert set(per_layer) == {"online.host_ms_per_frame"}
