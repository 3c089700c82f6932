"""The DELTAS cell (``drivers/baseline.py``) at a size the CPU runs in
seconds: every width as published, 64x48 frames, walks of 16 frames; and
the ``pairnet.online`` cell at ``tiny.py``'s size. Each through the port's
real entry points against the plain reference (``correct``); the four
``deltas.*`` metrics read a traced run once it holds device work; a fault
planted in the port fails the cell; a program whose loop takes no frames
from memory fails it at once; the reference loads nothing of the port."""

import copy
import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark.drivers import baseline
from benchmark.harness import core, deltas, trace, traffic
from benchmark.tests import tiny

TRAFFIC = {"kind": "walks", "frames": 16, "step_m": 0.05, "pool": 4,
           "walks": [{"keyframes": 3, "rooms": [31, 44, 56, 84]},
                     {"keyframes": 4, "rooms": [3, 5, 6, 16]}]}
OVERRIDES = {"keyframes_per_scene": 2, "sample_rounds": 1, "trace_seconds": 0.5}
# on the CPU the port solves its DLT systems in float32 (torch.linalg.svd),
# not in the card kernel's float64: its points read about 2e-6 from the
# reference's float64 solve (tests/test_torch_deltas_reference.py, POINT_TOL)
CPU_POINT_GAP = 2e-5
METRICS = ("deltas.host_idle_ms_per_kf", "deltas.dlt_roofline", "deltas.mfu",
           "deltas.idle_share")


@pytest.fixture(autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def context(cell="deltas.bulk", seed=2 ** 31 + 5, seconds=1.0, trace=False) -> core.Context:
    config = core.load_json("configs", "deltas")
    config["test"].update(image_width=64, image_height=48)
    workload = copy.deepcopy(core.load_json("workloads", cell))
    workload.update(OVERRIDES)
    workload["limits"] = dict(workload["limits"], point_gap=CPU_POINT_GAP)
    return core.Context(cell=cell, workload=workload, config=config, traffic=dict(TRAFFIC),
                        seed=seed, seconds=seconds, trace=trace, device="cpu",
                        t0=time.perf_counter())


def test_each_room_gives_its_walks_keyframes_at_the_cells_settings():
    from benchmark.harness import synth

    test = core.load_json("configs", "deltas")["test"]
    for mix in (TRAFFIC, core.load_json("traffic", "bulk_walks")):
        for walk in mix["walks"]:
            for room in walk["rooms"][::5]:
                poses = synth.SynthScene(room).trajectory(mix["frames"], step=mix["step_m"])
                assert traffic.count_keyframes(poses, test) == walk["keyframes"]


def test_frames_are_put_in_the_estimators_normalisation():
    rgb = np.random.RandomState(3).randint(0, 256, (2, 4, 5, 3), dtype=np.uint8)
    est = baseline.estimator_class("deltas", core.load_json("configs", "deltas")["test"])
    want = (rgb / est.scale_rgb - np.asarray(est.mean_rgb)) / np.asarray(est.std_rgb)
    np.testing.assert_allclose(baseline.renormalised(traffic.normalise(rgb), est), want,
                               rtol=0, atol=1e-5)


def test_the_cell_runs_and_agrees_with_the_reference():
    run = core.run_cell(context())
    assert run.correct, run.checks
    assert set(run.checks) == {"keypoint_mismatch_share", "point_gap", "depth_gap"}
    assert run.values["keyframes"] > 0 and run.values["setup_s"] > 0
    assert run.values["conv_flops"] == run.values["keyframes"] * deltas.predict_flops(
        context().config["sizes"], context().config["test"])
    assert set(core.read_metrics(core.spec(), run, False)) == {"setup_s", "bulk_kf_per_s"}


def test_the_four_metrics_read_a_traced_run_with_device_work():
    """On the CPU the trace holds no device operation and no metric reads;
    with a ``dlt_solve`` kernel of 10 us added a traced call, and the run
    marked as the card's, every one reads, the roofline inside (0, 100)."""
    run = core.run_cell(context(trace=True))
    assert run.trace is not None and run.trace.device == []
    assert not set(METRICS) & set(core.read_metrics(core.spec(), run, True))
    calls = run.sweeps["dlt_solve"]
    assert calls and all(shape == (1, 512, 6, 4) for shape in calls)
    start = run.trace.t0
    kernels = [{"ph": "X", "cat": "kernel", "name": "void dlt_solve_kernel<8>(float const*)",
                "ts": start + 20.0 * i, "dur": 10.0, "pid": 0, "tid": 7}
               for i in range(len(calls))]
    run.trace = trace.Trace(run.trace.events + kernels)
    run.device = "cuda"
    got = core.read_metrics(core.spec(), run, True)
    assert set(METRICS) <= set(got)
    share = got["deltas.dlt_roofline"]["value"]
    assert share == pytest.approx(100.0 * deltas.dlt_bound_s((1, 512, 6, 4)) / 10e-6)
    assert 0 < share < 100 and got["deltas.host_idle_ms_per_kf"]["value"] > 0


def test_the_dlt_bound_counts_every_row_of_the_shape():
    """512 systems of 6x4: 81,920 bytes over 3.35 TB/s (24.45 ns) against
    385,024 float64 flops over 34 TFLOP/s (11.3 ns); 1024 of 8x4 read 8
    rows each (196,608 bytes, 58.7 ns, against 27.7 ns of flops)."""
    assert deltas.dlt_bound_s((1, 512, 6, 4)) == pytest.approx(81920 / 3.35e12)
    assert (512 * 6 * 84 + 512 * 248) / 34e12 < 81920 / 3.35e12
    assert deltas.dlt_bound_s((2, 512, 8, 4)) == pytest.approx(196608 / 3.35e12)


@pytest.mark.parametrize("fault", ["confidences_dropped", "poses_swapped"])
def test_a_fault_planted_in_the_port_fails_the_cell(fault, monkeypatch):
    from dvmvs_tpu_torch.baselines import deltas as port

    if fault == "confidences_dropped":
        real = port.dlt_system
        monkeypatch.setattr(port, "dlt_system",
                            lambda proj, points, conf: real(proj, points, torch.ones_like(conf)))
    else:
        real = port.relative_inputs
        monkeypatch.setattr(port, "relative_inputs", lambda *a, **k: {
            **real(*a, **k), "rel": real(*a, **k)["rel"][::-1].copy()})
    run = core.run_cell(context())
    assert not run.correct, run.checks


def test_a_loop_without_assets_fails_at_once(monkeypatch):
    from dvmvs_tpu_torch.apps import run_testing_baseline as rtb

    monkeypatch.setattr(rtb, "evaluate_scene_baseline",
                        lambda estimator, scene_folder, index_file, evaluate=True: None)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="assets"):
        core.run_cell(context())
    assert time.perf_counter() - t0 < 5.0


def test_pairnet_runs_through_the_online_cell():
    cell = "pairnet.online"
    workload = core.load_json("workloads", cell)
    online = core.load_json("workloads", "fusionnet.online")
    del online["limits"]["state_gap"]
    assert workload == online
    workload.update(tiny.OVERRIDES["fusionnet.online"])
    ctx = core.Context(cell=cell, workload=workload, config=tiny.config("pairnet.bulk"),
                       traffic=dict(tiny.TRAFFIC["fusionnet.online"]), seed=17, seconds=1.0,
                       trace=False, device="cpu", t0=time.perf_counter())
    run = core.run_cell(ctx)
    assert run.correct and "state_gap" not in run.checks, run.checks
    assert set(core.read_metrics(core.spec(), run, False)) == {
        "online_kf_ms_p95", "online_kf_per_s", "setup_s"}


def test_the_deltas_reference_loads_nothing_of_the_port():
    p = subprocess.run([sys.executable, "-c",
                        "import sys, json\n"
                        "import benchmark.reference.deltas, benchmark.harness.deltas\n"
                        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                       cwd=str(core.ROOT), capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr
    names = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not {"dvmvs_tpu_torch", "dvmvs_tpu", "jax", "jaxlib", "flax"} & names
