"""Idle time charged to the port's spans by overlap (``harness/spans.py``),
on hand-made traces, and the five span metrics: None on a CPU trace, a
number once the trace holds device work, and a bank forced to reallocate
counted as a rebuild."""

import pytest
import torch

from benchmark.drivers import bulk
from benchmark.harness import cells, core, spans, trace, traffic
from benchmark.tests import tiny

SPAN_METRICS = {"fusionnet.online": ("online.engine_idle_ms_per_kf",
                                     "online.buffer_ms_per_frame"),
                "pairnet.bulk": ("bulk.engine_idle_ms_per_chunk", "bulk.driver_idle_ms_per_chunk",
                                 "bulk.rebuilds_per_scene")}


@pytest.fixture(autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def annotation(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "pid": 1,
            "tid": tid}


def kernel(ts, dur):
    return {"ph": "X", "cat": "kernel", "name": "k", "ts": ts, "dur": dur, "pid": 0, "tid": 7}


def call(name, ts, dur, correlation):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": dur, "pid": 1,
            "tid": 1, "args": {"correlation": correlation}}


def issued(event, correlation):
    return {**event, "args": {"correlation": correlation}}


def hand_trace(*events, window=100.0):
    return trace.Trace([annotation(trace.WINDOW, 0.0, window), *events])


def charged_us(t):
    return {k: round(v * 1e6, 6) for k, v in spans.idle_by_span(t).items()}


def test_nested_spans_take_the_idle_time_they_hold_innermost():
    t = hand_trace(kernel(0, 10), kernel(50, 50),
                   annotation("dvmvs.engine.fill", 10, 40), annotation("dvmvs.graph.run", 20, 20))
    assert charged_us(t) == {"dvmvs.engine.fill": 20.0, "dvmvs.graph.run": 20.0}


def test_a_gap_across_two_spans_is_split_between_them():
    t = hand_trace(kernel(0, 20), kernel(50, 50),
                   annotation("dvmvs.engine.readback", 0, 30),
                   annotation("dvmvs.stream.buffer", 30, 30))
    assert charged_us(t) == {"dvmvs.engine.readback": 10.0, "dvmvs.stream.buffer": 20.0}
    # the start-of-gap breakdown gives the whole gap to the first
    assert dict(t.breakdown()["idle_gaps"]) == {"dvmvs.engine.readback": pytest.approx(30e-6)}


def test_a_gap_outside_every_span_and_another_threads_span():
    t = hand_trace(kernel(0, 60), kernel(80, 20), annotation("dvmvs.graph.run", 0, 60),
                   annotation("dvmvs.engine.fill", 55, 40, tid=2))
    assert charged_us(t) == {spans.OUTSIDE: 20.0}
    assert spans.counts(t) == {"dvmvs.graph.run": 1}


def test_idle_before_the_first_and_after_the_last_device_operation():
    t = hand_trace(kernel(30, 40), annotation("dvmvs.engine.inputs", 0, 50),
                   annotation("dvmvs.engine.readback", 60, 40))
    assert charged_us(t) == {"dvmvs.engine.inputs": 30.0, "dvmvs.engine.readback": 30.0}


def test_a_device_clock_running_ahead_is_moved_back_before_charging():
    """The kernel issued at 10 shows at 60, the copy to pageable memory whose
    call returns at 55 ends at 85: a lead of 30 us restores one clock (a
    lead of 50 would start the kernel before its launch)."""
    copy = {**kernel(80, 5), "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pageable)"}
    t = hand_trace(call("cudaGraphLaunch", 10, 5, 1), issued(kernel(60, 20), 1),
                   call("cudaMemcpyAsync", 25, 30, 2), issued(copy, 2),
                   annotation("dvmvs.graph.run", 10, 15),
                   annotation("dvmvs.engine.readback", 25, 30),
                   annotation("dvmvs.stream.buffer", 55, 45))
    assert spans.device_lead(t) == {0: 30.0}
    assert spans.busy_intervals(t) == [(30.0, 55.0)]
    assert charged_us(t) == {spans.OUTSIDE: 10.0, "dvmvs.graph.run": 15.0,
                             "dvmvs.engine.readback": 5.0, "dvmvs.stream.buffer": 45.0}


def test_one_clock_is_left_as_it_is():
    t = hand_trace(call("cudaLaunchKernel", 10, 5, 1), issued(kernel(12, 20), 1),
                   call("cudaMemcpyAsync", 40, 30, 2),
                   issued({**kernel(50, 5), "cat": "gpu_memcpy",
                           "name": "Memcpy DtoH (Device -> Pageable)"}, 2))
    assert spans.device_lead(t) == {0: 0.0}
    assert spans.busy_intervals(t) == t.busy_intervals()


def test_self_time_leaves_out_nested_program_spans():
    t = hand_trace(kernel(0, 100), annotation("dvmvs.stream.buffer", 10, 30),
                   annotation("dvmvs.engine.inputs", 15, 10),
                   annotation("dvmvs.stream.buffer", 50, 20))
    assert spans.self_ms(t, "dvmvs.stream.buffer") == pytest.approx(40e-3)


def test_the_span_metrics_read_a_hand_made_trace():
    online = core.Run("fusionnet.online", "cuda", trace=hand_trace(
        kernel(0, 10), kernel(40, 30),
        annotation("dvmvs.stream.buffer", 0, 4), annotation("dvmvs.stream.buffer", 5, 5),
        annotation("dvmvs.engine.fill", 10, 10), annotation("dvmvs.graph.run", 20, 5),
        annotation("dvmvs.engine.readback", 25, 20), annotation("dvmvs.stream.buffer", 70, 30)))
    got = core.read_metrics(core.spec(), online, True)
    assert got["online.engine_idle_ms_per_kf"]["value"] == pytest.approx(30e-3)
    assert got["online.buffer_ms_per_frame"]["value"] == pytest.approx(39e-3 / 3)
    scene = core.Run("pairnet.bulk", "cuda", trace=hand_trace(
        kernel(30, 20), kernel(90, 10),
        annotation("dvmvs.bulk.index", 0, 10), annotation("dvmvs.engine.bank_alloc", 10, 5),
        annotation("dvmvs.graph.capture", 15, 15), annotation("dvmvs.bulk.readback", 50, 10),
        annotation("dvmvs.bulk.readback", 70, 10)))
    got = core.read_metrics(core.spec(), scene, True)
    assert got["bulk.engine_idle_ms_per_chunk"]["value"] == pytest.approx(10e-3)
    assert got["bulk.driver_idle_ms_per_chunk"]["value"] == pytest.approx(15e-3)
    assert got["bulk.rebuilds_per_scene"]["value"] == 2.0


@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_a_cpu_trace_reads_no_span_metric(cell):
    run = tiny.run(cell, seconds=0.5, trace=True)
    assert run.trace is not None and run.trace.device == []
    assert spans.counts(run.trace)  # the program's spans are there
    per_layer = core.read_metrics(core.spec(), run, True)
    assert not set(SPAN_METRICS[cell]) & set(per_layer)


def test_a_bank_forced_to_reallocate_counts_as_a_rebuild(tmp_path):
    """Two scenes of the tiny bulk cell, the second with a bfloat16 bank (a
    new storage), then two more in bfloat16: one rebuild a scene, then none.
    A CPU run captures no graph; with a device operation added to its trace
    the metric reads the same counts."""
    from dvmvs_tpu_torch.apps.engine import InferenceEngine
    from dvmvs_tpu_torch.apps.run_testing import evaluate_scene_batched

    config = tiny.config("pairnet.bulk")
    data = traffic.make(tiny.TRAFFIC["pairnet.bulk"], config, 2 ** 31 + 5)
    cfg = cells.test_config(config)
    engine = InferenceEngine("pairnet", cfg, device="cpu", graphs=True)

    def scenes(path, dtypes):
        holder = {}
        with trace.traced(holder, "cpu"):
            for dtype in dtypes:
                evaluate_scene_batched(engine, "", path, cfg, 8, evaluate=False, assets=assets,
                                       scan_chunk=4, bank_dtype=dtype)
        return holder["trace"]

    lines, _ = bulk.index_lines(data["poses"][0], config["test"])
    path = tmp_path / "keyframe+bench+walk0+nmeas+2"
    path.write_text("\n".join(lines) + "\n")
    assets = bulk.Assets(data["pool"], data["frame_ids"][0], data["poses"][0], data["K"])
    forced, steady = scenes(path, ("f32", "bf16")), scenes(path, ("bf16", "bf16"))
    assert spans.rebuilds(forced) == 1.0 and spans.rebuilds(steady) == 0.0
    device_work = kernel(forced.t0, 1.0)
    run = core.Run("pairnet.bulk", "cuda", trace=trace.Trace(forced.events + [device_work]))
    assert core.read_metrics(core.spec(), run, True)["bulk.rebuilds_per_scene"]["value"] >= 1
