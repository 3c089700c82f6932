"""The port's spans and counters (utils/profiling.py) on the CPU, at
tests/test_torch_graphs.py's tiny size (96x64 frames, 64 planes, V=2).

  - A ``torch.profiler`` trace of the engine's graphed steps holds
    ``dvmvs.engine.inputs``, ``dvmvs.engine.fill``, ``dvmvs.graph.run`` and
    ``dvmvs.engine.readback`` in that order, inside the caller's range and
    on its clock; ``predict_stream`` adds one ``dvmvs.stream.buffer`` a
    frame; ``evaluate_scene_batched`` its four ``dvmvs.bulk.*`` spans; a
    graphed baseline's ``predict`` through ``evaluate_scene_baseline`` the
    four ``dvmvs.baseline.*`` spans, none inside a step body or a capture.
  - With no profiler running a span makes no ``record_function``.
  - The counters: the scan schedule's slots and padding, a second bank's
    allocation, graph builds and evictions, the launch counts a replay adds
    back, a baseline ``predict`` and its bytes, and (on the card) a capture.

The test marked ``cuda`` skips here and runs on the card with ``python -m
pytest --noconftest -q tests/test_torch_tracing.py -m cuda``.
"""

import json

import numpy as np
import pytest
import torch

from dvmvs_tpu_torch.apps import run_testing as rt
from dvmvs_tpu_torch.apps import run_testing_baseline as rtb
from dvmvs_tpu_torch.apps.engine import InferenceEngine
from dvmvs_tpu_torch.apps.graphs import LAUNCHES, StepGraph
from dvmvs_tpu_torch.apps.run_testing_online import predict_stream
from dvmvs_tpu_torch.baselines.deltas import Deltas
from dvmvs_tpu_torch.config import DepthConfig, TestConfig
from dvmvs_tpu_torch.utils import profiling
from dvmvs_tpu_torch.utils.profiling import counters, span

H, W, V, N_FRAMES = 64, 96, 2, 9
ENGINE_SPANS = ["dvmvs.engine.inputs", "dvmvs.engine.fill", "dvmvs.graph.run",
                "dvmvs.engine.readback"]
BULK_SPANS = {"dvmvs.bulk.index", "dvmvs.bulk.frames", "dvmvs.bulk.schedule",
              "dvmvs.bulk.readback"}
B, CHUNK = 2, 2
BASELINE_SPANS = ["dvmvs.baseline.frames", "dvmvs.baseline.inputs", "dvmvs.baseline.fill",
                  "dvmvs.graph.run", "dvmvs.baseline.readback"]
# one DELTAS predict at H x W with V views: the frames, V relative poses
# (4x4), K and the view mask in; the depth out
BASELINE_H2D = 4 * ((1 + V) * H * W * 3 + V * 16 + 9 + V)
BASELINE_D2H = 4 * H * W


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cfg():
    return TestConfig(image_width=W, image_height=H, depth=DepthConfig(0.25, 20.0, 64),
                      n_measurement_frames=V)


def stream_inputs(seed=3):
    """Frames and poses 0.12 m apart along x with small rotations (each a
    keyframe after the first), and K."""
    rs = np.random.RandomState(seed)
    frames = [rs.randn(H, W, 3).astype(np.float32) for _ in range(N_FRAMES)]
    poses = []
    for i in range(N_FRAMES):
        a, b = 0.02 * rs.randn(2)
        pose = np.eye(4)
        pose[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
        pose[:3, :3] = pose[:3, :3] @ [[np.cos(b), 0, np.sin(b)], [0, 1, 0],
                                       [-np.sin(b), 0, np.cos(b)]]
        pose[:3, 3] = (0.12 * i, 0.01 * rs.randn(), 0.02 * rs.randn())
        poses.append(pose)
    K = np.array([[70.0, 0, W / 2], [0, 70.0, H / 2], [0, 0, 1]], np.float32)
    return frames, poses, K


def ranges(fn, tmp_path, device="cpu"):
    """The host ranges of ``fn()`` traced inside a "caller" range: (caller,
    the ``dvmvs.*`` ranges by start), each (name, start, end) in us."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device != "cpu":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function("caller"):
            fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    caller = next((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                  if e["name"] == "caller")
    spans = sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                    if e["name"].startswith("dvmvs.")), key=lambda s: (s[1], -s[2]))
    return caller, spans


class Assets:
    """A scene in memory for ``evaluate_scene_batched``: frame i is named
    ``f<i>``."""

    depth_filenames = None

    def __init__(self, frames, poses, K):
        self.frames, self.poses, self.updated_K = frames, poses, K

    def image(self, name):
        return self.frames[int(name[1:])]

    def pose(self, name):
        return self.poses[int(name[1:])]


def scene(tmp_path, n_keyframes=5):
    """An index file of ``n_keyframes`` keyframes (each frame against the
    two before it) and its assets."""
    frames, poses, K = stream_inputs()
    lines = [f"f{i} f{i - 1} f{i - 2}" for i in range(2, 2 + n_keyframes)]
    path = tmp_path / "keyframe+test+scene+nmeas+2"
    path.write_text("\n".join(lines) + "\n")
    return str(path), Assets(frames, poses, K)


def bulk_call(engine, index, assets, dtype="f32"):
    return rt.evaluate_scene_batched(engine, "", index, tiny_cfg(), B, evaluate=False,
                                     assets=assets, scan_chunk=CHUNK, bank_dtype=dtype)


def test_engine_spans_nest_in_order_inside_the_caller(tmp_path):
    engine = InferenceEngine("fusionnet", tiny_cfg(), device="cpu", seed=1)
    frames, poses, K = stream_inputs()

    def steps():
        half = engine.encode(frames[0])[0]
        engine.encode_and_predict(frames[1], [half], poses[1], [poses[0]], K)

    caller, spans = ranges(steps, tmp_path)
    assert [s[0] for s in spans] == ENGINE_SPANS[1:3] + ENGINE_SPANS
    assert all(caller[1] <= s[1] <= s[2] <= caller[2] for s in spans)  # one clock
    assert all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))  # one after the other


def test_predict_stream_spans_the_buffer_once_a_frame(tmp_path):
    engine = InferenceEngine("pairnet", tiny_cfg(), device="cpu", seed=1)
    frames, poses, K = stream_inputs()
    got = {}

    def stream():
        got["depths"], got["indices"] = predict_stream(engine, frames, poses, K, tiny_cfg())

    _, spans = ranges(stream, tmp_path)
    names = [s[0] for s in spans]
    assert names.count("dvmvs.stream.buffer") == N_FRAMES
    assert names.count("dvmvs.engine.readback") == len(got["depths"]) > 0
    buffers = [s for s in spans if s[0] == "dvmvs.stream.buffer"]
    assert not any(b[1] < s[1] < b[2] for b in buffers for s in spans if s not in buffers)


def test_evaluate_scene_batched_spans_and_counts_its_slots(tmp_path):
    index, assets = scene(tmp_path)
    engine = InferenceEngine("pairnet", tiny_cfg(), device="cpu", seed=1)
    before = counters.snapshot()
    _, spans = ranges(lambda: bulk_call(engine, index, assets), tmp_path)
    names = [s[0] for s in spans]
    assert BULK_SPANS <= set(names)
    schedule = rt._scan_schedule(-(-5 // B), CHUNK)  # 3 steps of 2: [2, 1]
    assert names.count("dvmvs.bulk.index") == names.count("dvmvs.bulk.schedule") == 1
    assert names.count("dvmvs.bulk.readback") == len(schedule) == 2
    assert names.count("dvmvs.bulk.frames") == -(-7 // B)  # 7 unique frames
    moved = counters.since(before)
    assert moved["bulk.slots"] == sum(schedule) * B == 6 and moved["bulk.pad_slots"] == 1


def test_a_second_bank_counts_its_allocation_builds_and_evictions(tmp_path):
    """f32 then bfloat16 banks: the second is a new storage, and the two chunk
    graphs (chunks of 2 and 1) that read the first are dropped and built
    again; a third call in bfloat16 builds and drops nothing."""
    index, assets = scene(tmp_path)
    engine = InferenceEngine("pairnet", tiny_cfg(), device="cpu", seed=1)
    before = counters.snapshot()
    bulk_call(engine, index, assets, "f32")
    first = counters.since(before)
    assert (first["bank.allocations"], first["graph.builds"]) == (1, 3)  # encode_batch, 2 chunks
    assert "graph.evictions" not in first
    before = counters.snapshot()
    bulk_call(engine, index, assets, "bf16")
    second = counters.since(before)
    assert (second["bank.allocations"], second["graph.builds"], second["graph.evictions"]) \
        == (1, 2, 2)
    before = counters.snapshot()
    bulk_call(engine, index, assets, "bf16")
    assert not {"bank.allocations", "graph.builds", "graph.evictions"} & set(
        counters.since(before))


def test_no_record_function_without_a_profiler(monkeypatch, tmp_path):
    made = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: (made.append(name), real(name))[1])
    engine = InferenceEngine("pairnet", tiny_cfg(), device="cpu", seed=1)
    frames, poses, K = stream_inputs()
    predict_stream(engine, frames, poses, K, tiny_cfg())
    assert made == [] and span("a") is span("b")
    ranges(lambda: predict_stream(engine, frames[:3], poses[:3], K, tiny_cfg()), tmp_path)
    assert "dvmvs.stream.buffer" in made and "dvmvs.graph.run" in made


def test_replays_add_the_recorded_launches_back():
    """A step with a captured graph (here a stand-in that records its
    replays) adds its recorded launch counts to the counters at each run."""
    x = torch.zeros(2)
    step = StepGraph("toy", lambda x: x + 1.0, {"x": x})
    replays = []
    step.device, step.outputs = torch.device("cuda"), x
    step.graph = type("Replayed", (), {"replay": lambda self: replays.append(1)})()
    step.launches = (2, 1, 3)
    before = counters.snapshot()
    step.run()
    step.run()
    assert len(replays) == 2
    assert counters.since(before) == dict(zip(LAUNCHES, (4, 2, 6)))
    assert profiling.describe_counts({"b": 2, "a": 1}) == "counters: a 1, b 2"


class SmallDeltas(Deltas):
    image_width, image_height = W, H


def baseline_line(estimator, tmp_path):
    """``evaluate_scene_baseline`` over one keyframe line, frames from
    memory."""
    frames, poses, K = stream_inputs()
    path = tmp_path / "keyframe+test+scene+nmeas+2"
    path.write_text("f2 f1 f0\n")
    return rtb.evaluate_scene_baseline(estimator, "", str(path), evaluate=False,
                                       assets=Assets(frames, poses, K))


def test_a_graphed_baseline_predict_spans_its_host_work_and_counts_its_bytes(tmp_path):
    """DELTAS on static buffers: the line's frames, then the predict's
    inputs, fill, graph run and readback, one after another inside the
    caller; none inside the graph run (the step body, which a capture
    records); one predict counted with its bytes in and out."""
    est = SmallDeltas(device="cpu", seed=1, graphs=True)
    before = counters.snapshot()
    caller, spans = ranges(lambda: baseline_line(est, tmp_path), tmp_path)
    moved = counters.since(before)
    assert [s[0] for s in spans] == BASELINE_SPANS
    assert all(caller[1] <= s[1] <= s[2] <= caller[2] for s in spans)
    assert all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))
    assert moved["baseline.predicts"] == 1
    assert moved["baseline.h2d_bytes"] == BASELINE_H2D == 221356
    assert moved["baseline.d2h_bytes"] == BASELINE_D2H


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs capture only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_capture_is_counted_and_spanned_on_the_card(cuda_device, tmp_path):
    """The first graphed step captures once (a ``dvmvs.graph.capture`` span
    inside ``dvmvs.graph.run``, ``graph.captures`` 1); the next replays:
    no capture, one forward launch added back."""
    engine = InferenceEngine("pairnet", tiny_cfg(), device=cuda_device, seed=1)
    frames, poses, K = stream_inputs()
    half = engine.encode(frames[0])[0]

    def step():
        engine.encode_and_predict(frames[1], [half], poses[1], [poses[0]], K)
        torch.cuda.synchronize()

    before = counters.snapshot()
    _, spans = ranges(step, tmp_path, "cuda")
    first = counters.since(before)
    captures = [s for s in spans if s[0] == "dvmvs.graph.capture"]
    run = next(s for s in spans if s[0] == "dvmvs.graph.run")
    assert len(captures) == 1 and run[1] <= captures[0][1] <= captures[0][2] <= run[2]
    assert first["graph.captures"] == 1 and first["engine.d2h_bytes"] == 4 * 64 * 96
    before = counters.snapshot()
    _, spans = ranges(step, tmp_path, "cuda")
    again = counters.since(before)
    assert "dvmvs.graph.capture" not in {s[0] for s in spans} and "graph.captures" not in again
    assert again[LAUNCHES[0]] == 1 and LAUNCHES[1] not in first


@pytest.mark.cuda
def test_a_baseline_capture_holds_no_baseline_span_on_the_card(cuda_device, tmp_path):
    """DELTAS's first graphed predict captures its step (``dvmvs.graph.
    capture``) with no ``dvmvs.baseline.*`` span inside it; the second
    replays; each counts one predict and its bytes."""
    est = SmallDeltas(device=cuda_device, seed=1, graphs=True)
    for captured in (True, False):
        before = counters.snapshot()
        _, spans = ranges(lambda: baseline_line(est, tmp_path), tmp_path, "cuda")
        moved = counters.since(before)
        captures = [s for s in spans if s[0] == "dvmvs.graph.capture"]
        assert len(captures) == int(captured)
        assert not any(c[1] <= s[1] < c[2] for c in captures for s in spans
                       if s[0].startswith("dvmvs.baseline."))
        assert [s[0] for s in spans if s[0] != "dvmvs.graph.capture"] == BASELINE_SPANS
        assert (moved["baseline.predicts"], moved["baseline.h2d_bytes"],
                moved["baseline.d2h_bytes"]) == (1, BASELINE_H2D, BASELINE_D2H)
