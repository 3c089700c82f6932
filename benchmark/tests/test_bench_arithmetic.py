"""The yardstick's arithmetic against hand-worked cases: the union of busy
intervals and the idle share, a plane sweep's bound, the flop count."""

import json

import pytest
import torch
import torch.nn as nn
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import core, flops, readers, roofline, trace
from benchmark.harness.trace import WINDOW, Trace


def test_union_length():
    assert trace.union_length([]) == 0
    assert trace.union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert trace.union_length([(0, 10), (2, 3)]) == 10
    assert trace.merged([(5, 6), (0, 2), (1, 3)]) == [(0, 3), (5, 6)]


def events():
    """A window of 100 us: kernels over 10-30 and 25-40, a copy over 60-70;
    one graph launch and one kernel launch inside a step range; the idle
    gap 40-60 begins inside a range of the benchmark's own."""
    return [
        {"ph": "X", "cat": "user_annotation", "name": WINDOW, "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "engine.encode_and_predict", "ts": 5,
         "dur": 10},
        {"ph": "X", "cat": "user_annotation", "name": "bulk.scene", "ts": 38, "dur": 30},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 6, "dur": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 8, "dur": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 50, "dur": 1},
        {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::plane_sweep_kernel<true>()",
         "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "sm90_xmma_fprop", "ts": 25, "dur": 15},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 60, "dur": 10},
    ]


def test_trace_idle_share_launches_and_kernel_time():
    t = Trace(events())
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(40e-6)
    run = core.Run("c", "cuda", trace=t)
    assert readers.idle_share(run) == pytest.approx(60.0)
    assert t.launches_per_range("engine.encode_and_predict") == 2
    assert t.kernel_s(roofline.FORWARD_KERNELS) == pytest.approx(20e-6)
    gaps = dict(t.breakdown()["idle_gaps"])
    assert gaps == pytest.approx({"bulk.scene": 20e-6, "host outside spans": 40e-6})


def test_sweep_bound_of_an_identity_warp():
    """Every sample of the identity warp is in range: B=1, V=1, P=2, 4x4
    pixels, C=8: 32 samples x 8 channels x 10 flops = 2560 flops; bytes
    4 x (16 x 8 ref + 16 x 8 meas + 18 mats + 1 weight + 32 out) = 1228."""
    mats = torch.eye(3).expand(1, 1, 2, 3, 3).contiguous()
    weights = torch.ones(1, 1)
    assert int(roofline.in_range_samples(mats, weights, 4, 4)[0]) == 32
    bound = roofline.sweep_bound_s(mats, weights, 4, 4, 8, 1)
    assert bound == pytest.approx(max(1228 / roofline.PEAK_BYTES_PER_S,
                                      2560 / roofline.PEAK_F32_FLOPS))
    back = roofline.sweep_bound_s(mats, weights, 4, 4, 8, 1, backward=True)
    assert back == pytest.approx(max((1228 + 4 * 256) / roofline.PEAK_BYTES_PER_S,
                                     32 * 8 * 16 / roofline.PEAK_F32_FLOPS))
    masked = roofline.sweep_bound_s(mats, torch.zeros(1, 1), 4, 4, 8, 1)
    assert masked == pytest.approx(4 * (128 + 18 + 1 + 32) / roofline.PEAK_BYTES_PER_S)


def test_flop_count_of_a_convolution():
    """A 3x3 convolution of 4 to 8 channels over 1x4x10x10: 2 x 8 x 100 x
    4 x 9 = 57600 flops, as FlopCounterMode counts a forward; a depthwise
    one of 8 channels 2 x 8 x 100 x 9 = 14400."""
    conv = nn.Conv2d(4, 8, 3, padding=1, bias=False)
    depthwise = nn.Conv2d(8, 8, 3, padding=1, groups=8, bias=False)
    for module, x, expected in ((conv, torch.zeros(1, 4, 10, 10), 57600),
                                (depthwise, torch.zeros(1, 8, 10, 10), 14400)):
        with FlopCounterMode(display=False) as counter:
            module(x)
        assert counter.get_total_flops() == expected
        assert flops._count(module, lambda: module(x)) == (expected, 0)


def test_flop_counter_mode_overcounts_a_grouped_backward():
    """Why training is not counted by FlopCounterMode: it counts a
    depthwise convolution's backward as if it were dense (8 groups: 9x the
    forward instead of 2x), which put MnasNet's training step at 3.21
    TFLOP instead of 2.33."""
    depthwise = nn.Conv2d(8, 8, 3, padding=1, groups=8, bias=False)
    x = torch.zeros(1, 8, 10, 10, requires_grad=True)
    with FlopCounterMode(display=False) as counter:
        depthwise(x).sum().backward()
    assert counter.get_total_flops() == 14400 + 9 * 14400


def test_model_flops_at_the_published_shapes():
    """The forward counts equal FlopCounterMode's over the reference at
    320x256 (34.5 GFLOP a keyframe); training is 3x every convolution's
    forward less the input gradient of the one that reads the frames."""
    config = core.load_json("configs", "fusionnet")
    online = flops._inference("fusionnet", config["sizes"], config["test"])
    assert online["encode"] + online["predict"] == 34504007680
    model = flops._model("fusionnet", config["sizes"], False, "cpu")
    image = torch.zeros(1, 3, 256, 320)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model.extract_features(image)
    assert counter.get_total_flops() == online["encode"]
    assert flops._train_step("fusionnet", config["sizes"], config["train"]) == 2332105900032


def test_flop_counts_are_kept_by_what_they_depend_on(tmp_path, monkeypatch):
    monkeypatch.setattr(flops, "CACHE", tmp_path / "flops.json")
    calls = []
    count = lambda: calls.append(1) or 7
    assert flops.cached("x", [1, {"a": 2}], count) == 7
    assert flops.cached("x", [1, {"a": 2}], count) == 7 and len(calls) == 1
    assert flops.cached("x", [1, {"a": 3}], count) == 7 and len(calls) == 2
    assert len(json.loads((tmp_path / "flops.json").read_text())) == 2


def test_readers_of_host_records():
    run = core.Run("c", "cuda", values={"window_s": 2.0, "keyframes": 100, "frames": 400,
                                       "steps": 10, "slots": 128, "calls_s": 1.0,
                                       "conv_flops": 67e12},
                   samples={"kf_ms": list(range(1, 101))})
    assert readers.keyframes_per_window_s(run) == 50
    assert readers.keyframes_per_call_s(run) == 100
    assert readers.step_ms(run) == 200
    assert readers.keyframe_ms_p95(run) == pytest.approx(95.05)
    steady = core.Run("c", "cuda", values=run.values, samples={"kf_ms": [5.0] * 100})
    assert readers.host_ms_per_frame(steady) == pytest.approx((2000 - 500) / 400)
    assert readers.pad_share(run) == pytest.approx(100 * 28 / 128)
    assert readers.mfu(run) == pytest.approx(100.0)
    assert readers.mfu(core.Run("c", "cpu", values=run.values)) is None
    assert readers.idle_share(run) is None and readers.sweep_forward_roofline(run) is None
    assert core.seeds(2 ** 31 + 5, 2) == core.seeds(2 ** 31 + 5, 2) != core.seeds(2 ** 31 + 6, 2)
