"""The step profiler's trace arithmetic (dvmvs_tpu_torch/apps/profile_step.py)
on hand-made chrome-trace events, and its synthetic training batch; the
profile itself needs a GPU."""

import numpy as np
import pytest

from dvmvs_tpu_torch.apps.profile_step import (
    STEP_RANGE,
    SWEEP_KERNELS,
    WINDOW,
    api_calls,
    kernel_ms_by_prefix,
    launches_per_call,
    ranged,
    summarize_trace,
    synthetic_train_batch,
    union_length,
)


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0, 2), (5, 6)], 3.0),          # disjoint
    ([(0, 4), (1, 2), (3, 6)], 6.0),  # contained and overlapping
    ([(3, 6), (0, 4)], 6.0),          # unsorted
])
def test_union_length(intervals, want):
    assert union_length(intervals) == want


def _span(cat, name, ts, dur, correlation=None):
    event = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": {}}
    if correlation is not None:
        event["args"]["correlation"] = correlation
    return event


def test_summarize_trace_attributes_kernels_to_modules():
    events = [
        _span("user_annotation", WINDOW, 0, 100),
        _span("gpu_user_annotation", WINDOW, 10, 60),  # the device twin is not the window
        _span("user_annotation", "module:encoder", 0, 20),
        _span("user_annotation", "module:decoder", 40, 20),
        _span("cuda_runtime", "cudaLaunchKernel", 5, 1, correlation=1),
        _span("cuda_runtime", "cudaLaunchKernel", 30, 1, correlation=2),
        _span("cuda_runtime", "cudaLaunchKernel", 45, 1, correlation=3),
        _span("cuda_runtime", "cudaMemcpyAsync", 46, 1, correlation=4),
        _span("kernel", "conv", 10, 20, correlation=1),
        _span("kernel", "plane_sweep", 32, 8, correlation=2),
        _span("kernel", "conv", 50, 10, correlation=3),
        _span("gpu_memcpy", "Memcpy DtoH", 55, 10, correlation=4),
        _span("kernel", "late", 120, 5, correlation=5),  # after the window
    ]
    got = summarize_trace(events, n_keyframes=2)
    assert got["wall_ms"] == 0.1
    assert got["device_busy_ms"] == pytest.approx(0.043)  # 10-30, 32-40, 50-65
    assert got["device_idle_share"] == pytest.approx(0.57)
    assert got["device_ops_per_keyframe"] == 2.0
    assert got["device_ms_per_keyframe_by_module"] == pytest.approx(
        {"encoder": 0.01, "decoder": 0.01, "other": 0.004})
    assert got["device_ms_by_kernel"] == pytest.approx(
        {"conv": 0.03, "plane_sweep": 0.008, "Memcpy DtoH": 0.01})


def test_plane_sweep_kernel_time_by_prefix():
    """The forward's prefix must not also count the backward kernel."""
    events = [
        _span("kernel", "void (anonymous namespace)::plane_sweep_kernel<true, true>("
                        "float const*)", 0, 30),
        _span("kernel", "void (anonymous namespace)::plane_sweep_bwd_kernel<true>(float const*)",
              40, 50),
        _span("kernel", "plane_sweep_kernel<false, true>(float const*)", 100, 10),
        _span("kernel", "my_plane_sweep_kernel<true>(float const*)", 110, 10),  # not ours
        _span("kernel", "conv", 120, 70),
        _span("cuda_runtime", "plane_sweep_kernel<", 0, 5),  # a host span
    ]
    got = kernel_ms_by_prefix(events, SWEEP_KERNELS)
    assert got == pytest.approx({"forward": 0.04, "backward": 0.05})


def test_synthetic_train_batch_windows_one_walk():
    batch = synthetic_train_batch(32, batch_size=3, length=4)
    assert batch["images"].shape == (3, 4, 32, 32, 3) and batch["depths"].shape == (3, 4, 32, 32)
    assert batch["poses"].shape == (3, 4, 4, 4) and batch["K"].shape == (3, 3, 3)
    assert all(v.dtype == np.float32 for v in batch.values())
    # element b starts one frame after element b-1
    np.testing.assert_array_equal(batch["poses"][1, :3], batch["poses"][0, 1:])
    np.testing.assert_array_equal(batch["images"][2, 0], batch["images"][0, 2])
    assert (batch["depths"] > 0).mean() > 0.9


def test_summarize_trace_refuses_a_trace_without_device_kernels():
    events = [_span("user_annotation", WINDOW, 0, 100),
              _span("cpu_op", "aten::conv2d", 10, 20)]
    with pytest.raises(RuntimeError, match="no device kernels"):
        summarize_trace(events, n_keyframes=1)


def test_api_calls_count_launches_inside_the_step_ranges():
    """Graph launches, kernel launches (runtime and driver) and copies inside
    the encode_and_predict ranges, a range; calls outside them are left out."""
    events = [
        _span("user_annotation", STEP_RANGE, 0, 10),
        _span("user_annotation", STEP_RANGE, 20, 10),
        _span("cuda_runtime", "cudaMemcpyAsync", 1, 1),
        _span("cuda_runtime", "cudaGraphLaunch", 2, 1),
        _span("cuda_runtime", "cudaMemcpyAsync", 3, 1),
        _span("cuda_runtime", "cudaGraphLaunch", 22, 1),
        _span("cuda_driver", "cuLaunchKernel", 23, 1),
        _span("cuda_runtime", "cudaMemcpyAsync", 24, 1),
        _span("cuda_runtime", "cudaLaunchKernel", 15, 1),  # between the steps
        _span("cpu_op", "aten::copy_", 3, 1),
    ]
    calls = api_calls(events, STEP_RANGE)
    assert calls == {"ranges": 2, "calls": {"cudaMemcpyAsync": 3, "cudaGraphLaunch": 2,
                                            "cuLaunchKernel": 1}}
    assert launches_per_call(calls) == {"cudaGraphLaunch": 1.0, "cudaLaunchKernel": 0.5,
                                        "memcpy": 1.5}


def test_ranged_wraps_one_instance_only():
    class Engine:
        def step(self, x, scale=1):
            return x * scale

    engine, other = Engine(), Engine()
    ranged(engine, ("step",))
    assert engine.step(2, scale=3) == 6 and "step" in vars(engine)
    assert "step" not in vars(other)
