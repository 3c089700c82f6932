"""The arithmetic of the metric readers (``metrics/<name>.py``), each a
function of a run's record (``core.Run``) that returns a number, or None
where the run has nothing to read (no trace, no such kernel)."""

from __future__ import annotations

from benchmark.harness import roofline
from benchmark.harness.core import percentile


def setup_s(run):
    return run.values.get("setup_s")


def keyframe_ms_p95(run):
    return percentile(run.samples.get("kf_ms", []), 95)


def keyframes_per_window_s(run):
    """Keyframes over the whole window."""
    v = run.values
    return v["keyframes"] / v["window_s"] if v.get("window_s") else None


def keyframes_per_call_s(run):
    """Keyframes over the time of the calls that made them."""
    v = run.values
    return v["keyframes"] / v["calls_s"] if v.get("calls_s") else None


def step_ms(run):
    v = run.values
    return 1e3 * v["window_s"] / v["steps"] if v.get("steps") else None


def host_ms_per_frame(run):
    """Window time outside the timed steps, per frame streamed."""
    v, times = run.values, run.samples.get("kf_ms", [])
    if not v.get("frames"):
        return None
    return (1e3 * v["window_s"] - sum(times)) / v["frames"]


def pad_share(run):
    """Percent of the computed keyframe slots that no keyframe asked for."""
    v = run.values
    return 100.0 * (v["slots"] - v["keyframes"]) / v["slots"] if v.get("slots") else None


def launches_per_keyframe(run):
    if run.trace is None or not run.trace.device:
        return None
    return run.trace.launches_per_range("engine.encode_and_predict")


def mfu(run):
    """Percent of the float32 peak in the window's convolution flops."""
    v = run.values
    seconds = v.get("calls_s") or v.get("window_s")
    if not v.get("conv_flops") or not seconds or run.device == "cpu":
        return None
    return 100.0 * v["conv_flops"] / seconds / roofline.PEAK_F32_FLOPS


def sweep_forward_roofline(run):
    return roofline.roofline_share(run, "forward")


def sweep_backward_roofline(run):
    return roofline.roofline_share(run, "backward")


def idle_share(run):
    """Percent of the traced window with no kernel, copy or fill on the device."""
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
