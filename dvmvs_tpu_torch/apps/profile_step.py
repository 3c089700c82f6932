"""Where the time of the online step goes on one GPU.

Streams a synthetic room (``SynthScene`` of dvmvs_tpu/data/synthetic.py,
NumPy only) through ``predict_stream`` at the test configuration and
reports:

  - the host wall time of ``encode_and_predict`` per keyframe, median and
    p90 over the timed passes (after warm-up passes), and the median wall
    time of a whole pass;
  - from a ``torch.profiler`` trace of one more pass: device operations per
    keyframe, the device's busy time (union of kernel, memcpy and memset
    intervals) and its idle share of the profiled pass's wall time (the
    profiler's host overhead lengthens that pass, so the share of the
    unprofiled passes' median wall time is given beside it), device time per
    top-level module (each kernel counts for the module whose forward
    launched it; "other" is the cost volume, the splat, the hidden-state
    warp and the uploads), and device time by kernel name.

Run from the repo root: ``python -m dvmvs_tpu_torch.apps.profile_step
[--model fusionnet] [--out FILE.json]``. TF32 is off, as in chip_smoke.py.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import os
import subprocess
import tempfile
import time

import numpy as np

from dvmvs_tpu.config import TestConfig

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MODULES = ("feature_extractor", "feature_shrinker", "cost_volume_encoder", "lstm_fusion",
           "cost_volume_decoder")
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "profile_step.stream"
N_FRAMES, N_WARMUP_PASSES, N_TIMED_PASSES, N_TOP_KERNELS = 40, 2, 3, 12


def synthetic_stream(cfg: TestConfig, n_frames: int):
    """(frames normalised for the network, camera-to-world poses, K float32)
    of a walk through SynthScene(0), 5 cm a step. synthetic.py is loaded by
    path: importing its package would import OpenCV."""
    from dvmvs_tpu_torch.apps.run_testing_online import normalize_rgb

    spec = importlib.util.spec_from_file_location(
        "synthetic_scene", os.path.join(ROOT, "dvmvs_tpu", "data", "synthetic.py"))
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)
    scene = synth.SynthScene(0)
    poses = scene.trajectory(n_frames, step=0.05)
    K = synth.default_K(cfg.image_width, cfg.image_height)
    frames = [normalize_rgb(scene.render(p, K, cfg.image_width, cfg.image_height)[0])
              for p in poses]
    return frames, poses, K.astype(np.float32)


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    total, reach = 0.0, -np.inf
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def summarize_trace(events, n_keyframes: int) -> dict:
    """Chrome-trace events of one profiled pass -> the device breakdown.
    The pass is the ``WINDOW`` range; module ranges are ``module:<name>``;
    device events link to their host launch through ``args.correlation``."""
    spans = [e for e in events if e.get("ph") == "X"]
    # the host range; its device twin (gpu_user_annotation) spans only the kernels
    window = next(e for e in spans if e.get("cat") == "user_annotation" and e["name"] == WINDOW)
    w0, w1 = window["ts"], window["ts"] + window["dur"]
    device = [e for e in spans if e.get("cat") in DEVICE_CATEGORIES and w0 <= e["ts"] < w1]
    if not any(e["cat"] == "kernel" for e in device):
        raise RuntimeError("the trace holds no device kernels: the profiler did not "
                           "trace the GPU")
    launches = {e["args"]["correlation"]: e["ts"] for e in spans
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"].split(":", 1)[1]) for e in spans
              if e.get("cat") == "user_annotation" and e["name"].startswith("module:")]

    by_module, by_name = collections.Counter(), collections.Counter()
    for e in device:
        t = launches.get(e.get("args", {}).get("correlation"))
        # module ranges do not nest: at most one holds the launch
        owner = [r[2] for r in ranges if t is not None and r[0] <= t <= r[1]]
        by_module[owner[0] if owner else "other"] += e["dur"]
        by_name[e["name"][:90]] += e["dur"]
    busy = union_length((e["ts"], min(e["ts"] + e["dur"], w1)) for e in device)
    wall = window["dur"]
    return {
        "keyframes": n_keyframes,
        "wall_ms": wall / 1e3,
        "device_busy_ms": busy / 1e3,
        "device_idle_share": 1.0 - busy / wall,
        "device_ops_per_keyframe": len(device) / n_keyframes,
        "device_ms_per_keyframe_by_module": {
            k: v / 1e3 / n_keyframes for k, v in by_module.most_common()},
        "device_ms_by_kernel": {k: v / 1e3 for k, v in by_name.most_common(N_TOP_KERNELS)},
    }


def _annotate_modules(model):
    """record_function ranges around the forward of each top-level module."""
    import torch

    handles = []
    for name in MODULES:
        module = getattr(model, name, None)
        if module is None:
            continue
        open_ranges = []

        def enter(_module, _inputs, name=name, open_ranges=open_ranges):
            open_ranges.append(torch.profiler.record_function(f"module:{name}"))
            open_ranges[-1].__enter__()

        def leave(_module, _inputs, _output, open_ranges=open_ranges):
            open_ranges.pop().__exit__(None, None, None)

        handles += [module.register_forward_pre_hook(enter), module.register_forward_hook(leave)]
    return handles


def profile(model_kind: str) -> dict:
    import torch
    from torch.profiler import ProfilerActivity

    from dvmvs_tpu_torch.apps.engine import InferenceEngine
    from dvmvs_tpu_torch.apps.run_testing_online import predict_stream
    from dvmvs_tpu_torch.utils.results import InferenceTimer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TestConfig()
    frames, poses, K = synthetic_stream(cfg, N_FRAMES)
    engine = InferenceEngine(model_kind, cfg, device="cuda")
    for _ in range(N_WARMUP_PASSES):
        predict_stream(engine, frames, poses, K, cfg)
    timer = InferenceTimer(n_skip=0)
    pass_ms = []
    for _ in range(N_TIMED_PASSES):
        t0 = time.perf_counter()
        predict_stream(engine, frames, poses, K, cfg, timer=timer)
        pass_ms.append((time.perf_counter() - t0) * 1e3)

    handles = _annotate_modules(engine.model)
    try:
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(WINDOW):
                predictions, _ = predict_stream(engine, frames, poses, K, cfg)
            torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]

    times = np.asarray(timer.times)
    trace = summarize_trace(events, len(predictions))
    unprofiled_ms = float(np.median(pass_ms))
    return {
        "model": model_kind,
        "frames": f"{N_FRAMES} at {cfg.image_width}x{cfg.image_height}",
        "encode_and_predict_ms": {"median": float(np.median(times)),
                                  "p90": float(np.percentile(times, 90)),
                                  "n": int(times.size)},
        "pass_wall_ms_unprofiled": unprofiled_ms,
        "device_idle_share_unprofiled": 1.0 - trace["device_busy_ms"] / unprofiled_ms,
        **trace,
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", choices=["pairnet", "fusionnet"], default="fusionnet")
    ap.add_argument("--out", default=None, help="also write the report to this JSON file")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    report = {"card": card, **profile(args.model)}
    text = json.dumps(report, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
