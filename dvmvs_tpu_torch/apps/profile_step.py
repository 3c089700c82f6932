"""Where the time of the online step goes on one GPU.

Streams a synthetic room (``SynthScene`` of data/synthetic.py, NumPy only)
through ``predict_stream`` at the test configuration with two engines, the
graph path (``InferenceEngine(graphs=True)``, each step one CUDA graph
replay) and the eager path (``graphs=False``), and reports for each:

  - the host wall time of ``encode_and_predict`` per keyframe, median and
    p90 over the timed passes (after warm-up passes, the two paths' passes
    in turns), and the median wall time of a whole pass;
  - the peak device memory of a pass (the eager engine's, measured first,
    alone; the graphed engine's above what the eager one holds, its
    captures included);
  - from a ``torch.profiler`` trace of one more pass: device operations per
    keyframe, the device's busy time (union of kernel, memcpy and memset
    intervals) and its idle share of the profiled pass's wall time (the
    profiler's host overhead lengthens that pass, so the share of the
    unprofiled passes' median wall time is given beside it), host API calls
    a keyframe inside ``encode_and_predict`` by name (``cudaGraphLaunch``
    and ``cudaLaunchKernel`` apart), and device time by kernel name; for
    the eager path also device time per top-level module (each kernel
    counts for the module whose forward launched it; "other" is the cost
    volume, the splat, the hidden-state warp and the uploads). Module
    hooks do not run in a replay, so the graph path has no module split.

With ``--train`` it profiles the training step instead (every module
trainable, a capturable Adam) at the reference's training shape (256x256;
fusionnet B=4, S=8; pairnet B=14, S=2, one-way as ``run_training`` trains it) on
frames of the same room, through the graph
(``parallel/train.py::GraphedTrainStep``, one replay a step, the default of
``run_training``) and eagerly (``--no-graphs``), in turns: the step's wall
time, median and p90, the first steps' peak device memory and what stays
reserved after them, and from one profiled step of each path the host API
calls inside it, the device busy time and idle share, the device time by
kernel name and the plane-sweep kernels' share. With ``--train
--run-training DATASET`` it times ``run_training`` itself on a rendered
training corpus (``apps/make_synth_scenes.py``), the input pipeline
included: its logged steps graphed and with ``--no-graphs``, with the
host's OpenBLAS pools as they are and on one thread, in turns, and the
pipeline's wait for a batch.

Run from the repo root: ``python -m dvmvs_tpu_torch.apps.profile_step
[--model fusionnet] [--train [--run-training DATASET]] [--out FILE.json]``.
In IEEE float32, the port's mode (``utils/precision.py``).
"""

from __future__ import annotations

import argparse
import collections
import functools
import json
import os
import re
import subprocess
import tempfile
import time

import numpy as np

from dvmvs_tpu_torch.config import TestConfig
from dvmvs_tpu_torch.data import synthetic as synth
from dvmvs_tpu_torch.utils.precision import ieee_float32

MODULES = ("feature_extractor", "feature_shrinker", "cost_volume_encoder", "lstm_fusion",
           "cost_volume_decoder")
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "profile_step.stream"
N_FRAMES, N_WARMUP_PASSES, N_TIMED_PASSES, N_TOP_KERNELS = 40, 2, 3, 12
N_WARMUP_STEPS, N_TIMED_STEPS, N_ROUNDS = 2, 5, 2
# kernel-name prefixes of csrc/plane_sweep.cu and csrc/plane_sweep_bwd.cu
SWEEP_KERNELS = {"forward": "plane_sweep_kernel", "backward": "plane_sweep_bwd_kernel"}
# the runtime and driver calls that launch one kernel
KERNEL_LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                      "cuLaunchKernelEx")
STEP_RANGE = "engine.encode_and_predict"
TRAIN_RANGE = "train.step"


def synthetic_stream(cfg: TestConfig, n_frames: int):
    """(frames normalised for the network, camera-to-world poses, K float32)
    of a walk through SynthScene(0), 5 cm a step."""
    from dvmvs_tpu_torch.apps.run_testing_online import normalize_rgb

    scene = synth.SynthScene(0)
    poses = scene.trajectory(n_frames, step=0.05)
    K = synth.default_K(cfg.image_width, cfg.image_height)
    frames = [normalize_rgb(scene.render(p, K, cfg.image_width, cfg.image_height)[0])
              for p in poses]
    return frames, poses, K.astype(np.float32)


def synthetic_train_batch(size: int, batch_size: int, length: int) -> dict:
    """A training batch from one walk through SynthScene(0), 3 cm a step:
    element b holds frames b .. b+length-1 (images normalised, depth in m)."""
    from dvmvs_tpu_torch.apps.run_testing_online import normalize_rgb

    scene = synth.SynthScene(0)
    poses = scene.trajectory(batch_size + length - 1).astype(np.float32)
    K = synth.default_K(size, size).astype(np.float32)
    rendered = [scene.render(p, K, size, size) for p in poses]
    images = np.stack([normalize_rgb(rgb) for rgb, _ in rendered])
    depths = np.stack([depth for _, depth in rendered])
    idx = np.arange(batch_size)[:, None] + np.arange(length)[None]
    return {"images": images[idx], "depths": depths[idx], "poses": poses[idx],
            "K": np.stack([K] * batch_size)}


def kernel_ms_by_prefix(events, prefixes: dict) -> dict:
    """Device time (ms) of the kernels whose function name is each prefix,
    template arguments and namespaces aside (CUPTI names them like
    ``void (anonymous namespace)::plane_sweep_kernel<true, true>(...)``)."""
    patterns = {key: re.compile(rf"(?<![\w]){re.escape(prefix)}[<(]")
                for key, prefix in prefixes.items()}
    totals = dict.fromkeys(prefixes, 0.0)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "kernel":
            continue
        for key, pattern in patterns.items():
            if pattern.search(e["name"]):
                totals[key] += e["dur"] / 1e3
    return totals


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    total, reach = 0.0, -np.inf
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def api_calls(events, range_name: str) -> dict:
    """Host CUDA API calls (runtime and driver) by name inside the host
    ranges called ``range_name``, and the number of those ranges."""
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e["name"] == range_name]
    calls = collections.Counter(
        e["name"] for e in events
        if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver")
        and any(a <= e["ts"] <= b for a, b in spans))
    return {"ranges": len(spans), "calls": dict(calls.most_common())}


def launches_per_call(calls: dict) -> dict:
    """``api_calls`` -> graph launches, kernel launches and copies a range."""
    n, c = max(calls["ranges"], 1), calls["calls"]
    kernels = sum(v for k, v in c.items() if k in KERNEL_LAUNCH_APIS)
    copies = sum(v for k, v in c.items() if k.startswith(("cudaMemcpy", "cuMemcpy")))
    return {"cudaGraphLaunch": c.get("cudaGraphLaunch", 0) / n,
            "cudaLaunchKernel": kernels / n, "memcpy": copies / n}


def ranged(obj, names, prefix: str = "engine."):
    """Wrap the methods ``names`` of one object (the instance only) in
    profiler ranges called ``prefix + name``."""
    import torch

    for name in names:
        method = getattr(obj, name)

        def call(*args, method=method, label=prefix + name, **kwargs):
            with torch.profiler.record_function(label):
                return method(*args, **kwargs)

        setattr(obj, name, call)
    return obj


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

    cfg = TestConfig()
    frames, poses, K = synthetic_stream(cfg, N_FRAMES)

    # each engine's peak, the eager one alone and the graphed one above what
    # the eager one holds; the warm-up passes capture the graphs
    engines, peak_mib = {}, {}
    for mode in ("eager", "graphs"):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        engines[mode] = InferenceEngine(model_kind, cfg, device="cuda",
                                        graphs=mode == "graphs")
        for _ in range(N_WARMUP_PASSES):
            predict_stream(engines[mode], frames, poses, K, cfg)
        torch.cuda.synchronize()
        peak_mib[mode] = (torch.cuda.max_memory_allocated() - held) / 2 ** 20

    timers = {mode: InferenceTimer(n_skip=0) for mode in engines}
    pass_ms = {mode: [] for mode in engines}
    for _ in range(N_TIMED_PASSES):
        for mode, engine in engines.items():
            t0 = time.perf_counter()
            predict_stream(engine, frames, poses, K, cfg, timer=timers[mode])
            pass_ms[mode].append((time.perf_counter() - t0) * 1e3)

    report = {"model": model_kind, "frames": f"{N_FRAMES} at {cfg.image_width}x"
              f"{cfg.image_height}", "modes": {}}
    for mode, engine in engines.items():
        ranged(engine, ("encode_and_predict",))
        handles = _annotate_modules(engine.model) if mode == "eager" else []
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
        events = trace_events(prof)
        trace = summarize_trace(events, len(predictions))
        if mode == "graphs":
            del trace["device_ms_per_keyframe_by_module"]
        calls = api_calls(events, STEP_RANGE)
        times = np.asarray(timers[mode].times)
        unprofiled_ms = float(np.median(pass_ms[mode]))
        report["modes"][mode] = {
            "encode_and_predict_ms": {"median": float(np.median(times)),
                                      "p90": float(np.percentile(times, 90)),
                                      "n": int(times.size)},
            "pass_wall_ms_unprofiled": unprofiled_ms,
            "device_idle_share_unprofiled": 1.0 - trace["device_busy_ms"] / unprofiled_ms,
            "peak_memory_mib": peak_mib[mode],
            "host_launches_per_keyframe": launches_per_call(calls),
            "host_api_calls_in_encode_and_predict": calls,
            **trace,
        }
    return report


def trace_events(prof) -> list:
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def train_paths(model_kind: str, batch: dict, flip_mask=None, two_way: bool = None,
                n_warmup: int = N_WARMUP_STEPS, n_timed: int = N_TIMED_STEPS,
                n_rounds: int = N_ROUNDS, seed: int = 0, group=None) -> dict:
    """The training step (every module trainable, a capturable Adam) on
    ``batch`` (device tensors) through the graph
    (``parallel/train.py::GraphedTrainStep``, one replay a step) and eagerly
    (``train_step``), from the same seeded weights; pairnet one-way unless
    ``two_way`` (``run_training``'s default), ``flip_mask`` its flags (default:
    the first direction flipped). For each path: the peak device memory of
    its first ``n_warmup`` steps above what was allocated before them (the
    graph's capture included) and what stays reserved after them (the
    graph's pool); the step's host wall time to the loss's readback, median
    and p90 over ``n_rounds`` rounds of ``n_timed`` steps, the two paths'
    rounds in turns; from one profiled step the host CUDA API calls inside
    it (``cudaGraphLaunch``, kernel launches, copies), the device's busy
    time, its idle share of the profiled step and of the unprofiled median,
    and the device time of the plane-sweep kernels. With ``group`` both
    paths take the data-parallel step (``make_data_parallel`` models,
    ``batch`` this rank's rows)."""
    import copy

    import torch
    from torch.profiler import ProfilerActivity

    from dvmvs_tpu_torch.apps.run_training import make_model
    from dvmvs_tpu_torch.config import TrainConfig
    from dvmvs_tpu_torch.parallel.train import (FUSIONNET_STAGES, PAIRNET_STAGES,
                                                GraphedTrainStep, make_data_parallel,
                                                make_optimizer, train_step)

    cfg = TrainConfig()
    fusion = model_kind == "fusionnet"
    two_way = not fusion and (cfg.predict_two_way if two_way is None else two_way)
    if flip_mask is None:
        flip_mask = torch.tensor([True, False][:2 if two_way else 1])
    stages = FUSIONNET_STAGES if fusion else PAIRNET_STAGES
    base = make_model(model_kind, cfg, "cuda", seed).train()
    steps, peak, kept = {}, {}, {}
    for mode in ("eager", "graphs"):  # the eager path's memory alone, then the graph's
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        model = copy.deepcopy(base)
        if group is not None:
            make_data_parallel(model, group)
        optimizer = make_optimizer(model, stages[-1], cfg.learning_rate)
        if mode == "graphs":
            graphed = GraphedTrainStep(model, model_kind, cfg.loss_type, two_way, group)
            step = functools.partial(graphed.train, optimizer, batch, flip_mask)
        else:
            step = functools.partial(train_step, model, optimizer, batch, model_kind,
                                     cfg.loss_type, two_way, flip_mask.tolist(), group)
        for _ in range(n_warmup):
            step()
        torch.cuda.synchronize()
        peak[mode] = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
        torch.cuda.empty_cache()  # what stays reserved is the graph's pool and the state
        kept[mode] = (torch.cuda.memory_reserved() - reserved) / 2 ** 20
        steps[mode] = step

    step_ms = {mode: [] for mode in steps}
    for _ in range(n_rounds):
        for mode, step in steps.items():
            for _ in range(n_timed):
                t0 = time.perf_counter()
                loss = float(step()["loss"])  # the readback ends the step
                step_ms[mode].append((time.perf_counter() - t0) * 1e3)

    report = {"model": model_kind, "batch": {k: list(v.shape) for k, v in batch.items()},
              "modes": {}}
    for mode, step in steps.items():
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(WINDOW):  # to the step's end on the device
                with torch.profiler.record_function(TRAIN_RANGE):
                    step()
                torch.cuda.synchronize()
        events = trace_events(prof)
        trace = summarize_trace(events, 1)
        calls = api_calls(events, TRAIN_RANGE)
        sweep = kernel_ms_by_prefix(events, SWEEP_KERNELS)
        kernel_ms = sum(e["dur"] for e in events
                        if e.get("ph") == "X" and e.get("cat") == "kernel") / 1e3
        times = np.asarray(step_ms[mode])
        median = float(np.median(times))
        report["modes"][mode] = {
            "step_ms": {"median": median, "p90": float(np.percentile(times, 90)),
                        "n": int(times.size), "all": step_ms[mode]},
            "last_loss": loss,
            "first_pass_peak_mib": peak[mode],
            "kept_mib": kept[mode],
            "host_launches_per_step": launches_per_call(calls),
            "host_api_calls_in_step": calls,
            "profiled_step_wall_ms": trace["wall_ms"],
            "device_busy_ms": trace["device_busy_ms"],
            "device_idle_share": trace["device_idle_share"],
            "device_idle_share_unprofiled": 1.0 - trace["device_busy_ms"] / median,
            "device_ops": trace["device_ops_per_keyframe"],
            "kernel_ms_total": kernel_ms,
            "plane_sweep_kernel_ms": sweep,
            "plane_sweep_share_of_kernel_time": sum(sweep.values()) / kernel_ms,
            "device_ms_by_kernel": trace["device_ms_by_kernel"],
        }
    return report


def run_training_steps(model_kind: str, dataset: str, n_rounds: int = N_ROUNDS, epochs: int = 3,
                 seed: int = 0) -> dict:
    """``run_training``'s own logged step times on the training split of
    ``dataset`` (the input pipeline included): runs of ``epochs`` epochs of
    the last stage, graphed and with ``--no-graphs``, each also with the
    host's OpenBLAS pools on one thread (``utils/blas_threads.py``), in
    turns over ``n_rounds`` rounds; median and p90 of every run's steps but
    its first two (the capture and the first batch). Also the input
    pipeline alone: the wait for each batch of one epoch through
    ``device_prefetch``."""
    import contextlib

    import torch

    from dvmvs_tpu_torch.apps import run_training
    from dvmvs_tpu_torch.config import TrainConfig
    from dvmvs_tpu_torch.data.dataset import MVSSequenceDataset, batch_iterator, device_prefetch
    from dvmvs_tpu_torch.utils.blas_threads import single_threaded_blas

    cfg = TrainConfig()
    length = cfg.subsequence_length if model_kind == "fusionnet" else 2
    batch_size = 4 if model_kind == "fusionnet" else 14
    data = MVSSequenceDataset(dataset, "TRAINING", length, cfg, geometric_scale_augmentation=True,
                              seed=seed)
    t = [time.perf_counter()]
    for _ in device_prefetch(batch_iterator(data, batch_size, shuffle=True, seed=seed), "cuda"):
        torch.cuda.synchronize()
        t.append(time.perf_counter())
    wait = np.diff(t) * 1e3
    report = {"model": model_kind, "batches_per_epoch": int(wait.size),
              "pipeline_wait_ms": {"median": float(np.median(wait)), "all": list(wait)},
              "step_ms": {}}
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for rnd in range(n_rounds):
            order = ("graphs", "eager") if rnd % 2 == 0 else ("eager", "graphs")
            for blas in ("pools", "one_thread"):
                for mode in order:
                    with single_threaded_blas() if blas == "one_thread" \
                            else contextlib.nullcontext():
                        run_dir = run_training.main(
                            ["--model", model_kind, "--dataset", dataset, "--run-directory", tmp,
                             "--epochs", str(epochs), "--finetune-epochs", "0",
                             "--print-frequency", "1", "--no-validate", "--seed", str(seed),
                             "--device", "cuda", *(["--no-graphs"] if mode == "eager" else [])])
                    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
                        logged = [json.loads(line)["step_ms"] for line in f]
                    runs.setdefault(f"{mode}, blas {blas}", []).extend(logged[2:])
    for name, ms in runs.items():
        report["step_ms"][name] = {"median": float(np.median(ms)),
                                   "p90": float(np.percentile(ms, 90)), "n": len(ms)}
    return report


def profile_train(model_kind: str) -> dict:
    """``train_paths`` at the reference's training shape (module doc)."""
    import torch

    from dvmvs_tpu_torch.config import TrainConfig

    cfg = TrainConfig()
    batch_size, length = (4, cfg.subsequence_length) if model_kind == "fusionnet" else (14, 2)
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in
             synthetic_train_batch(cfg.image_width, batch_size, length).items()}
    return train_paths(model_kind, batch)


@ieee_float32()
def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", choices=["pairnet", "fusionnet"], default="fusionnet")
    ap.add_argument("--train", action="store_true",
                    help="profile the training step instead of the online step")
    ap.add_argument("--run-training", default=None, metavar="DATASET",
                    help="with --train: time run_training's own steps on this training "
                         "corpus instead (graphed and --no-graphs, in turns)")
    ap.add_argument("--out", default=None, help="also write the report to this JSON file")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    if args.run_training:
        report = {"card": card, **run_training_steps(args.model, args.run_training)}
    else:
        run = profile_train if args.train else profile
        report = {"card": card, **run(args.model)}
    text = json.dumps(report, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
