"""Keyframes per second of every bulk evaluation mode of
``apps/run_testing.py`` on one GPU, over scenes long enough that batches are
full and each timed run lasts seconds.

The scenes: ``--scenes`` SynthScene walks (seeds 21, 22, ...) of
``--frames`` frames at ``--step`` m a frame, so that the keyframe buffer
keeps most frames, rendered at 640x480 like ScanNet by spawned workers,
written as scene folders (``data/scene_folders.py``) and indexed by
``simulate_keyframe_buffer`` (nmeas 2). Every frame is decoded, cropped and
resized to 320x256 once before any timing, and no ground truth is read, so
the numbers are the device path and the driver, not the PNG decode. Seeded
random weights (the work does not depend on them), ``TestConfig``, IEEE float32
(the port's mode).

Modes, on the eager path (``InferenceEngine(graphs=False)``): pairnet
sequential (``evaluate_scene``), batched B=``--batch`` with a readback every
batch, the same in chunks of ``--chunk`` batches a readback, and with a
bfloat16 bank; fusionnet sequential and lockstep over all the scenes
(``evaluate_scenes_batched_fusion``) in the same three variants. On the
graph path (``graphs=True``, each chunk one CUDA graph replay): pairnet
batched and fusionnet lockstep in chunks of ``--chunk``. Each mode is warmed
up once on its first keyframes (which captures the graphs), then timed
``--reps`` times; within a repetition the modes run in turn, so that drift
of the host touches all of them alike. Per mode it prints the median
keyframes/s with the minimum, maximum and spread ((max - min) / median),
the peak device memory (every engine of the bench resident) beside what
was held at the run's start (the engines' weights, retained banks and
graphs), the forward
kernel's launches per run, the host's CUDA API launches a keyframe
(``cudaGraphLaunch``, kernel launches and copies, from a ``torch.profiler``
run over the warm-up keyframes) and the largest relative depth difference
to the sequential run; then the card's ``name, power.limit`` and, with
``--json``, writes it all there.

Run on the card from the repo root: ``python -m
dvmvs_tpu_torch.apps.bench_bulk [--reps 5] [--json
chiprun_out/bench_bulk.json]``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from dvmvs_tpu_torch.apps import run_testing as rt
from dvmvs_tpu_torch.apps.engine import InferenceEngine
from dvmvs_tpu_torch.apps.profile_step import KERNEL_LAUNCH_APIS
from dvmvs_tpu_torch.apps.simulate_keyframe_buffer import simulate_dataset
from dvmvs_tpu_torch.config import TestConfig
from dvmvs_tpu_torch.data.scene_folders import write_scene_folders
from dvmvs_tpu_torch.ops import plane_sweep
from dvmvs_tpu_torch.utils.precision import ieee_float32
from dvmvs_tpu_torch.utils.profiling import counters

DATASET, FRAME = "synth640", (640, 480)


def make_scenes(root: str, n_scenes: int, n_frames: int, step: float, workers: int):
    """Scene folders and index files; returns [(folder, index file)]."""
    folders = write_scene_folders(os.path.join(root, DATASET),
                                  [(21 + i, n_frames) for i in range(n_scenes)], FRAME, step,
                                  workers=workers)
    simulate_dataset(os.path.join(root, DATASET), os.path.join(root, "indices"), 2)
    return [(f, os.path.join(root, "indices", f"keyframe+{DATASET}+{os.path.basename(f)}+nmeas+2"))
            for f in folders]


def modes(pair, fusion, jobs, assets, cfg, batch: int, chunk: int, graphed=None):
    """name -> fn(max_frames) returning the depth maps of every scene in
    order; ``graphed``: the (pairnet, fusionnet) engines of the graph
    modes."""
    cache = {os.path.abspath(f): a for (f, _), a in zip(jobs, assets)}

    def per_scene(fn):
        return lambda m: [d for (f, i), a in zip(jobs, assets) for d in fn(f, i, a, m)]

    def batched(scan, dtype, engine=pair):
        return per_scene(lambda f, i, a, m: rt.evaluate_scene_batched(
            engine, f, i, cfg, batch, evaluate=False, max_frames=m, assets=a, scan_chunk=scan,
            bank_dtype=dtype)[0])

    def lockstep(scan, dtype, engine=fusion):
        return lambda m: [d for p, _ in rt.evaluate_scenes_batched_fusion(
            engine, jobs, cfg, evaluate=False, max_frames=m, asset_cache=cache, scan_chunk=scan,
            bank_dtype=dtype) for d in p]

    n = len(jobs)
    graph_modes = {} if graphed is None else {
        f"pairnet batched B={batch} chunk {chunk} graphs": batched(chunk, "f32", graphed[0]),
        f"fusionnet lockstep x{n} chunk {chunk} graphs": lockstep(chunk, "f32", graphed[1]),
    }
    return {
        "pairnet sequential": per_scene(lambda f, i, a, m: rt.evaluate_scene(
            pair, f, i, cfg, evaluate=False, max_frames=m, assets=a)[0]),
        f"pairnet batched B={batch}": batched(0, "f32"),
        f"pairnet batched B={batch} chunk {chunk}": batched(chunk, "f32"),
        f"pairnet batched B={batch} bf16 bank": batched(0, "bf16"),
        "fusionnet sequential": per_scene(lambda f, i, a, m: rt.evaluate_scene(
            fusion, f, i, cfg, evaluate=False, max_frames=m, assets=a)[0]),
        f"fusionnet lockstep x{n}": lockstep(0, "f32"),
        f"fusionnet lockstep x{n} chunk {chunk}": lockstep(chunk, "f32"),
        f"fusionnet lockstep x{n} bf16 bank": lockstep(0, "bf16"),
    } | graph_modes


def host_launches(fn) -> dict:
    """Host CUDA API calls of ``fn()`` from a ``torch.profiler`` run: graph
    launches, kernel launches (runtime and driver) and copies."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = {e.key: e.count for e in prof.key_averages()}
    return {"cudaGraphLaunch": counts.get("cudaGraphLaunch", 0),
            "cudaLaunchKernel": sum(counts.get(k, 0) for k in KERNEL_LAUNCH_APIS),
            "memcpy": sum(v for k, v in counts.items()
                          if k.startswith(("cudaMemcpy", "cuMemcpy")))}


def timed(fn, cuda: bool):
    """fn() with its forward launches counted: (result, seconds to the last
    readback, peak MiB, MiB held at the start: every engine's weights,
    retained bank and graphs (both 0 off the card), forward launches)."""
    held = 0.0
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2 ** 20
    before = counters[plane_sweep.FORWARD_LAUNCHES]
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize()
    return (out, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 2 ** 20 if cuda else 0.0, held,
            counters[plane_sweep.FORWARD_LAUNCHES] - before)


@ieee_float32()
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scenes", type=int, default=3)
    ap.add_argument("--frames", type=int, default=200, help="frames a scene")
    ap.add_argument("--step", type=float, default=0.2, help="metres of walk a frame")
    ap.add_argument("--batch", type=int, default=8, help="pairnet keyframes a batch")
    ap.add_argument("--chunk", type=int, default=4, help="steps queued between readbacks")
    ap.add_argument("--reps", type=int, default=5, help="timed runs a mode")
    ap.add_argument("--warmup-frames", type=int, default=16,
                    help="keyframes a scene in each mode's warm-up run")
    ap.add_argument("--workers", type=int, default=8, help="render processes")
    ap.add_argument("--width", type=int, default=None, help="test width (default TestConfig's)")
    ap.add_argument("--height", type=int, default=None,
                    help="test height (default TestConfig's)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (a dry run)")
    ap.add_argument("--json", default=None, help="write the report here too")
    args = ap.parse_args(argv)

    cfg = TestConfig(**{k: v for k, v in (("image_width", args.width),
                                          ("image_height", args.height)) if v is not None})
    pair, fusion = (InferenceEngine(kind, cfg, device=args.device, seed=0, graphs=False)
                    for kind in ("pairnet", "fusionnet"))
    graphed = tuple(InferenceEngine(kind, cfg, device=args.device, seed=0)
                    for kind in ("pairnet", "fusionnet"))
    cuda = pair.device.type == "cuda"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0] if cuda else "cpu"

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        jobs = make_scenes(tmp, args.scenes, args.frames, args.step, args.workers)
        render_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        assets = []
        for folder, _ in jobs:
            a = rt.SceneAssets(folder, cfg, evaluate=False, cache_frames=args.frames)
            for name in a.image_filenames:
                a.image(name)
            assets.append(a)
        decode_ms = (time.perf_counter() - t0) * 1e3 / (args.scenes * args.frames)
        keyframes = [sum(line != "TRACKING LOST" for line in rt.read_index(i)) for _, i in jobs]
        n_kf = sum(keyframes)
        print(f"[scenes] {args.scenes} scenes of {args.frames} frames at {FRAME[0]}x{FRAME[1]} "
              f"({', '.join(map(str, keyframes))} keyframes) rendered and indexed in "
              f"{render_s:.1f} s; decode, crop and resize to {cfg.image_width}x"
              f"{cfg.image_height} {decode_ms:.1f} ms a frame", flush=True)

        runs = modes(pair, fusion, jobs, assets, cfg, args.batch, args.chunk, graphed)
        report = {name: {"keyframes_per_s": [], "peak_mib": 0.0, "held_mib": 0.0,
                         "launches": None} for name in runs}
        for name, fn in runs.items():
            n_warm = len(fn(args.warmup_frames))
            if cuda:
                report[name]["host_launches_per_keyframe"] = {
                    k: v / n_warm for k, v in host_launches(
                        lambda fn=fn: fn(args.warmup_frames)).items()}
        depths = {}
        for rep in range(args.reps):
            for name, fn in runs.items():
                out, seconds, peak, held, launches = timed(lambda: fn(None), cuda)
                if len(out) != n_kf:
                    raise AssertionError(f"{name}: {len(out)} depth maps of {n_kf}")
                r = report[name]
                r["keyframes_per_s"].append(n_kf / seconds)
                if peak >= r["peak_mib"]:
                    r["peak_mib"], r["held_mib"] = peak, held
                r["launches"] = launches
                if rep == 0:
                    depths[name] = out
            print(f"[rep {rep}] " + ", ".join(
                f"{n} {r['keyframes_per_s'][-1]:.1f}" for n, r in report.items()), flush=True)

    for name, r in report.items():
        rates = np.asarray(r["keyframes_per_s"])
        base = depths["pairnet sequential" if name.startswith("pairnet")
                      else "fusionnet sequential"]
        r.update(median=float(np.median(rates)), min=float(rates.min()), max=float(rates.max()),
                 spread=float((rates.max() - rates.min()) / np.median(rates)),
                 max_rel_gap=max(float(np.max(np.abs(g - w) / w))
                                 for g, w in zip(depths[name], base)))
        print(f"[bulk] {name}: {n_kf} keyframes, median {r['median']:.2f} keyframes/s (min "
              f"{r['min']:.2f}, max {r['max']:.2f}, spread {r['spread']:.1%} over {args.reps} "
              f"runs), peak {r['peak_mib']:.1f} MiB ({r['held_mib']:.1f} held at its start), "
              f"forward launches {r['launches']} a run, "
              f"host launches a keyframe {r.get('host_launches_per_keyframe', 'off the card')}, "
              f"max relative depth gap to sequential {r['max_rel_gap']:.3e}", flush=True)
    print(card)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": card, "keyframes": keyframes, "args": vars(args),
                       "modes": report}, f, indent=1)
    return report


if __name__ == "__main__":
    main()
