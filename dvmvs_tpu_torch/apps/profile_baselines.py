"""Where the baselines' time and device memory go on the card, stage by
stage, at their full sizes with seeded weights, and ``predict`` graphed
against eager.

For MVDepthNet (GP-MVS adds its host Kalman step to the same stages), DPSNet
and DELTAS, on the eager path (``graphs=False``): the median CUDA-event time
of each stage over ``--reps`` calls after a warm-up call, the whole
``predict`` (host upload and readback included) beside them, and for each
model the leaf module whose call raises the allocation most above what was
allocated before it (cuDNN's workspace shows there).

Under ``paths``, for each of the four baselines, a graphed (the default,
``baselines/steps.py``) and an eager estimator over the same ``--keyframes``
seeded keyframes (``compare_paths``): each estimator's first pass (the
graphed one captures there) with its peak device memory above the weights
and the device memory it keeps reserved after the pass (``kept_mib``,
measured after ``torch.cuda.empty_cache()``: the graphs' private pools,
which live as long as the estimator); then ``--rounds`` passes of each in
turns, the host wall time of every ``predict`` (median, p90); the depth gap
between the paths; the plane-sweep and DLT-solve launches of a graphed pass;
and from a ``torch.profiler`` trace of one more pass each, the host CUDA API
calls inside one ``predict`` (``cudaGraphLaunch``, kernel launches, copies)
and, for DELTAS, the device time of its ``csrc/dlt_solve.cu`` kernel a
``predict`` (inside the graph on the graphed path).

Prints one JSON object, also written to ``--out``.

Run: ``python -m dvmvs_tpu_torch.apps.profile_baselines [--out FILE]
[--reps N] [--keyframes N] [--rounds N]`` (needs the card; IEEE float32, the port's mode).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Optional, Sequence

import numpy as np
import torch

import dvmvs_tpu_torch.apps.run_testing_baseline  # noqa: F401  (registry population)
from dvmvs_tpu_torch.apps.graphs import LAUNCHES
from dvmvs_tpu_torch.baselines import BASELINE_REGISTRY
from dvmvs_tpu_torch.baselines.deltas import (
    BORDER,
    sample_descriptors,
    simple_nms,
    top_k_keypoints,
)
from dvmvs_tpu_torch.baselines.dpsnet import inverse_warp
from dvmvs_tpu_torch.baselines.mvdepthnet import l1_cost_volume, upload_views
from dvmvs_tpu_torch.utils.precision import ieee_float32
from dvmvs_tpu_torch.utils.profiling import counters

NAMES = ("mvdepthnet", "gpmvs", "dpsnet", "deltas")
PREDICT_RANGE = "baseline.predict"


def median_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` calls after one
    warm-up call, each call timed alone."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def leaf_peaks(model: torch.nn.Module, fn, top: int = 3) -> dict:
    """MiB that each leaf module's call raises the allocation above what was
    allocated before it, the ``top`` largest."""
    peaks, names, alloc, handles = {}, {}, {}, []

    def before(mod, _):
        torch.cuda.synchronize()
        alloc[mod] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()

    def after(mod, _, __):
        torch.cuda.synchronize()
        rise = (torch.cuda.max_memory_allocated() - alloc[mod]) / 2 ** 20
        peaks[names[mod]] = max(peaks.get(names[mod], 0.0), rise)

    for name, mod in model.named_modules():
        if not list(mod.children()):
            names[mod] = name
            handles += [mod.register_forward_pre_hook(before), mod.register_forward_hook(after)]
    try:
        fn()
    finally:
        for h in handles:
            h.remove()
    return dict(sorted(peaks.items(), key=lambda kv: -kv[1])[:top])


def frames(rs, width: int, height: int, n: int = 3):
    return [rs.randn(height, width, 3).astype(np.float32) for _ in range(n)]


@torch.inference_mode()
def profile(reps: int = 10) -> dict:
    rs = np.random.RandomState(0)
    pose, meas_pose = np.eye(4), np.eye(4)
    meas_pose[0, 3] = 0.1
    out = {}

    est = BASELINE_REGISTRY["mvdepthnet"](device="cuda", graphs=False)
    m, (W, H) = est.model, (est.image_width, est.image_height)
    img = frames(rs, W, H)
    K = np.array([[0.8 * W, 0, W / 2], [0, 0.8 * W, H / 2], [0, 0, 1]], np.float32)
    args = upload_views(est.device, img[0], img[1:], pose, [meas_pose] * 2, K, 2)
    cv = l1_cost_volume(*args)
    feats = m.encoder(args[0], cv)
    out["mvdepthnet"] = {
        "cost_volume_ms": median_ms(lambda: l1_cost_volume(*args), reps),
        "encoder_ms": median_ms(lambda: m.encoder(args[0], cv), reps),
        "decoder_ms": median_ms(lambda: m.decoder(*feats), reps),
        "predict_ms": median_ms(lambda: est.predict(img[0], img[1:], pose, [meas_pose] * 2, K),
                                reps),
        "leaf_peak_mib": leaf_peaks(m, lambda: m(*args))}

    est = BASELINE_REGISTRY["dpsnet"](device="cuda", graphs=False)
    m = est.model
    ref = torch.from_numpy(img[0]).to(est.device).permute(2, 0, 1)[None]
    fea = m.feature_extraction(ref)
    L, (C, h, w) = m.nlabel, fea.shape[1:]
    labels = torch.arange(L, dtype=torch.float32, device=est.device)
    depth = (m.mindepth * L / (labels + 1e-16))[:, None, None].expand(L, h, w)
    rel = torch.from_numpy(meas_pose[:3].astype(np.float32)).to(est.device)[None].expand(L, 3, 4)
    K4 = torch.from_numpy(K * np.array([0.25, 0.25, 1.0], np.float32)[:, None]).to(
        est.device)[None].expand(L, 3, 3)
    warped = inverse_warp(fea.expand(L, C, h, w), depth, rel, K4)
    cost = torch.cat([fea.expand(L, C, h, w), warped], dim=1)[None].permute(0, 2, 1, 3, 4)
    slices = torch.cat([fea.expand(L, C, h, w), m.hourglass(cost)[0, 0][:, None]], dim=1)
    out["dpsnet"] = {
        "features_ms (3 a keyframe)": median_ms(lambda: m.feature_extraction(ref), reps),
        "warp_ms (2 a keyframe)": median_ms(
            lambda: inverse_warp(fea.expand(L, C, h, w), depth, rel, K4), reps),
        "hourglass_ms (2 a keyframe)": median_ms(lambda: m.hourglass(cost), reps),
        "context_ms": median_ms(lambda: m.convs(slices), reps),
        "predict_ms": median_ms(lambda: est.predict(img[0], img[1:], pose, [meas_pose] * 2, K),
                                reps)}

    est = BASELINE_REGISTRY["deltas"](device="cuda", graphs=False)
    m, (W, H) = est.model, (est.image_width, est.image_height)
    img = frames(rs, W, H)
    K = np.array([[0.8 * W, 0, W / 2], [0, 0.8 * W, H / 2], [0, 0, 1]], np.float32)
    ref, meas, rel, K_, mask = est.inputs(img[0], img[1:], pose, [meas_pose] * 2, K)
    scores, desc, skips = m.superpoint(ref)
    kp, kp_scores = top_k_keypoints(simple_nms(scores, m.nms_radius), m.n_keypoints, BORDER)
    ref_d = sample_descriptors(kp, desc)
    meas_descs = torch.stack([m.superpoint(meas[:, v])[1] for v in range(meas.shape[1])], dim=1)
    sparse = torch.zeros((1, H, W), device=est.device)
    out["deltas"] = {
        "superpoint_ms (3 a keyframe)": median_ms(lambda: m.superpoint(ref), reps),
        "nms_top_k_ms": median_ms(lambda: top_k_keypoints(
            simple_nms(scores, m.nms_radius), m.n_keypoints, BORDER), reps),
        "triangulation_ms": median_ms(lambda: m.triangulation(
            kp, kp_scores, ref_d, meas_descs, rel, K_, H, W, mask), reps),
        "densify_ms": median_ms(lambda: m.sparse_to_dense(sparse, None, skips), reps),
        "predict_ms": median_ms(lambda: est.predict(img[0], img[1:], pose, [meas_pose] * 2, K),
                                reps),
        "leaf_peak_mib": leaf_peaks(m, lambda: m(ref, meas, rel, K_, mask))}
    return out


def seeded_keyframes(name: str, n: int, seed: int = 0):
    """The ``predict`` arguments of n keyframes (ref frame, two measurement
    frames, their poses 10 cm apart, K) of random normalised frames at the
    baseline's size."""
    cls = BASELINE_REGISTRY[name]
    W, H = cls.image_width, cls.image_height
    rs = np.random.RandomState(seed)
    images = frames(rs, W, H, n + 2)
    poses = [np.eye(4) for _ in range(n + 2)]
    for i, p in enumerate(poses):
        p[0, 3] = 0.1 * i
    K = np.array([[0.8 * W, 0, W / 2], [0, 0.8 * W, H / 2], [0, 0, 1]], np.float32)
    return [(images[i], [images[i - 1], images[i - 2]], poses[i], [poses[i - 1], poses[i - 2]],
             K) for i in range(2, n + 2)]


def depth_gap(got, want) -> float:
    """max |got - want| over max |want| of each keyframe, the largest."""
    return max(float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(got, want))


def compare_paths(name: str, keyframes, rounds: int) -> dict:
    """``predict`` of a graphed and an eager estimator (seed 0) over
    ``keyframes`` (``predict``'s argument tuples; module doc), the
    estimators reset before each pass. The depth gap is taken on
    the depths each path reads back (DELTAS's before its clip: with seeded
    weights the clipped depth is one constant); DELTAS's ``dlt_solve``
    kernel's device time a ``predict`` from the trace (``dlt_solve_ms``)."""
    from dvmvs_tpu_torch.apps.profile_step import (api_calls, kernel_ms_by_prefix,
                                                   launches_per_call, ranged, trace_events)

    ests = {mode: BASELINE_REGISTRY[name](device="cuda", seed=0, graphs=mode == "graphs")
            for mode in ("eager", "graphs")}
    peak, kept, raw, returned = {}, {}, {}, {}

    def run(mode):
        est = ests[mode]
        est.reset()
        raw[mode] = []
        est._readback = lambda depth, real=type(est)._readback: (
            raw[mode].append(real(depth)), raw[mode][-1])[1]
        try:
            returned[mode] = [est.predict(*kf) for kf in keyframes]
        finally:
            del est._readback

    for mode in ests:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        run(mode)  # a new graphed estimator captures here
        torch.cuda.synchronize()
        peak[mode] = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
        torch.cuda.empty_cache()  # what stays reserved is the graphs' pools
        kept[mode] = (torch.cuda.memory_reserved() - reserved) / 2 ** 20
    times = {mode: [] for mode in ests}
    for _ in range(rounds):
        for mode, est in ests.items():
            est.reset()
            for kf in keyframes:
                t0 = time.perf_counter()
                est.predict(*kf)
                times[mode].append((time.perf_counter() - t0) * 1e3)
    before = counters.snapshot()
    run("graphs")
    moved = counters.since(before)
    launches = tuple(moved.get(name, 0) for name in LAUNCHES)
    run("eager")
    report = {
        "keyframes": len(keyframes), "rounds": rounds,
        "depth_gap": depth_gap(raw["graphs"], raw["eager"]),
        "bit_equal": all(np.array_equal(a, b) for a, b in zip(
            raw["graphs"] + returned["graphs"], raw["eager"] + returned["eager"])),
        "plane_sweep_launches_graphed_pass": launches[0],
        "backward_launches_graphed_pass": launches[1],
        "dlt_solve_launches_graphed_pass": launches[2],
        "captured_steps": len(ests["graphs"].step_graphs)}
    for mode, est in ests.items():
        ranged(est, ("predict",), prefix="baseline.")
        try:
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU,
                                torch.profiler.ProfilerActivity.CUDA]) as prof:
                run(mode)
                torch.cuda.synchronize()
        finally:
            del est.predict
        events = trace_events(prof)
        calls = api_calls(events, PREDICT_RANGE)
        t = np.asarray(times[mode])
        report[mode] = {
            "predict_ms": {"median": float(np.median(t)), "p90": float(np.percentile(t, 90)),
                           "n": int(t.size)},
            "first_pass_peak_mib": peak[mode], "kept_mib": kept[mode],
            "host_launches_per_predict": launches_per_call(calls),
            "dlt_solve_ms": kernel_ms_by_prefix(events, {"k": "dlt_solve_kernel"})["k"]
            / len(keyframes),
            "host_api_calls_in_predict": calls}
    return report


def paths(n_keyframes: int, rounds: int) -> dict:
    out = {}
    for name in NAMES:
        out[name] = compare_paths(name, seeded_keyframes(name, n_keyframes), rounds)
        torch.cuda.empty_cache()
    return out


@ieee_float32()
def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--reps", type=int, default=10, help="timed calls a stage")
    ap.add_argument("--keyframes", type=int, default=8, help="keyframes a pass (paths)")
    ap.add_argument("--rounds", type=int, default=5,
                    help="timed passes of each path, in turns (paths)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_baselines: needs a GPU (torch.cuda.is_available() is false)")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    result = {"card": card, **profile(args.reps), "paths": paths(args.keyframes, args.rounds)}
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
