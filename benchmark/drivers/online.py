"""Online cell: a closed loop of camera walks through the port's online
driver, ``apps/run_testing_online.py::predict_stream`` over a graphed
``InferenceEngine``, one scene after another until the window closes.

Each walk is a scene: the driver resets the engine and streams the walk's
frames through the keyframe buffer; each accepted keyframe is one
``encode_and_predict``, timed through ``predict_stream``'s ``timer`` hook
(host wall time from the call until its depth is on the host). The loop
cycles through the mix's walks. Set-up streams the first frames of a walk
once, so both graphs are captured before the window.

Checked against the reference (``reference/loops.py::online_walk``, the
whole walk from its start, in IEEE float32 on the same device): for one
scene of each walk drawn from the seed (its first scene where the window
ends before the drawn one), the keyframe indices (exactly),
every keyframe's depth, a seeded sample of the kept half-resolution
features, and the recurrent state (h, c, previous depth) at the scene's
end.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import cells, checks, flops, trace, traffic, weights
from benchmark.harness.core import Run, seeds
from benchmark.harness.roofline import stack_calls
from benchmark.reference import loops


def run(ctx) -> Run:
    from dvmvs_tpu_torch.apps.engine import InferenceEngine
    from dvmvs_tpu_torch.apps.run_testing_online import predict_stream
    from dvmvs_tpu_torch.utils.results import InferenceTimer

    work = ctx.workload
    kind, sizes, test = ctx.config["model"], ctx.config["sizes"], ctx.config["test"]
    traffic_seed, weight_seed, sample_seed = seeds(ctx.seed, 3)
    data = traffic.make(ctx.traffic, ctx.config, traffic_seed)
    poses, ids, pool, K = data["poses"], data["frame_ids"], data["pool"], data["K"]
    n_walks = len(poses)
    ctx.mark("traffic")
    cfg = cells.test_config(ctx.config)
    engine = InferenceEngine(kind, cfg, device=ctx.device, graphs=True)
    ctx.mark("engine")
    engine.model.load_state_dict(weights.state_dict(kind, sizes, weight_seed, ctx.device))
    ctx.mark("weights")
    unit = flops.inference(kind, sizes, test)
    ctx.mark("flops")
    warm = work["warmup_frames"]
    predict_stream(engine, [pool[i] for i in ids[0][:warm]], poses[0][:warm], K, cfg)
    cells.sync(ctx.device)
    ctx.mark("warm-up and graph captures")

    rs = np.random.RandomState(sample_seed)
    # each walk's first scene is kept, and replaced by its scene drawn from
    # the seed where the window reaches that
    drawn = {w + n_walks * int(rs.randint(0, work["sample_rounds"])) for w in range(n_walks)}
    sampled = drawn | set(range(n_walks))
    kept_ordinals = {w: set(rs.choice(work["features_among"], work["features_per_scene"],
                                      replace=False).tolist()) for w in range(n_walks)}
    record = {"instances": [], "scenes": {}}

    def scene(k: int, deadline: float, timer, calls=None):
        """Stream walk k % n_walks until it ends or the deadline passes."""
        w = k % n_walks
        streamed = [0]

        def frames():
            for fid in ids[w]:
                if time.perf_counter() >= deadline:
                    return
                streamed[0] += 1
                yield pool[fid]

        kept, real, own = [], None, engine.__dict__.get("encode_and_predict")
        if k in sampled or calls is not None:
            real = engine.encode_and_predict

            def recorded(image, meas_half, ref_pose, meas_poses, K_, _real=real):
                if calls is not None:
                    calls.append((ref_pose, list(meas_poses), K_))
                depth, half = _real(image, meas_half, ref_pose, meas_poses, K_)
                kept.append(half if k in sampled and len(kept) in kept_ordinals[w] else None)
                return depth, half

            engine.encode_and_predict = recorded
        try:
            with trace.span("online.scene"):
                depths, indices = predict_stream(engine, frames(), poses[w], K, cfg, timer=timer)
        finally:
            if real is not None:
                engine.__dict__.pop("encode_and_predict")
                if own is not None:
                    engine.encode_and_predict = own
        record["instances"].append((w, streamed[0], len(depths)))
        if k in drawn or (k in sampled and w not in record["scenes"]):
            record["scenes"][w] = {
                "n_frames": streamed[0], "indices": indices, "depths": depths,
                "features": {j: f for j, f in enumerate(kept) if f is not None},
                "state": [t.clone() for t in (engine.carry.h[0], engine.carry.c[0],
                                              engine.prev_depth[0])]}

    out = Run(ctx.cell, ctx.device)
    timer = InferenceTimer(n_skip=0)
    start = time.perf_counter()
    out.values["setup_s"] = start - ctx.t0
    deadline = start + ctx.seconds
    k = 0
    while time.perf_counter() < deadline:
        scene(k, deadline, timer)
        k += 1
    cells.sync(ctx.device)
    out.values["window_s"] = time.perf_counter() - start
    frames_streamed = sum(n for _, n, _ in record["instances"])
    keyframes = sum(n for _, _, n in record["instances"])
    encodes = sum(1 for _, n, _ in record["instances"] if n)
    out.values.update(frames=frames_streamed, keyframes=keyframes, attempted=keyframes,
                      conv_flops=keyframes * (unit["encode"] + unit["predict"])
                      + encodes * unit["encode"])
    out.samples["kf_ms"] = list(timer.times)
    out.values["kf_ms_median"] = float(np.median(timer.times)) if timer.times else 0.0

    if ctx.trace:
        holder, calls = {}, []
        trace.spanned(engine, ("encode_and_predict", "encode", "reset"))
        with trace.traced(holder, ctx.device):
            tail = time.perf_counter() + work["trace_seconds"]
            while time.perf_counter() < tail:
                scene(k, tail, None, calls)
                k += 1
        trace.unspanned(engine, ("encode_and_predict", "encode", "reset"))
        out.trace = holder["trace"]
        V = test["n_measurement_frames"]
        geometry = []
        for ref_pose, meas, K_ in calls:
            mask = np.zeros((1, V), np.float32)
            mask[0, :len(meas)] = 1
            meas = meas + [meas[0]] * (V - len(meas))
            mats, w8 = cells.sweep_call(np.asarray(ref_pose)[None], np.stack(meas)[None], mask,
                                        cells.half_K(K_)[None], sizes, ctx.device)
            geometry.append((mats, w8, test["image_height"] // 2, test["image_width"] // 2,
                             sizes["fpn_channels"]))
        out.sweeps["forward"] = stack_calls(geometry)
    out.values["memory_peak_bytes"] = cells.memory_peak(ctx.device)
    del engine
    cells.free(ctx.device)

    compare(ctx, out, record, data, weight_seed)
    return out


def compare(ctx, out: Run, record: dict, data: dict, weight_seed: int):
    kind, sizes, test = ctx.config["model"], ctx.config["sizes"], ctx.config["test"]
    limits = ctx.workload["limits"]
    model = weights.reference_model(kind, sizes, weight_seed, ctx.device).eval()
    mismatches, depth, feature, state = 0, [], [], []
    with loops.ieee():
        for w, got in sorted(record["scenes"].items()):
            ids, pool = data["frame_ids"][w], data["pool"]

            def frame(i):
                return torch.from_numpy(pool[ids[i]]).to(ctx.device)

            ref, ref_state = loops.online_walk(model, frame, data["poses"][w][:got["n_frames"]],
                                               data["K"], test)
            ref_indices = [i for i, _, _ in ref]
            mismatches += abs(len(ref_indices) - len(got["indices"])) + sum(
                a != b for a, b in zip(ref_indices, got["indices"]))
            for (_, d, f), program_depth, j in zip(ref, got["depths"], range(len(ref))):
                depth.append(checks.rel_gap(program_depth, d))
                if j in got["features"]:
                    feature.append(checks.rel_gap(got["features"][j][0], f))
            if got["indices"] and ref_state is not None:
                state += [checks.rel_gap(p, r) for p, r in zip(got["state"], ref_state)]
    out.check("keyframe_mismatches", mismatches, limits["keyframe_mismatches"])
    out.check("depth_gap", checks.worst(depth), limits["depth_gap"])
    out.check("feature_gap", checks.worst(feature), limits["feature_gap"])
    if "state_gap" in limits:
        out.check("state_gap", checks.worst(state), limits["state_gap"])
