"""Baseline cell: DELTAS, the port's registry estimator, through the
baselines' evaluation loop, ``apps/run_testing_baseline.py::
evaluate_scene_baseline``, one walk a call, walk after walk until the window
closes: a closed loop of one graphed ``predict`` a keyframe.

The estimator is ``BASELINE_REGISTRY[model](n_measurement_frames=V,
graphs=True)`` with the benchmark's seeded weights (``harness/deltas.py``).
Each walk is a scene with its index file, written under TMPDIR by the
reference's copy of the keyframe heuristic (``drivers/bulk.py``); its frames
come from memory through the loop's ``assets`` hook: the mix's pool of noise
frames, put in the estimator's normalisation once, so no file is decoded.
Set-up evaluates every walk once, so the capture and cuDNN's algorithm
search end before the window.

Checked against the plain reference (``reference/deltas.py``, on the same
device in IEEE float32) on a seeded sample of keyframes of one call of
each walk: the walk's first call in the window, replaced by the call drawn
from the seed where the window reaches it. After a sampled keyframe's
``predict`` its raw depth, keypoints and points are copied on the device
from the estimator's ``outputs`` (no host sync, no second forward).

  - ``keypoint_mismatch_share``: the share of the program's keypoints that
    are not among the reference's top-k (the worst keyframe);
  - ``point_gap``: the triangulated points of the keypoints both share,
    where the reference's point enters the sparse depth (range-valid, its
    depth strictly inside the configuration's range): the largest
    absolute gap over the largest coordinate of those points;
  - ``depth_gap``: the raw depth before the estimator's clip, against the
    reference run on the program's keypoints (so that a near-tie flipped
    at the k-th score cannot fail it), over the reference's largest
    ``|depth|``.
"""

from __future__ import annotations

import inspect
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from benchmark.drivers.bulk import index_lines
from benchmark.harness import cells, checks, deltas, trace, traffic
from benchmark.harness.core import Run, seeds
from benchmark.reference import loops

OUTPUTS = ("depth", "keypoints", "points3d")


class Assets:
    """A walk's frames (in the estimator's normalisation) and poses by file
    name, from memory, as ``evaluate_scene_baseline`` reads them."""

    depth_filenames = None

    def __init__(self, pool, ids, poses, K):
        self.pool, self.ids, self.poses, self.updated_K = pool, ids, poses, K

    def image(self, name: str) -> np.ndarray:
        return self.pool[self.ids[int(name[:6])]]

    def pose(self, name: str) -> np.ndarray:
        return self.poses[int(name[:6])]


def renormalised(pool: np.ndarray, estimator) -> np.ndarray:
    """The mix's frames (ImageNet-normalised, ``traffic.normalise``) in the
    estimator's own normalisation, (rgb / scale_rgb - mean_rgb) / std_rgb."""
    rgb = 255.0 * (pool.astype(np.float64) * traffic.STD_RGB + traffic.MEAN_RGB)
    out = (rgb / estimator.scale_rgb - np.asarray(estimator.mean_rgb)) / np.asarray(
        estimator.std_rgb)
    return out.astype(np.float32)


def estimator_class(kind: str, test: dict):
    """The registry's estimator, at the configuration's frame size where
    that is not its own (the CPU tests' tiny cell)."""
    # the baselines' loop imports every estimator, which registers it
    from dvmvs_tpu_torch.apps.run_testing_baseline import BASELINE_REGISTRY

    cls = BASELINE_REGISTRY[kind]
    H, W = test["image_height"], test["image_width"]
    if (cls.image_height, cls.image_width) != (H, W):
        cls = type(cls.__name__, (cls,), {"image_height": H, "image_width": W})
    return cls


def run(ctx) -> Run:
    from dvmvs_tpu_torch.apps import run_testing_baseline as rtb
    from dvmvs_tpu_torch.utils.results import InferenceTimer

    if "assets" not in inspect.signature(rtb.evaluate_scene_baseline).parameters:
        raise RuntimeError("evaluate_scene_baseline takes no assets: this program cannot run "
                           "the cell from frames in memory")
    work = ctx.workload
    kind, sizes, test = ctx.config["model"], ctx.config["sizes"], ctx.config["test"]
    V = test["n_measurement_frames"]
    traffic_seed, weight_seed, sample_seed = seeds(ctx.seed, 3)
    data = traffic.make(ctx.traffic, ctx.config, traffic_seed)
    n_walks = len(data["poses"])
    cls = estimator_class(kind, test)
    pool = renormalised(data["pool"], cls)
    folder = tempfile.mkdtemp(prefix="bench-index-")
    scenes = []
    for w in range(n_walks):
        lines, entries = index_lines(data["poses"][w], test)
        path = os.path.join(folder, f"keyframe+bench+walk{w}+nmeas+{V}")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        scenes.append({"index": path, "entries": entries,
                       "assets": Assets(pool, data["frame_ids"][w], data["poses"][w],
                                        data["K"])})
    ctx.mark("traffic and index files")
    est = cls(n_measurement_frames=V, device=ctx.device, graphs=True)
    ctx.mark("estimator")
    est.model.load_state_dict(deltas.state_dict(sizes, weight_seed, ctx.device), strict=True)
    ctx.mark("weights")
    unit = deltas.predict_flops(sizes, test)
    ctx.mark("flops")

    seen = {"ordinal": 0, "keep": (), "kept": {}, "shapes": None}
    real_predict = est.predict

    def predict(*args):
        depth = real_predict(*args)
        if seen["ordinal"] in seen["keep"]:
            with torch.no_grad():
                seen["kept"][seen["ordinal"]] = {k: est.outputs[k].clone() for k in OUTPUTS}
        if seen["shapes"] is not None:
            seen["shapes"].append((1, est.outputs["keypoints"].shape[1], 2 * (V + 1), 4))
        seen["ordinal"] += 1
        return depth

    est.predict = predict

    def call(w: int, keep=(), timer=None):
        """One walk through the loop; ``keep``: ordinals of the keyframes
        whose outputs are copied. Returns (depths, kept outputs)."""
        seen.update(ordinal=0, keep=keep, kept={})
        depths, _ = rtb.evaluate_scene_baseline(est, "", scenes[w]["index"], evaluate=False,
                                                timer=timer, assets=scenes[w]["assets"])
        return depths, seen["kept"]

    for w in range(n_walks):
        call(w)
    cells.sync(ctx.device)
    ctx.mark("warm-up and graph capture")

    rs = np.random.RandomState(sample_seed)
    drawn = {w + n_walks * int(rs.randint(0, work["sample_rounds"])) for w in range(n_walks)}
    sample = {w: set(rs.choice(len(scenes[w]["entries"]),
                               min(len(scenes[w]["entries"]), work["keyframes_per_scene"]),
                               replace=False).tolist()) for w in range(n_walks)}
    kept = {}

    out = Run(ctx.cell, ctx.device)
    timer = InferenceTimer(n_skip=0)
    start = time.perf_counter()
    out.values["setup_s"] = start - ctx.t0
    deadline = start + ctx.seconds
    calls_s, keyframes, k = 0.0, 0, 0
    while time.perf_counter() < deadline:
        w = k % n_walks
        keep = sample[w] if k in drawn or w not in kept else ()
        t0 = time.perf_counter()
        depths, got = call(w, keep, timer)
        calls_s += time.perf_counter() - t0
        keyframes += len(depths)
        if keep:
            kept[w] = got
        k += 1
    cells.sync(ctx.device)
    out.values.update(window_s=time.perf_counter() - start, calls_s=calls_s,
                      keyframes=keyframes, attempted=keyframes, conv_flops=keyframes * unit,
                      kf_ms_median=float(np.median(timer.times)) if timer.times else 0.0)
    out.samples["kf_ms"] = list(timer.times)

    if ctx.trace:
        holder = {}
        seen["shapes"] = []
        with trace.traced(holder, ctx.device):
            tail = time.perf_counter() + work["trace_seconds"]
            while time.perf_counter() < tail:
                call(k % n_walks)
                k += 1
        out.trace = holder["trace"]
        out.sweeps["dlt_solve"] = seen["shapes"]
    out.values["memory_peak_bytes"] = cells.memory_peak(ctx.device)
    del est, seen
    cells.free(ctx.device)
    shutil.rmtree(folder, ignore_errors=True)
    compare(ctx, out, scenes, kept, data["K"], weight_seed)
    return out


def reference_inputs(assets, entry, K, V: int, device):
    """One keyframe's reference arguments (ref, meas, rel, K, mask), views
    padded with view 0 as the estimators pad them."""
    ref, *meas = entry
    meas = meas[:V]
    names = meas + [meas[0]] * (V - len(meas))
    mask = np.zeros((1, V), np.float32)
    mask[0, :len(meas)] = 1.0
    rel = np.stack([np.linalg.inv(assets.pose(n)) @ assets.pose(ref) for n in names])

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return (t(assets.image(ref)).permute(2, 0, 1)[None],
            t(np.stack([assets.image(n) for n in names])).permute(0, 3, 1, 2)[None],
            t(rel)[None], t(K)[None], t(mask))


def compare(ctx, out: Run, scenes, kept, K, weight_seed: int):
    sizes, test = ctx.config["sizes"], ctx.config["test"]
    limits = ctx.workload["limits"]
    model = deltas.reference_model(sizes, weight_seed, ctx.device)
    lo, hi = sizes["min_depth"], sizes["max_depth"]
    mismatch, points, depth = [], [], []
    with loops.ieee():
        for w, got in sorted(kept.items()):
            for i, program in sorted(got.items()):
                args = reference_inputs(scenes[w]["assets"], scenes[w]["entries"][i], K,
                                        test["n_measurement_frames"], ctx.device)
                own = model.stages(*args)
                held = model.stages(*args, keypoints=program["keypoints"])
                ours = {tuple(p) for p in own["keypoints"][0].long().tolist()}
                shared = torch.tensor([tuple(p) in ours
                                       for p in program["keypoints"][0].long().tolist()],
                                      device=ctx.device)
                mismatch.append(1.0 - float(shared.float().mean()))
                z = held["points3d"][0, :, 2]
                used = shared & held["range_mask"][0] & (z > lo) & (z < hi)
                if bool(used.any()):
                    points.append(checks.rel_gap(program["points3d"][0][used],
                                                 held["points3d"][0][used]))
                depth.append(checks.rel_gap(program["depth"], held["depth"]))
    out.check("keypoint_mismatch_share", checks.worst(mismatch),
              limits["keypoint_mismatch_share"])
    out.check("point_gap", checks.worst(points), limits["point_gap"])
    out.check("depth_gap", checks.worst(depth), limits["depth_gap"])
