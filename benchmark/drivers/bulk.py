"""Bulk cell: the port's batched offline evaluation,
``apps/run_testing.py::evaluate_scene_batched`` (pairnet, B keyframes a
step from a device feature bank, ``scan_chunk`` steps one graph replay),
called scene after scene until the window closes.

Each scene is a walk of the mix with its index file, written under TMPDIR
by the reference's copy of the keyframe heuristic; its frames come from an
in-memory assets object of the benchmark's own (``image``, ``pose``,
``updated_K``, ``depth_filenames=None``), so no image file is decoded. Set-up
evaluates every scene once, the one with the most unique frames first, so
the bank is allocated once and every chunk length is captured.

Checked against the reference (``reference/loops.py::pair_keyframe``):
for one call of each scene drawn from the seed, a seeded sample of its
keyframes' depths; and a seeded sample of the rows of the bank that the
last call left, each against the reference's features of its frame.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np
import torch

from benchmark.harness import cells, checks, flops, trace, traffic, weights
from benchmark.harness.core import Run, seeds
from benchmark.harness.roofline import stack_calls
from benchmark.reference import loops


class Assets:
    """A walk's frames and poses by file name, from memory."""

    def __init__(self, pool, ids, poses, K):
        self.pool, self.ids, self.poses = pool, ids, poses
        self.updated_K = K
        self.depth_filenames = None

    @staticmethod
    def name(i: int) -> str:
        return f"{i:06d}.png"

    def index(self, name: str) -> int:
        return int(name[:6])

    def image(self, name: str) -> np.ndarray:
        return self.pool[self.ids[self.index(name)]]

    def pose(self, name: str) -> np.ndarray:
        return self.poses[self.index(name)]


def index_lines(poses, test: dict):
    """The walk's index file lines (reference heuristic) and its entries."""
    lines, entries = [], []
    for line in loops.keyframe_lines(poses, test):
        if line is None:
            lines.append("TRACKING LOST")
            continue
        names = [Assets.name(line[0])] + [Assets.name(m) for m in line[1]]
        lines.append(" ".join(names))
        entries.append(names)
    return lines, entries


def run(ctx) -> Run:
    from dvmvs_tpu_torch.apps.engine import InferenceEngine
    from dvmvs_tpu_torch.apps.run_testing import evaluate_scene_batched

    work = ctx.workload
    kind, sizes, test = ctx.config["model"], ctx.config["sizes"], ctx.config["test"]
    traffic_seed, weight_seed, sample_seed = seeds(ctx.seed, 3)
    data = traffic.make(ctx.traffic, ctx.config, traffic_seed)
    n_walks = len(data["poses"])
    folder = tempfile.mkdtemp(prefix="bench-index-")
    scenes = []
    for w in range(n_walks):
        lines, entries = index_lines(data["poses"][w], test)
        path = os.path.join(folder, f"keyframe+bench+walk{w}+nmeas+{test['n_measurement_frames']}")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        unique = list(dict.fromkeys(n for e in entries for n in e))
        scenes.append({"index": path, "entries": entries, "unique": unique,
                       "assets": Assets(data["pool"], data["frame_ids"][w], data["poses"][w],
                                        data["K"])})
    ctx.mark("traffic and index files")
    cfg = cells.test_config(ctx.config)
    engine = InferenceEngine(kind, cfg, device=ctx.device, graphs=True)
    ctx.mark("engine")
    engine.model.load_state_dict(weights.state_dict(kind, sizes, weight_seed, ctx.device))
    ctx.mark("weights")
    unit = flops.inference(kind, sizes, test)
    ctx.mark("flops")

    seen = {"slots": 0, "bank": None, "xs": None}
    real_steps, real_bank = engine.predict_pair_steps, engine.bank_storage

    def predict_pair_steps(bank, images, K, xs):
        depth = real_steps(bank, images, K, xs)
        seen["slots"] += depth.shape[0] * depth.shape[1]
        if seen["xs"] is not None:
            seen["xs"].append((K, {k: xs[k] for k in ("ref_pose", "meas_pose", "view_mask")}))
        return depth

    def bank_storage(*args):
        seen["bank"] = real_bank(*args)
        return seen["bank"]

    engine.predict_pair_steps, engine.bank_storage = predict_pair_steps, bank_storage

    def call(s: int):
        scene = scenes[s]
        with trace.span("bulk.scene"):
            depths, _ = evaluate_scene_batched(
                engine, "", scene["index"], cfg, work["batch_size"], evaluate=False,
                assets=scene["assets"], scan_chunk=work["scan_chunk"],
                bank_dtype=work["bank_dtype"])
        return depths

    for s in sorted(range(n_walks), key=lambda s: -len(scenes[s]["unique"])):
        call(s)
    cells.sync(ctx.device)
    ctx.mark("warm-up and graph captures")

    rs = np.random.RandomState(sample_seed)
    sampled = {}
    for w in range(n_walks):
        k = w + n_walks * int(rs.randint(0, work["sample_rounds"]))
        n = len(scenes[w]["entries"])
        sampled[k] = (w, sorted(rs.choice(n, min(n, work["keyframes_per_scene"]),
                                          replace=False).tolist()))
    bank_rows = rs.randint(0, 1 << 30, work["bank_rows"])
    kept, last = {}, None

    out = Run(ctx.cell, ctx.device)
    start = time.perf_counter()
    out.values["setup_s"] = start - ctx.t0
    deadline = start + ctx.seconds
    slots0, calls_s, keyframes, conv_flops, k = seen["slots"], 0.0, 0, 0, 0
    call_s = []
    while time.perf_counter() < deadline:
        w = k % n_walks
        t0 = time.perf_counter()
        depths = call(w)
        call_s.append(time.perf_counter() - t0)
        calls_s += call_s[-1]
        keyframes += len(depths)
        conv_flops += len(scenes[w]["unique"]) * unit["encode"] + len(depths) * unit["predict"]
        if k in sampled and w not in kept:
            kept[w] = {i: depths[i] for i in sampled[k][1]}
        last, k = w, k + 1
    cells.sync(ctx.device)
    out.values.update(window_s=time.perf_counter() - start, calls_s=calls_s,
                      keyframes=keyframes, attempted=keyframes, conv_flops=conv_flops,
                      slots=seen["slots"] - slots0)
    # a window that warms up shows in its first calls
    out.values.update(first_calls_s=sum(call_s[:n_walks]),
                      last_calls_s=sum(call_s[-n_walks:]) if len(call_s) >= 2 * n_walks else 0.0)

    if ctx.trace:
        holder = {}
        seen["xs"] = []
        trace.spanned(engine, ("predict_pair_steps", "encode_batch"))
        with trace.traced(holder, ctx.device):
            tail = time.perf_counter() + work["trace_seconds"]
            while time.perf_counter() < tail:
                last = k % n_walks
                call(last)
                k += 1
        out.trace = holder["trace"]
        geometry = []
        for K, xs in seen["xs"]:
            T, B, V = xs["view_mask"].shape
            for t in range(T):
                mats, w8 = cells.sweep_call(xs["ref_pose"][t].cpu(), xs["meas_pose"][t].cpu(),
                                            xs["view_mask"][t].cpu(), cells.half_K(K.cpu()),
                                            sizes, ctx.device)
                geometry.append((mats, w8, test["image_height"] // 2, test["image_width"] // 2,
                                 sizes["fpn_channels"]))
        out.sweeps["forward"] = stack_calls(geometry)
    out.values["memory_peak_bytes"] = cells.memory_peak(ctx.device)

    bank_feats = seen["bank"][0]
    unique = scenes[last]["unique"] if last is not None else []
    rows = sorted({int(r) % len(unique) for r in bank_rows}) if unique else []
    bank = {r: [f[r].detach().clone() for f in bank_feats] for r in rows}
    del engine, seen, bank_feats
    cells.free(ctx.device)
    shutil.rmtree(folder, ignore_errors=True)
    compare(ctx, out, scenes, sampled, kept, last, bank, data, weight_seed)
    return out


def compare(ctx, out, scenes, sampled, kept, last, bank, data, weight_seed):
    kind, sizes, test = ctx.config["model"], ctx.config["sizes"], ctx.config["test"]
    limits = ctx.workload["limits"]
    V = test["n_measurement_frames"]
    model = weights.reference_model(kind, sizes, weight_seed, ctx.device).eval()
    depth, rows = [], []
    with loops.ieee():
        for w, got in sorted(kept.items()):
            assets = scenes[w]["assets"]
            frame = lambda name: torch.from_numpy(assets.image(name)).to(ctx.device)
            poses = {n: assets.pose(n) for e in scenes[w]["entries"] for n in e}
            for i, program_depth in got.items():
                ref, *meas = scenes[w]["entries"][i]
                d, _ = loops.pair_keyframe(model, frame, ref, meas[:V], poses, data["K"], V)
                depth.append(checks.rel_gap(program_depth, d))
        if last is not None:
            assets = scenes[last]["assets"]
            with torch.no_grad():
                for r, program in bank.items():
                    image = torch.from_numpy(assets.image(scenes[last]["unique"][r])).to(ctx.device)
                    ref = model.extract_features(image.permute(2, 0, 1)[None])
                    rows += [checks.rel_gap(p, f[0]) for p, f in zip(program, ref)]
    out.check("depth_gap", checks.worst(depth), limits["depth_gap"])
    out.check("bank_gap", checks.worst(rows), limits["bank_gap"])
