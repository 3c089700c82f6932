"""Cells at a size the CPU runs in seconds: every width as published, the
frames small (96x64 online and bulk, 64x64 training), 8 depth planes,
short walks. ``context`` builds a driver's context for one of them."""

from __future__ import annotations

import copy
import time

from benchmark.harness import core

SIZES = {"backbone": "mnasnet1_0", "fpn_channels": 32, "hyper_channels": 32,
         "lstm_hidden_channels": 512, "n_depth_levels": 8, "min_depth": 0.25, "max_depth": 20.0}
TEST = {"image_width": 96, "image_height": 64, "n_measurement_frames": 2,
        "keyframe_buffer_size": 30, "keyframe_pose_distance": 0.1, "optimal_t_measure": 0.15,
        "optimal_R_measure": 0.0}
TRAIN = {"image_size": 64, "batch_size": 2, "subsequence_length": 3, "learning_rate": 1e-4,
         "adam_betas": [0.9, 0.999], "adam_eps": 1e-8, "loss_type": "L1-inv"}
TRAFFIC = {
    "fusionnet.online": {"kind": "walks", "frames": 30, "step_m": 0.05, "pool": 4,
                         "walks": [{"keyframes": 10, "rooms": [8, 12, 31, 55]},
                                   {"keyframes": 12, "rooms": [1, 2, 11, 25]}]},
    "pairnet.bulk": {"kind": "walks", "frames": 40, "step_m": 0.05, "pool": 4,
                     "walks": [{"keyframes": 13, "rooms": [6, 32, 45, 49]},
                               {"keyframes": 15, "rooms": [4, 7, 9, 14]}]},
    "fusionnet.train": {"kind": "subsequences", "batches": 3, "walk_frames": 60, "step_m": 0.05,
                        "pose_distance": [0.125, 0.325], "min_translation_m": 0.05},
}
OVERRIDES = {
    "fusionnet.online": {"warmup_frames": 10, "features_among": 3, "features_per_scene": 2,
                         "trace_seconds": 0.5},
    "pairnet.bulk": {"keyframes_per_scene": 6, "bank_rows": 3, "trace_seconds": 0.5},
    "fusionnet.train": {"trace_steps": 1},
}


def config(cell: str) -> dict:
    kind = "pairnet" if cell.startswith("pairnet") else "fusionnet"
    sizes = dict(SIZES)
    if kind == "pairnet":
        del sizes["lstm_hidden_channels"]
    return {"model": kind, "sizes": sizes, "test": dict(TEST), "train": dict(TRAIN)}


def context(cell: str, seed: int = 7, seconds: float = 2.0, trace: bool = False) -> core.Context:
    workload = copy.deepcopy(core.load_json("workloads", cell))
    workload.update(OVERRIDES[cell])
    return core.Context(cell=cell, workload=workload, config=config(cell),
                        traffic=dict(TRAFFIC[cell]), seed=seed, seconds=seconds, trace=trace,
                        device="cpu", t0=time.perf_counter())


def run(cell: str, **kwargs) -> core.Run:
    ctx = context(cell, **kwargs)
    return core.run_cell(ctx)
