#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dvmvs_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It builds the
hand-written plane-sweep kernel from ``dvmvs_tpu_torch/csrc``, holds it
against its plain PyTorch version at the online path's shape, times both,
then streams a synthetic 320x256 scene through the online fusionnet loop
(``predict_stream`` -> keyframe buffer -> ``InferenceEngine``) with seeded
random weights and checks the depths, the recurrent state, the kernel's
launch count on that run, and agreement with the same engine on the CPU for
the first keyframes. Each phase prints one line; any failure raises, so the
exit code is non-zero. It imports neither jax nor OpenCV.

Output: phase lines, then the card's ``name, power.limit``, one JSON line
with the kernel's measurements, and as the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np

B, V, C, H, W, P = 1, 2, 32, 128, 160, 64  # cost volume at 320x256 frames
# absolute: the JAX kernel tests' 5e-4 for the dot cost, which averages over
# channels; the L1 cost sums over them, and its measured 7.7e-4 gap (coordinate
# fold against normalised grids, C=32) gets about 2.5x room
TOL = {True: 5e-4, False: 2e-3}
N_FRAMES, N_MIN_KEYFRAMES, N_REF_KEYFRAMES = 40, 8, 3
# card vs CPU depth, relative: the measured gap is 2.5e-7, and random weights
# keep the depths in a narrow band, so the limit must be tight to catch a fault
REF_RTOL = 1e-5


def _pose(rx, ry, rz, t):
    """Camera-to-world pose from xyz Euler angles in degrees."""
    ax, ay, az = np.radians([rx, ry, rz])
    Rx = np.array([[1, 0, 0], [0, np.cos(ax), -np.sin(ax)], [0, np.sin(ax), np.cos(ax)]])
    Ry = np.array([[np.cos(ay), 0, np.sin(ay)], [0, 1, 0], [-np.sin(ay), 0, np.cos(ay)]])
    Rz = np.array([[np.cos(az), -np.sin(az), 0], [np.sin(az), np.cos(az), 0], [0, 0, 1]])
    pose = np.eye(4)
    pose[:3, :3] = Rz @ Ry @ Rx  # extrinsic xyz, as scipy's from_euler("xyz")
    pose[:3, 3] = t
    return pose.astype(np.float32)


# name -> (euler of view 0, translation of view 0, C, view weights, dot product)
CASES = {
    "lateral": ((0, 0, 0), (0.12, 0.0, 0.0), C, (0.5, 0.5), True),
    "typical": ((2, 3, 1), (0.12, 0.03, 0.02), C, (0.5, 0.5), True),
    "roll_forward": ((0, 0, 4), (0.05, 0.0, 0.1), C, (0.5, 0.5), True),
    "extreme_roll_35": ((0, 0, 35), (0.1, 0.0, 0.0), C, (0.5, 0.5), True),
    "behind_camera_yaw_120": ((0, 120, 0), (0.1, 0.0, 2.0), C, (0.5, 0.5), True),
    "masked_view": ((2, 3, 1), (0.12, 0.03, 0.02), C, (1.0, 0.0), True),
    "c30": ((2, 3, 1), (0.12, 0.03, 0.02), 30, (0.5, 0.5), True),
    "l1": ((2, 3, 1), (0.12, 0.03, 0.02), C, (0.5, 0.5), False),
}


def sweep_inputs(torch, ps, seed, euler, t, c, weights, device):
    rs = np.random.RandomState(seed)
    ref = torch.from_numpy(rs.randn(B, H, W, c).astype(np.float32)).to(device)
    meas = torch.from_numpy(rs.randn(B, V, H, W, c).astype(np.float32)).to(device)
    K = torch.tensor([[152.0, 0, W / 2], [0, 152.0, H / 2], [0, 0, 1]], device=device)
    poses = torch.from_numpy(np.stack([_pose(*euler, t), _pose(1, 2, 0.5, (0.1, 0.02, 0.0))]))
    from dvmvs_tpu_torch.ops.cost_volume import inverse_depth_planes
    mats = ps.build_plane_matrices(torch.eye(4, device=device), poses.to(device), K,
                                   inverse_depth_planes(0.25, 20.0, P, device))
    w = torch.tensor([weights], dtype=torch.float32, device=device)
    return ref, meas, mats[None].contiguous(), w


def time_ms(torch, fn, n_warmup=5, n=30):
    """Median over ``n`` single launches timed with CUDA events."""
    for _ in range(n_warmup):
        fn()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main():
    import torch

    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a GPU")
    from dvmvs_tpu.config import TestConfig
    from dvmvs_tpu_torch.apps.engine import InferenceEngine
    from dvmvs_tpu_torch.apps.profile_step import synthetic_stream
    from dvmvs_tpu_torch.apps.run_testing_online import predict_stream
    from dvmvs_tpu_torch.ops import plane_sweep as ps
    from dvmvs_tpu_torch.utils.results import InferenceTimer

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda} | cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32} matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    log = ps.build_kernel()
    regs = sorted({line.split("Used ")[1].split(",")[0] for line in log.splitlines()
                   if "Used " in line})
    print(f"[build] plane_sweep.cu built and loaded in {time.perf_counter() - t0:.2f} s "
          f"(ptxas: {', '.join(regs) or 'cached'})", flush=True)

    # 3. kernel vs plain version at the path's shape
    max_err = 0.0
    for name, (euler, t, c, weights, dot) in CASES.items():
        ref, meas, mats, w = sweep_inputs(torch, ps, 0, euler, t, c, weights, device)
        want = ps.plane_sweep_multiview_plain(ref, meas, mats, w, dot)
        torch.cuda.synchronize()
        got = ps.plane_sweep_multiview(ref, meas, mats, w, dot)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        print(f"[compare] {name}: max_abs_diff={err:.3e} (tol {TOL[dot]:g}), "
              f"max |cost| {want.abs().max().item():.3f}", flush=True)
        if not (np.isfinite(err) and err <= TOL[dot]):
            raise AssertionError(f"kernel disagrees with the plain version on {name}: {err}")
        max_err = max(max_err, err)

    # 4. time at the path's shape (typical geometry, dot product)
    ref, meas, mats, w = sweep_inputs(torch, ps, 1, *CASES["typical"][:2], C, (0.5, 0.5), device)
    kernel_ms = time_ms(torch, lambda: ps.plane_sweep_multiview(ref, meas, mats, w))
    plain_ms = time_ms(torch, lambda: ps.plane_sweep_multiview_plain(ref, meas, mats, w))
    kernel_ms_2 = time_ms(torch, lambda: ps.plane_sweep_multiview(ref, meas, mats, w))
    print(f"[time] plane sweep (1,2,{C},{H},{W}) P={P}: kernel {kernel_ms:.4f} ms "
          f"(again {kernel_ms_2:.4f}), plain {plain_ms:.4f} ms (median of 30, CUDA events)",
          flush=True)

    # 5. main path: the fusionnet online loop at 320x256
    cfg = TestConfig()
    t0 = time.perf_counter()
    frames, poses, K = synthetic_stream(cfg, N_FRAMES)
    print(f"[scene] {N_FRAMES} frames rendered at {cfg.image_width}x{cfg.image_height} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    engine = InferenceEngine("fusionnet", cfg, device=device, seed=0)
    timer = InferenceTimer(n_skip=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ps.launch_count = 0
    predictions, indices = predict_stream(engine, frames, poses, K, cfg, timer=timer)
    torch.cuda.synchronize()
    launches = ps.launch_count
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    d = cfg.depth
    if len(predictions) < N_MIN_KEYFRAMES:
        raise AssertionError(f"only {len(predictions)} keyframes predicted")
    for i, p in zip(indices, predictions):
        if p.shape != (cfg.image_height, cfg.image_width) or not np.isfinite(p).all():
            raise AssertionError(f"frame {i}: bad depth shape {p.shape} or non-finite values")
        if p.min() < d.min_depth - 1e-4 or p.max() > d.max_depth + 1e-4:
            raise AssertionError(f"frame {i}: depth outside [{d.min_depth}, {d.max_depth}]")
    if float(engine.has_prev) != 1.0:
        raise AssertionError("fusionnet recurrent state was not carried")
    if launches < len(predictions):
        raise AssertionError(f"kernel launched {launches} times for {len(predictions)} keyframes")
    steady = timer.times[1:]
    print(f"[main] fusionnet {len(predictions)} keyframes of {N_FRAMES} frames: depth "
          f"{min(p.min() for p in predictions):.4f}..{max(p.max() for p in predictions):.4f} m, "
          f"has_prev=1, kernel launches {launches}, encode_and_predict median "
          f"{np.median(steady):.3f} ms p90 {np.percentile(steady, 90):.3f} ms over "
          f"{len(steady)} (first {timer.times[0]:.1f} ms), peak memory {peak_mib:.1f} MiB",
          flush=True)

    # 6. the same stream's first keyframes on the CPU, same seeded weights
    cpu_engine = InferenceEngine("fusionnet", cfg, device="cpu", seed=0)
    stop = indices[N_REF_KEYFRAMES - 1] + 1
    ref_preds, ref_indices = predict_stream(cpu_engine, frames[:stop], poses[:stop], K, cfg)
    if ref_indices != indices[:N_REF_KEYFRAMES]:
        raise AssertionError(f"keyframe schedule differs on the CPU: {ref_indices}")
    rel = max(float(np.max(np.abs(a - b) / b)) for a, b in zip(predictions, ref_preds))
    print(f"[reference] first {N_REF_KEYFRAMES} keyframes, card vs CPU plain path: max "
          f"relative depth difference {rel:.3e} (tol {REF_RTOL:g})", flush=True)
    if not rel <= REF_RTOL:
        raise AssertionError("card and CPU depths disagree")

    # 7. results
    print(card)
    print(json.dumps({"kernels": [{
        "name": "plane_sweep_multiview",
        "route": "cuda",
        "source": "dvmvs_tpu_torch/csrc/plane_sweep.cu",
        "replaces": "dvmvs_tpu/ops/pallas/cost_volume_kernel.py:274",
        "also_replaces": "dvmvs_tpu/ops/pallas/cost_volume_kernel.py:408",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
