"""Where the baselines' time and device memory go on the card, stage by
stage, at their full sizes with seeded weights.

For MVDepthNet (GP-MVS adds its host Kalman step to the same stages), DPSNet
and DELTAS: the median CUDA-event time of each stage over ``--reps`` calls
after a warm-up call, the whole ``predict`` (host upload and readback
included) beside them, and for each model the leaf module whose call raises
the allocation most above what was allocated before it (cuDNN's workspace
shows there). Prints one JSON object, also written to ``--out``.

Run: ``python -m dvmvs_tpu_torch.apps.profile_baselines [--out FILE]``
(needs the card; TF32 off).
"""

from __future__ import annotations

import argparse
import json
import subprocess
from typing import Optional, Sequence

import numpy as np
import torch

import dvmvs_tpu_torch.apps.run_testing_baseline  # noqa: F401  (registry population)
from dvmvs_tpu_torch.baselines import BASELINE_REGISTRY
from dvmvs_tpu_torch.baselines.deltas import (
    BORDER,
    sample_descriptors,
    simple_nms,
    top_k_keypoints,
)
from dvmvs_tpu_torch.baselines.dpsnet import inverse_warp
from dvmvs_tpu_torch.baselines.mvdepthnet import l1_cost_volume, upload_views


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

    est = BASELINE_REGISTRY["mvdepthnet"](device="cuda")
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

    est = BASELINE_REGISTRY["dpsnet"](device="cuda")
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

    est = BASELINE_REGISTRY["deltas"](device="cuda")
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


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_baselines: needs a GPU (torch.cuda.is_available() is false)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    result = {"card": card, **profile(args.reps)}
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
