"""What TF32 convolutions change against the port's pinned IEEE float32, and
what they buy, path by path on the card.

Every entry point of the port computes in IEEE float32
(``utils/precision.py``). Here each path runs three ways from fresh objects
(so that each captures its own graphs): ``defaults``, the port as it runs,
with torch's defaults left as they are; ``ieee``, under an explicit IEEE
setting of the process; and ``tf32``, the pin bypassed
(``precision.unpinned``), so the convolutions take torch's TF32 default, as
every driver did before the port pinned its mode. ``chip_smoke.py``
[precision] runs three of the paths once each way and holds ``defaults`` to
``ieee``. The paths, with seeded weights and synthetic inputs:

  - online: ``predict_stream`` over 40 frames of ``SynthScene(0)`` at
    320x256 (11 keyframes), fusionnet and pairnet, graphed (the default);
    the time of each ``encode_and_predict``;
  - bulk: pairnet's graphed chunk, ``predict_pair_steps`` with T=4 steps of
    B=8 keyframes from a bank of that stream's frames (``encode_batch``);
    the time of a chunk of 32 keyframes;
  - the four baselines' ``predict`` over 8 seeded keyframes
    (``profile_baselines.seeded_keyframes``), graphed; DELTAS's depth before
    its clip (with seeded weights the clipped depth is one constant);
  - one graphed fusionnet training step at B=4 S=8, 256x256
    (``GraphedTrainStep``, a capturable Adam, every module trainable); its
    metrics, which the forward computes before the update; the time of a
    step to its loss's readback.

Gaps of ``defaults`` and ``tf32`` to ``ieee`` on the first pass: a depth as
max |diff| over max |ieee| and over the ieee depth's spread (max - min;
seeded weights keep the depths nearly flat), the cost volumes (online and
bulk, read out of the graphs) and the training metrics as max |diff| over
max |ieee|. Times: after the first pass, ``--rounds`` rounds of the ways in
turns (the order reversed every round), median and p90 of each unit.

    PYTHONPATH=. python -m dvmvs_tpu_torch.apps.bench_precision [--rounds 4]
        [--out chiprun_out/bench_precision.json]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import time

import numpy as np
import torch

from dvmvs_tpu_torch.utils import precision

MODES = {"defaults": contextlib.nullcontext, "ieee": precision.ieee_float32,
         "tf32": precision.unpinned}
DEVICE = "cuda"
N_FRAMES, CHUNK, BATCH, BASELINE_KEYFRAMES, TRAIN_STEPS = 40, 4, 8, 8, 3


def max_gap(got, want) -> float:
    return max(float(np.abs(g - w).max() / np.abs(w).max()) for g, w in zip(got, want))


def spread_gap(got, want) -> float:
    return max(float(np.abs(g - w).max() / np.ptp(w)) for g, w in zip(got, want))


def timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def online(kind: str, stream):
    """-> (first pass's depths and cost volumes, a function of one timed
    pass returning the ms of each ``encode_and_predict``)."""
    from dvmvs_tpu_torch.apps.engine import InferenceEngine
    from dvmvs_tpu_torch.apps.run_testing_online import predict_stream
    from dvmvs_tpu_torch.config import TestConfig
    from dvmvs_tpu_torch.utils.results import InferenceTimer

    cfg = TestConfig()
    frames, poses, K = stream
    engine = InferenceEngine(kind, cfg, device=DEVICE, seed=0)
    with engine.recording_cost_volumes(graphed=True) as cvs:
        depths, _ = predict_stream(engine, frames, poses, K, cfg)
    outputs = {"depth": depths, "cost_volume": list(cvs)}

    def run():
        engine.reset()
        timer = InferenceTimer(n_skip=0)
        predict_stream(engine, frames, poses, K, cfg, timer=timer)
        return timer.times

    run()  # captures the graphs without the cost volumes
    return outputs, run


def bulk(stream):
    """Pairnet's graphed chunk: T=CHUNK steps of B=BATCH keyframes, frame
    i against frames i-4 and i-8."""
    from dvmvs_tpu_torch.apps.engine import InferenceEngine
    from dvmvs_tpu_torch.config import TestConfig

    frames, poses, K = stream
    engine = InferenceEngine("pairnet", TestConfig(), device=DEVICE, seed=0)
    images = engine.images(np.stack(frames))
    bank = engine.encode_batch(images)
    ref = torch.arange(8, 8 + CHUNK * BATCH, device=DEVICE).reshape(CHUNK, BATCH)
    meas = torch.stack([ref - 4, ref - 8], dim=-1)
    p = torch.from_numpy(np.stack(poses).astype(np.float32)).to(DEVICE)
    xs = {"ref_idx": ref, "meas_idx": meas, "ref_pose": p[ref], "meas_pose": p[meas],
          "view_mask": torch.ones(meas.shape, device=DEVICE)}
    Kb = torch.from_numpy(np.stack([K] * BATCH)).to(DEVICE)
    with engine.recording_cost_volumes(graphed=True) as cvs:
        depth = engine.predict_pair_steps(bank, images, Kb, xs).cpu().numpy()
    outputs = {"depth": list(depth.reshape(-1, *depth.shape[2:])), "cost_volume": list(cvs)}
    return outputs, lambda: [timed(lambda: engine.predict_pair_steps(bank, images, Kb, xs))]


def baseline(name: str):
    from dvmvs_tpu_torch.apps.profile_baselines import seeded_keyframes
    from dvmvs_tpu_torch.baselines import BASELINE_REGISTRY

    est = BASELINE_REGISTRY[name](device=DEVICE, seed=0)
    keyframes = seeded_keyframes(name, BASELINE_KEYFRAMES)
    raw = []
    real = est._readback
    est._readback = lambda depth: (raw.append(real(depth)), raw[-1])[1]
    est.reset()
    for kf in keyframes:
        est.predict(*kf)
    del est._readback

    def run():
        est.reset()
        return [timed(lambda kf=kf: est.predict(*kf)) for kf in keyframes]

    return {"depth": raw}, run


def train(host_batch: dict):
    """``host_batch``: ``profile_step.synthetic_train_batch(256, 4, 8)``."""
    from dvmvs_tpu_torch.apps.run_training import make_model
    from dvmvs_tpu_torch.config import TrainConfig
    from dvmvs_tpu_torch.parallel import train as tt

    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in host_batch.items()}
    model = make_model("fusionnet", TrainConfig(), DEVICE, seed=0).train()
    steps = tt.GraphedTrainStep(model)
    optimizer = tt.make_optimizer(model, tt.FUSIONNET_STAGES[2])
    metrics = steps.train(optimizer, batch)
    first = [np.array([float(metrics[k])]) for k in sorted(metrics)]
    return {"metrics": first}, lambda: [
        timed(lambda: float(steps.train(optimizer, batch)["loss"])) for _ in range(TRAIN_STEPS)]


def gaps(got: dict, want: dict) -> dict:
    out = {}
    for q in want:
        out[f"{q}_max_rel"] = max_gap(got[q], want[q])
        if q == "depth":
            out["depth_over_spread"] = spread_gap(got[q], want[q])
    return out


def compare(make, rounds: int) -> dict:
    """``make()`` in each way, then the gaps to ``ieee`` and the times in
    turns."""
    made = {}
    for mode, context in MODES.items():
        with context():
            made[mode] = make()
    want = made["ieee"][0]
    to_ieee = {mode: gaps(made[mode][0], want) for mode in ("defaults", "tf32")}
    times = {mode: [] for mode in MODES}
    for r in range(rounds):
        for mode in (list(MODES) if r % 2 == 0 else list(MODES)[::-1]):
            with MODES[mode]():
                times[mode] += made[mode][1]()
    del made
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {"gaps_to_ieee": to_ieee,
            "ms": {mode: {"median": float(np.median(t)), "p90": float(np.percentile(t, 90)),
                          "n": len(t)} for mode, t in times.items()}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--out", default=None, help="also write the report to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_precision: needs a GPU (torch.cuda.is_available() is false)")
    from dvmvs_tpu_torch.apps.profile_step import synthetic_stream, synthetic_train_batch
    from dvmvs_tpu_torch.config import TestConfig

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(f"bench_precision on {card}; {precision.describe()}", flush=True)
    stream = synthetic_stream(TestConfig(), N_FRAMES)
    host_batch = synthetic_train_batch(256, 4, 8)
    paths = {"online_fusionnet": lambda: online("fusionnet", stream),
             "online_pairnet": lambda: online("pairnet", stream),
             "bulk_pairnet_chunk": lambda: bulk(stream),
             **{f"baseline_{n}": (lambda n=n: baseline(n))
                for n in ("mvdepthnet", "gpmvs", "dpsnet", "deltas")},
             "train_fusionnet": lambda: train(host_batch)}
    report = {"card": card, "process_flags": precision.current(), "rounds": args.rounds,
              "paths": {}}
    for name, make in paths.items():
        r = report["paths"][name] = compare(make, args.rounds)
        print(f"[{name}] to IEEE: " + "; ".join(
                  f"{mode} " + ", ".join(f"{k} {v:.3e}" for k, v in g.items())
                  for mode, g in r["gaps_to_ieee"].items())
              + "; ms median (p90, n) " + ", ".join(
                  f"{m} {t['median']:.3f} ({t['p90']:.3f}, {t['n']})" for m, t in r["ms"].items())
              + f" | {card}", flush=True)
    text = json.dumps(report, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return report


if __name__ == "__main__":
    main()
