"""Multi-scene, multi-seed accuracy proxy (counterpart of
scripts/accuracy_proxy_multiscene.py): does the reference schedule, run by
the port, learn?

Pipeline, each step a child ``python -m dvmvs_tpu_torch.apps.*`` process (a
child that fails fails the run):

  1. render the procedural corpus (``make_synth_scenes``) and the keyframe
     index files of its evaluation scenes (``simulate_keyframe_buffer
     --nmeas 2``); at the recorded configuration, hold it to the recorded
     fingerprints (``corpus_fingerprint``);
  2. per seed, train pairnet on the reference two-stage schedule, then
     fusionnet warm-started from the best-validation pairnet checkpoint on
     the three-stage schedule;
  3. evaluate both best checkpoints on the held-out evaluation scenes with
     ``run_testing`` and keep the mean of the 8 reference metrics.

``report`` sets the port's seeds beside the JAX record's seeds 3-8 (the
seeds evaluated on the same 9 scenes, ``proxy_ms_report.json``): mean and
std of each metric and model on both sides, the metrics whose port mean
lies outside the JAX mean +- 2 std, and the seeds where fusionnet beats
pairnet. The two frameworks draw initial weights from different random
streams, so they can agree in distribution, not seed by seed.

    python -m dvmvs_tpu_torch.apps.accuracy_proxy --seeds 3 4 5 [--out build/proxy]
    python -m dvmvs_tpu_torch.apps.accuracy_proxy --seeds 3 4 5 --report-only

The corpus goes to ``<out>/data_synth``, training runs (checkpoints
``{kind}_epoch{n}.pt``) to ``<out>/runs/seed<s>/<kind>/``, evaluation
results to ``<out>/results/seed<s>/<kind>/`` and the report to
``<out>/report.json``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from dvmvs_tpu_torch.utils.precision import describe

METRIC_NAMES = ["abs", "abs_rel", "abs_inv", "sq_rel", "rmse", "d<1.25", "d<1.25^2", "d<1.25^3"]
LOWER_BETTER = [True] * 5 + [False] * 3
MODELS = ("pairnet", "fusionnet")
# the recorded corpus (docs/corpus_fingerprint.json, seed base 100): train, val and eval
# scenes, frames, width, height
RECORDED_CORPUS = (8, 2, 9, 120, 320, 256)
JAX_SEEDS = (3, 4, 5, 6, 7, 8)
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FINGERPRINT = os.path.join(REPO, "docs", "corpus_fingerprint.json")
JAX_REPORT = os.path.join(REPO, "proxy_ms_report.json")


def run(args: Sequence[str]):
    """``python -m`` a module of the port from the repo root; raises if it
    fails."""
    cmd = [sys.executable, "-m", *args]
    print("+", " ".join(cmd), flush=True)
    subprocess.run(cmd, check=True, cwd=REPO)


def validation_log(run_dirs: Sequence[str]) -> Dict[int, dict]:
    """Validation records by epoch over the run directories'
    ``metrics.jsonl``."""
    vals = {}
    for rd in run_dirs:
        path = os.path.join(rd, "metrics.jsonl")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("tag") == "validation" and "epoch" in rec:
                    vals[int(rec["epoch"])] = rec
    return vals


def select_best(run_dirs: Sequence[str]) -> Optional[str]:
    """The checkpoint ``{kind}_epoch{n}.pt`` with the least validation l1
    across the run directories (the JAX script's rule), or None."""
    best = (float("inf"), None)
    for rd in run_dirs:
        vals = validation_log([rd])
        for ck in sorted(glob.glob(os.path.join(rd, "*_epoch*.pt"))):
            e = int(ck.rsplit("epoch", 1)[1].split(".")[0])
            if e in vals and vals[e]["l1"] < best[0]:
                best = (vals[e]["l1"], ck)
    return best[1]


def eval_metrics(result_dir: str) -> np.ndarray:
    """Mean of the 8 metrics over every keyframe of every ``*errors*.npz``
    in ``result_dir``."""
    rows = []
    for f in sorted(glob.glob(os.path.join(result_dir, "*errors*.npz"))):
        with np.load(f) as z:
            rows.append(z["arr_0"])
    if not rows:
        raise FileNotFoundError(f"no errors npz under {result_dir}")
    return np.nanmean(np.concatenate(rows, 0), 0)


def make_corpus(args):
    config = (args.train_scenes, args.val_scenes, args.eval_scenes, args.frames,
              args.width, args.height)
    root = os.path.join(args.out, "data_synth")
    if not os.path.exists(os.path.join(root, "train", "train.txt")):
        run(["dvmvs_tpu_torch.apps.make_synth_scenes", "--output", root,
             "--train-scenes", str(args.train_scenes), "--val-scenes", str(args.val_scenes),
             "--eval-scenes", str(args.eval_scenes), "--frames", str(args.frames),
             "--width", str(args.width), "--height", str(args.height),
             "--workers", str(args.workers)])
        run(["dvmvs_tpu_torch.apps.simulate_keyframe_buffer",
             "--dataset", os.path.join(root, "eval", "synth-eval"),
             "--output", os.path.join(root, "eval", "indices"), "--nmeas", "2"])
    if config == RECORDED_CORPUS:
        from dvmvs_tpu_torch.apps.corpus_fingerprint import EVAL_PIXELS
        run(["dvmvs_tpu_torch.apps.corpus_fingerprint", "--root", root,
             "--expect", FINGERPRINT, "--expect-pixels", EVAL_PIXELS])
    else:
        print(f"corpus {config} is not the recorded {RECORDED_CORPUS}: fingerprint not checked",
              flush=True)
    return root


def train_and_eval_seed(args, root: str, seed: int) -> dict:
    runs = os.path.join(args.out, "runs", f"seed{seed}")
    res_root = os.path.join(args.out, "results", f"seed{seed}")
    if os.path.exists(runs):
        raise FileExistsError(f"{runs} exists: a seed is trained once into fresh directories")
    common = ["--dataset", os.path.join(root, "train"), "--image-size", str(args.res),
              str(args.res), "--seed", str(seed), "--print-frequency", "25",
              "--finetune-epochs", str(args.finetune_epochs), "--wire-compact",
              "--device", args.device]
    if args.max_steps is not None:
        common += ["--max-steps", str(args.max_steps)]
    stage_args = {
        "pairnet": ["--batch-size", str(args.pair_batch), "--epochs", str(args.epochs)],
        "fusionnet": ["--batch-size", str(args.fusion_batch), "--subsequence-length",
                      str(args.subseq), "--epochs", str(args.fusion_epochs)],
    }
    eval_size = (["--width", str(args.eval_size[0]), "--height", str(args.eval_size[1])]
                 if args.eval_size else [])
    summary = {"seed": seed, "seconds": {}, "validation": {}, "checkpoint": {}}
    for kind in MODELS:
        run_parent = os.path.join(runs, kind)
        warm = (["--warm-start", summary["checkpoint"]["pairnet"]]
                if kind == "fusionnet" else [])
        t0 = time.time()
        run(["dvmvs_tpu_torch.apps.run_training", "--model", kind,
             "--run-directory", run_parent] + stage_args[kind] + warm + common)
        summary["seconds"][f"train_{kind}"] = time.time() - t0
        run_dirs = sorted(glob.glob(os.path.join(run_parent, "*")))
        ckpt = select_best(run_dirs)
        if ckpt is None:
            raise RuntimeError(f"{kind}: no checkpoint with a validation record under "
                               f"{run_parent}")
        print(f"{kind} checkpoint: {ckpt}", flush=True)
        summary["checkpoint"][kind] = ckpt
        vals = validation_log(run_dirs)
        l1_inv = [vals[e]["l1_inv"] for e in sorted(vals)]
        summary["validation"][kind] = {"l1_inv": l1_inv, "first": l1_inv[0],
                                       "last": l1_inv[-1], "best": min(l1_inv)}
    for kind in MODELS:
        rd = os.path.join(res_root, kind)
        t0 = time.time()
        run(["dvmvs_tpu_torch.apps.run_testing", "--model", kind,
             "--data", os.path.join(root, "eval"), "--checkpoint", summary["checkpoint"][kind],
             "--output", rd, "--device", args.device] + eval_size)
        summary["seconds"][f"eval_{kind}"] = time.time() - t0
        summary[kind] = eval_metrics(rd).tolist()
    with open(os.path.join(res_root, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary


def _stats(table: np.ndarray) -> List[list]:
    return [[float(m), float(s)] for m, s in zip(table.mean(0), table.std(0))]


def report(results_root: str, seeds: Sequence[int], out_path: str,
           jax_report: str = JAX_REPORT) -> dict:
    """The port's seeds beside the JAX record's seeds 3-8; writes and
    returns the report. Std is over seeds (numpy's, ddof 0, as the JAX
    report prints it)."""
    per_seed = {}
    for seed in seeds:
        with open(os.path.join(results_root, f"seed{seed}", "summary.json")) as f:
            per_seed[seed] = json.load(f)
    with open(jax_report) as f:
        jax_table = json.load(f)["seeds"]
    out = {"metrics": METRIC_NAMES, "seeds": {str(s): v for s, v in per_seed.items()},
           "jax_seeds": list(JAX_SEEDS), "models": {}}
    print(f"\n=== accuracy proxy: port seeds {list(seeds)} against JAX seeds "
          f"{list(JAX_SEEDS)} ===")
    print(f"{'model':>9} {'metric':>9} {'port':>17} {'jax':>17} {'outside 2 std':>14}")
    for kind in MODELS:
        port = np.array([per_seed[s][kind] for s in seeds])
        ref = np.array([jax_table[str(s)][kind] for s in JAX_SEEDS])
        port_stats, ref_stats = _stats(port), _stats(ref)
        outside = [name for name, (pm, _), (rm, rs) in zip(METRIC_NAMES, port_stats, ref_stats)
                   if abs(pm - rm) > 2 * rs]
        out["models"][kind] = {"port": port_stats, "jax": ref_stats, "outside_2std": outside}
        for name, (pm, ps), (rm, rs) in zip(METRIC_NAMES, port_stats, ref_stats):
            print(f"{kind:>9} {name:>9} {pm:8.4f}+-{ps:7.4f} {rm:8.4f}+-{rs:7.4f} "
                  f"{str(name in outside):>14}")
    better = {}
    for i, name in enumerate(METRIC_NAMES):
        sign = 1.0 if LOWER_BETTER[i] else -1.0
        better[name] = int(sum(sign * (per_seed[s]["pairnet"][i] - per_seed[s]["fusionnet"][i]) > 0
                               for s in seeds))
    out["fusionnet_better_seeds"] = better
    print("seeds where fusionnet beats pairnet (of %d): " % len(seeds)
          + ", ".join(f"{k} {v}" for k, v in better.items()))
    for s in seeds:
        v = per_seed[s]["validation"]
        print(f"seed {s}: validation l1_inv first -> best, pairnet "
              f"{v['pairnet']['first']:.4f} -> {v['pairnet']['best']:.4f}, fusionnet "
              f"{v['fusionnet']['first']:.4f} -> {v['fusionnet']['best']:.4f}")
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", out_path, flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=os.path.join("build", "proxy"))
    ap.add_argument("--seeds", type=int, nargs="+", default=[3, 4, 5])
    ap.add_argument("--device", default="cuda", help="passed to the training and test drivers")
    ap.add_argument("--res", type=int, default=256, help="training resolution (square)")
    ap.add_argument("--subseq", type=int, default=8)
    ap.add_argument("--pair-batch", type=int, default=14)
    ap.add_argument("--fusion-batch", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=6, help="pairnet epochs")
    ap.add_argument("--fusion-epochs", type=int, default=15)
    ap.add_argument("--finetune-epochs", type=int, default=2,
                    help="epochs of each non-final unfreeze stage")
    ap.add_argument("--max-steps", type=int, default=100, help="optimizer steps per epoch")
    ap.add_argument("--eval-size", type=int, nargs=2, default=None, metavar=("W", "H"),
                    help="evaluation size (default: the test config's)")
    ap.add_argument("--train-scenes", type=int, default=8)
    ap.add_argument("--val-scenes", type=int, default=2)
    ap.add_argument("--eval-scenes", type=int, default=9)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--workers", type=int, default=8, help="render processes")
    ap.add_argument("--report-only", action="store_true")
    args = ap.parse_args(argv)
    args.out = os.path.abspath(args.out)  # the children run from the repo root

    print(f"accuracy proxy: seeds {args.seeds} on {args.device}; {describe()}", flush=True)
    results_root = os.path.join(args.out, "results")
    if not args.report_only:
        root = make_corpus(args)
        for seed in args.seeds:
            print(f"\n########## seed {seed} ##########", flush=True)
            train_and_eval_seed(args, root, seed)
    return report(results_root, args.seeds, os.path.join(args.out, "report.json"))


if __name__ == "__main__":
    main()
