"""Time the forward plane-sweep kernel on one GPU, beside an earlier version of it.

Builds ``csrc/plane_sweep.cu`` and, in parallel, ``--baseline FILE.cu`` (an
earlier source of the same kernel, e.g. the parent commit's, written out
with ``git show``). At each shape it checks both against the plain PyTorch
version (max abs difference) and against each other, then times them in
turns (baseline, current, current, baseline; each by
``ops/sweep_measure.time_ms``: the median of 30 CUDA-event timings of 10
back-to-back launches queued behind a spin kernel, after 5 warm-up launches,
L2 not flushed: the online step calls the kernel on features the network
just wrote), and the current kernel once more by ``single_launch_ms`` (one
launch a timing, the host's launch overhead included). ``--probe`` also
times the current kernel on matrices that change where the taps fall (every
plane alike; the identity), which separates the cost of the gathers' cache
misses from the rest. It prints the card's ``name, power.limit`` and one
JSON report with each shape's bound (the least time the card could take,
``sweep_bound``) and each version's registers and spills (``ptxas_report``;
empty for a library built earlier).

Shapes (B, V, C, H, W, P), typical geometry, dot product:
  online    1, 2, 32, 128, 160, 64: fusionnet at 320x256 frames
  training  4, 1, 32, 128, 128, 64: the single-view training forward at 256x256
  640x480   1, 2, 32, 240, 320, 64: 640x480 frames

Run from the repo root: ``python -m dvmvs_tpu_torch.apps.bench_plane_sweep
[--baseline build/baseline/plane_sweep.cu] [--probe] [--out FILE.json]``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess

import numpy as np

SHAPES = {
    "online": (1, 2, 32, 128, 160, 64),
    "training": (4, 1, 32, 128, 128, 64),
    "640x480": (1, 2, 32, 240, 320, 64),
}


def _short_name(mangled: str) -> str:
    """``..._kernelILi4ELi2ELb1EEEv...`` -> ``plane_sweep_kernel<4,2,1>``."""
    m = re.search(r"(plane_sweep(?:_bwd)?_kernel)I(.*?)EEv", mangled)
    return f"{m.group(1)}<{','.join(re.findall(r'L[ib](\d+)E', m.group(2)))}>" if m else mangled


def ptxas_report(log: str) -> dict:
    """Registers and spill stores of each kernel instantiation in nvcc's
    ``-Xptxas -v`` output (empty for a cached build): {kernel<template
    arguments>: "R registers, S bytes spilled"}."""
    report, name, spilled = {}, None, 0
    for line in log.splitlines():
        if m := re.search(r"Function properties for (\S+)", line):
            name, spilled = _short_name(m.group(1)), 0
        elif m := re.search(r"(\d+) bytes spill stores", line):
            spilled = int(m.group(1))
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            report[name] = f"{m.group(1)} registers, {spilled} bytes spilled"
            name = None
    return report


def card_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--baseline", default=None, help="an earlier plane_sweep.cu to time beside")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--probe", action="store_true",
                    help="also time the current kernel at each shape with every plane's "
                         "matrix replaced by one plane's (the taps of all planes coincide) "
                         "and by the identity (each pixel samples itself)")
    ap.add_argument("--out", default=None, help="also write the report to this JSON file")
    args = ap.parse_args(argv)

    import torch

    from dvmvs_tpu_torch.ops import cuda_build
    from dvmvs_tpu_torch.ops import plane_sweep as ps
    from dvmvs_tpu_torch.ops.sweep_measure import (single_launch_ms, sweep_bound, sweep_case,
                                                   time_ms)

    if not torch.cuda.is_available():
        raise SystemExit("bench_plane_sweep: needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    versions = {"current": "plane_sweep"}
    if args.baseline:
        versions["baseline"] = ("plane_sweep", os.path.abspath(args.baseline))
    built = cuda_build.build_all(list(versions.values()))
    fns = {name: ps.bind(ctypes.CDLL(str(built[k][0])), "plane_sweep")
           for name, k in versions.items()}
    ptxas = {name: ptxas_report(built[k][1]) for name, k in versions.items()}

    order = ["baseline", "current", "current", "baseline"] if args.baseline else ["current"] * 2
    report = {"card": card_name(), "ptxas": ptxas, "shapes": {}}
    for shape_name in args.shapes.split(","):
        shape = SHAPES[shape_name]
        ref, meas, mats, w = sweep_case(shape)
        want = ps.plane_sweep_multiview_plain(ref, meas, mats, w)
        outs = {name: ps.launch_forward(fn, ref, meas, mats, w) for name, fn in fns.items()}
        torch.cuda.synchronize()
        entry = {"shape": dict(zip("BVCHWP", shape)), **sweep_bound(ref, meas, mats, w),
                 "max_abs_err": {n: (o - want).abs().max().item() for n, o in outs.items()}}
        if args.baseline:
            entry["max_abs_diff_to_baseline"] = {
                n: (o - outs["baseline"]).abs().max().item() for n, o in outs.items()}
        times = {}
        for name in order:
            fn = fns[name]
            times.setdefault(name, []).append(
                time_ms(lambda: ps.launch_forward(fn, ref, meas, mats, w)))
        entry["ms"] = times
        entry["single_launch_ms"] = single_launch_ms(
            lambda: ps.plane_sweep_multiview(ref, meas, mats, w))
        entry["plain_ms"] = time_ms(lambda: ps.plane_sweep_multiview_plain(ref, meas, mats, w))
        if args.probe:
            one_plane = mats[:, :, mats.shape[2] // 2:][:, :, :1].expand_as(mats).contiguous()
            identity = torch.eye(3, device=mats.device).expand_as(mats).contiguous()
            entry["probe_ms"] = {
                name: time_ms(lambda m=m: ps.launch_forward(fns["current"], ref, meas, m, w))
                for name, m in (("one_plane", one_plane), ("identity", identity))}
        entry["share_of_bound"] = {n: entry["bound_ms"] / float(np.median(t))
                                   for n, t in times.items()}
        report["shapes"][shape_name] = entry
        print(f"[bench] {shape_name} {shape}: bound {entry['bound_ms']:.4f} ms "
              f"({entry['bound_by']}); " + "; ".join(
                  f"{n} {', '.join(f'{v:.4f}' for v in t)} ms" for n, t in times.items())
              + f"; current through the wrapper, single launches "
              f"{entry['single_launch_ms']:.4f} ms; plain {entry['plain_ms']:.4f} ms; "
              + "".join(f"probe {n} {t:.4f} ms; " for n, t in entry.get("probe_ms", {}).items())
              + "max_abs_err "
              + ", ".join(f"{n} {e:.2e}" for n, e in entry["max_abs_err"].items()), flush=True)
    print(report["card"])
    text = json.dumps(report)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return report


if __name__ == "__main__":
    main()
