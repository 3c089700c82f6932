"""Time the DLT-solve kernel on one GPU, beside earlier versions of it.

Builds ``csrc/dlt_solve.cu`` and each ``--baseline FILE.cu`` (an earlier
source of the kernel, e.g. the parent commit's, written out with ``git
show``, or an edited copy as a probe; the option may be repeated) in
parallel, and runs them on DELTAS's systems of ``--batch`` keyframes at its
default of two measurement frames (``sweep_measure.dlt_case``, seed 0: 512
systems of 6 rows a keyframe, by keyframe the four cases there). For each
version it prints the largest gap of a homogeneous solution (the last row of
Vh, up to sign) to the plain version's in float64 and whether two launches
are bit-equal; then it times them in turns (the baselines, current, current,
the baselines in reverse; each by ``ops/sweep_measure.time_ms``), one
near-empty kernel in the same timer (the launch floor), each version once
more by ``single_launch_ms``, and the plain version (``torch.linalg.svd``).
It prints the card's ``name, power.limit`` and one JSON report with the
bound (``dlt_bound``) and each version's registers and spills
(``bench_plane_sweep.ptxas_report``; empty for a library built earlier).

Run from the repo root: ``python -m dvmvs_tpu_torch.apps.bench_dlt
[--batch 1] [--baseline build/baseline/dlt_solve.cu ...] [--out FILE.json]``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os

from dvmvs_tpu_torch.apps.bench_plane_sweep import card_name, ptxas_report, turns

SOURCE = "dlt_solve"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=1, help="keyframes of 512 systems each")
    ap.add_argument("--baseline", action="append", default=[],
                    help="an earlier source of the kernel to time beside (repeatable)")
    ap.add_argument("--out", default=None, help="also write the report to this JSON file")
    return ap.parse_args(argv)


def homogeneous_gap(vh, want) -> float:
    """Largest gap of the homogeneous solutions (Vh's last rows), each taken
    with the sign that brings it nearest ``want``'s."""
    got, want = vh[..., 3, :].double(), want[..., 3, :]
    sign = (got * want).sum(-1, keepdim=True).sign()
    return float((got - sign * want).abs().max())


def main(argv=None):
    args = parse_args(argv)
    import torch

    from dvmvs_tpu_torch.baselines.deltas import dlt_system
    from dvmvs_tpu_torch.ops import cuda_build, dlt
    from dvmvs_tpu_torch.ops.sweep_measure import (dlt_bound, dlt_case, single_launch_ms,
                                                   time_ms)

    if not torch.cuda.is_available():
        raise SystemExit("bench_dlt: needs a GPU")
    versions = {"current": SOURCE}
    versions.update({path: (SOURCE, os.path.abspath(path)) for path in args.baseline})
    built = cuda_build.build_all(list(versions.values()))
    fns = {name: dlt.bind(ctypes.CDLL(str(built[k][0]))) for name, k in versions.items()}

    proj, points, conf = (torch.from_numpy(a).cuda() for a in dlt_case(seed=0, B=args.batch))
    A = dlt_system(proj, points, conf).contiguous()
    want = dlt.dlt_solve_plain(A.double())
    checks = {}
    for name, fn in fns.items():
        vh, again = dlt.launch(A, fn), dlt.launch(A, fn)
        torch.cuda.synchronize()
        checks[name] = {"homogeneous_gap_to_float64": homogeneous_gap(vh, want),
                        "bit_equal": bool(torch.equal(vh, again))}
    times = {}
    floor_ms = time_ms(lambda: torch.cuda._sleep(0))
    for name in turns(args.baseline):
        fn = fns[name]
        times.setdefault(name, []).append(time_ms(lambda: dlt.launch(A, fn)))
    single = {name: single_launch_ms(lambda fn=fn: dlt.launch(A, fn)) for name, fn in fns.items()}
    plain_ms = time_ms(lambda: dlt.dlt_solve_plain(A))
    report = {"card": card_name(), "shape": list(A.shape), **dlt_bound(A),
              "launch_floor_ms": floor_ms, "ms": times, "single_launch_ms": single,
              "plain_ms": plain_ms, "checks": checks,
              "ptxas": {name: ptxas_report(built[k][1]) for name, k in versions.items()}}
    print(f"[bench] dlt_solve {tuple(A.shape)}: bound {report['bound_ms'] * 1e3:.4f} us "
          f"({report['bound_by']}); launch floor {floor_ms:.4f} ms; " + "; ".join(
              f"{n} {', '.join(f'{v:.4f}' for v in t)} ms (single {single[n]:.4f}; "
              f"gap {checks[n]['homogeneous_gap_to_float64']:.2e}, "
              f"{'bit-equal' if checks[n]['bit_equal'] else 'NOT bit-equal'})"
              for n, t in times.items()) + f"; plain {plain_ms:.4f} ms", flush=True)
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
