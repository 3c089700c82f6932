"""Run one cell of the benchmark of the PyTorch/CUDA port once and print
one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell is ``BENCHMARK.json``'s workload of
that name; its files are found by name under ``benchmark/`` (see
``harness/core.py``). Set-up makes the inputs and the weights from the
seed and warms up every shape, the window runs the cell's traffic for
``--seconds``, and with ``--trace 1`` a traced stretch follows it. Then
the reference checks what the window produced. The last line of standard
output is the result; the last lines of standard error are the numbers
compared, each beside its limit.

``--control`` runs the program with its TF32 path switched on (the port's
``utils/precision.py::unpinned``: convolutions in TF32, the lower
precision below the configuration's float32), and ``--fault <name>``
plants a fault of ``harness/faults.py`` underneath the timed path: both
are for measuring what the checks catch, and must come out not correct.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# host numerics on one thread: the keyframe buffer's small solves, and
# no spinning BLAS pool beside the thread that launches the steps
for _var in ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--fault", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import core

    bench = core.spec()
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    ctx = core.context(bench, args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                       T0)
    ctx.mark("imports")
    with contextlib.ExitStack() as stack:
        if args.control:
            from dvmvs_tpu_torch.utils.precision import unpinned

            stack.enter_context(unpinned())
        if args.fault:
            from benchmark.harness import faults

            stack.callback(faults.plant(args.fault))
        run = core.run_cell(ctx)

    found = core.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": entry["chips"],
              "memory_peak_bytes": int(run.values["memory_peak_bytes"])}
    breakdown = None
    if args.trace and run.trace is not None:
        device.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        breakdown = run.trace.breakdown()
    line = core.result_line(bench, run, bool(args.trace), device, breakdown)
    print(f"record {json.dumps(run.values)}", file=sys.stderr)
    core.report_checks(run)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
