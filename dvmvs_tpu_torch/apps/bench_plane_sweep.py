"""Time a plane-sweep kernel on one GPU, beside earlier versions of it.

``--kernel forward`` (the default) builds ``csrc/plane_sweep.cu``,
``--kernel backward`` builds ``csrc/plane_sweep_bwd.cu``; each ``--baseline
FILE.cu`` (an earlier source of the same kernel, e.g. the parent commit's,
written out with ``git show``, or an edited copy as a probe; the option may
be repeated) is built in parallel. A header that a baseline includes is
taken from beside it before ``csrc/``: write the parent's header there if
the current one changed. At each shape it checks every version against the
plain PyTorch version (the forward's ``plane_sweep_multiview_plain``; for
the backward autograd through it, ``plane_sweep_backward_plain``: max abs
difference of each output; for the backward also the chunk steps whose
d_meas is binned, ``sweep_measure.binned_share``) and against the first
baseline, then times them
in turns (the baselines, current, current, the baselines in reverse; each
by ``ops/sweep_measure.time_ms``: the median of 30 CUDA-event timings of 10
back-to-back launches queued behind a spin kernel, after 5 warm-up launches,
L2 not flushed: the step calls the kernel on tensors it just wrote), and the
current kernel once more through its wrapper by ``single_launch_ms`` (one
call a timing, the host's launch overhead included). The plain version is
timed too (for the backward, autograd of a kept graph). ``--probe`` also
times every version on matrices that change where the taps fall (every
plane on one plane's matrix, so the taps of all planes coincide; the
identity). It prints the card's ``name, power.limit`` and one JSON report
with each shape's bound (the least time the card could take,
``sweep_bound``) and each version's registers and spills (``ptxas_report``;
empty for a library built earlier).

Shapes (B, V, C, H, W, P), typical geometry, dot product and planes at
0.25-20 m unless given:
  forward:
    online          1, 2, 32, 128, 160, 64: fusionnet at 320x256 frames
    training        4, 1, 32, 128, 128, 64: the single-view training forward at 256x256
    640x480         1, 2, 32, 240, 320, 64: 640x480 frames
    baselines_l1    1, 2, 3, 256, 320, 64, L1 mode, planes at 0.5-50 m: MVDepthNet's
                    and GP-MVS's sweep of the normalised RGB frames
  backward:
    training        4, 1, 32, 128, 128, 64: the training backward at 256x256
    online_masked   1, 2, 32, 128, 160, 64, view weights (1, 0): one view masked
    640x480         1, 2, 32, 240, 320, 64

Run from the repo root: ``python -m dvmvs_tpu_torch.apps.bench_plane_sweep
[--kernel {forward,backward}] [--baseline build/baseline/plane_sweep.cu ...]
[--probe] [--out FILE.json]``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess

import numpy as np

DOT, L1, DEPTHS = True, False, (0.25, 20.0)
# kernel -> shape name -> ((B, V, C, H, W, P), view weights or None for 1/V
# each, dot product, depth range of the planes in metres)
SHAPES = {
    "forward": {
        "online": ((1, 2, 32, 128, 160, 64), None, DOT, DEPTHS),
        "training": ((4, 1, 32, 128, 128, 64), None, DOT, DEPTHS),
        "640x480": ((1, 2, 32, 240, 320, 64), None, DOT, DEPTHS),
        "baselines_l1": ((1, 2, 3, 256, 320, 64), None, L1, (0.5, 50.0)),
    },
    "backward": {
        "training": ((4, 1, 32, 128, 128, 64), None, DOT, DEPTHS),
        "online_masked": ((1, 2, 32, 128, 160, 64), (1.0, 0.0), DOT, DEPTHS),
        "640x480": ((1, 2, 32, 240, 320, 64), None, DOT, DEPTHS),
    },
}
SOURCES = {"forward": "plane_sweep", "backward": "plane_sweep_bwd"}
OUTPUTS = {"forward": ("cost",), "backward": ("d_ref", "d_meas")}


def _short_name(mangled: str) -> str:
    """``..._kernelILi4ELi2ELb1EEEv...`` -> ``plane_sweep_kernel<4,2,1>``
    (also ``dlt_solve_kernel<8>``)."""
    m = re.search(r"((?:plane_sweep(?:_bwd|_small)?|dlt_solve)_kernel)I(.*?)EEv", mangled)
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


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--kernel", choices=sorted(SHAPES), default="forward")
    ap.add_argument("--baseline", action="append", default=[],
                    help="an earlier source of the kernel to time beside (repeatable)")
    ap.add_argument("--shapes", default=None,
                    help="comma-separated shape names (default: all of the kernel's)")
    ap.add_argument("--probe", action="store_true",
                    help="also time every version at each shape with every plane's matrix "
                         "replaced by one plane's (the taps of all planes coincide) and by "
                         "the identity (each pixel samples itself)")
    ap.add_argument("--out", default=None, help="also write the report to this JSON file")
    args = ap.parse_args(argv)
    args.shapes = args.shapes.split(",") if args.shapes else list(SHAPES[args.kernel])
    unknown = set(args.shapes) - set(SHAPES[args.kernel])
    if unknown:
        ap.error(f"unknown {args.kernel} shapes {sorted(unknown)}; "
                 f"choose from {sorted(SHAPES[args.kernel])}")
    return args


def turns(baselines) -> list:
    """Timing order: the baselines, current twice, the baselines in reverse."""
    return [*baselines, "current", "current", *reversed(baselines)]


def case_inputs(kernel: str, shape_name: str, device="cuda"):
    """The seeded inputs of a shape: (ref, meas, mats, weights), and the
    cotangent g (B, P, H, W) for the backward."""
    import torch

    from dvmvs_tpu_torch.ops.sweep_measure import sweep_case

    shape, weights, _, depths = SHAPES[kernel][shape_name]
    inputs = sweep_case(shape, weights=weights, device=device, depths=depths)
    if kernel == "backward":
        B, _, _, H, W, P = shape
        g = np.random.RandomState(1).randn(B, P, H, W).astype(np.float32)
        inputs = (*inputs, torch.from_numpy(g).to(device))
    return inputs


def plain(kernel: str, inputs, dot: bool = True) -> tuple:
    """The plain version's outputs (``OUTPUTS[kernel]``) on these inputs."""
    from dvmvs_tpu_torch.ops import plane_sweep as ps

    if kernel == "forward":
        return (ps.plane_sweep_multiview_plain(*inputs, dot),)
    return ps.plane_sweep_backward_plain(*inputs)


def launch(kernel: str, fn, inputs, dot: bool = True) -> tuple:
    """Launch a bound entry point of the kernel on the inputs."""
    from dvmvs_tpu_torch.ops import plane_sweep as ps

    if kernel == "forward":
        return (ps.launch_forward(fn, *inputs, dot),)
    return ps.launch_backward(fn, *inputs)


def max_abs_diff(kernel: str, got, want) -> dict:
    """{output name: max abs difference} of two output tuples."""
    return {name: (a - b).abs().max().item() for name, a, b in zip(OUTPUTS[kernel], got, want)}


def plain_timer(kernel: str, inputs, dot: bool = True):
    """A call of the plain version to time: the forward, or for the backward
    autograd of a graph built once and kept."""
    import torch

    from dvmvs_tpu_torch.ops import plane_sweep as ps

    if kernel == "forward":
        return lambda: ps.plane_sweep_multiview_plain(*inputs, dot)
    ref, meas, mats, w, g = inputs
    r, m = ref.clone().requires_grad_(), meas.clone().requires_grad_()
    out = ps.plane_sweep_multiview_plain(r, m, mats, w)
    return lambda: torch.autograd.grad(out, (r, m), g, retain_graph=True)


def main(argv=None):
    args = parse_args(argv)
    from dvmvs_tpu_torch.utils.precision import ieee_float32

    with ieee_float32():
        return _bench(args)


def _bench(args):
    import torch

    from dvmvs_tpu_torch.ops import cuda_build
    from dvmvs_tpu_torch.ops import plane_sweep as ps
    from dvmvs_tpu_torch.ops.sweep_measure import (binned_share, single_launch_ms, sweep_bound,
                                                   time_ms)

    if not torch.cuda.is_available():
        raise SystemExit("bench_plane_sweep: needs a GPU")
    kernel, source = args.kernel, SOURCES[args.kernel]
    versions = {"current": source}
    versions.update({path: (source, os.path.abspath(path)) for path in args.baseline})
    built = cuda_build.build_all(list(versions.values()))
    fns = {name: ps.bind(ctypes.CDLL(str(built[k][0])), source) for name, k in versions.items()}
    ptxas = {name: ptxas_report(built[k][1]) for name, k in versions.items()}

    report = {"card": card_name(), "kernel": kernel, "ptxas": ptxas, "shapes": {}}
    for shape_name in args.shapes:
        inputs = case_inputs(kernel, shape_name)
        dot = SHAPES[kernel][shape_name][2]
        want = plain(kernel, inputs, dot)
        outs = {name: launch(kernel, fn, inputs, dot) for name, fn in fns.items()}
        torch.cuda.synchronize()
        ref, meas, mats, w = inputs[:4]
        entry = {"shape": dict(zip("BVCHWP", SHAPES[kernel][shape_name][0])),
                 "weights": w[0].tolist(), "dot_product": dot,
                 **sweep_bound(ref, meas, mats, w, backward=kernel == "backward"),
                 "max_abs_err": {n: max_abs_diff(kernel, o, want) for n, o in outs.items()}}
        if kernel == "backward":
            entry["binned_steps"] = binned_share(mats, w, *ref.shape[1:3])
        if args.baseline:
            first = outs[args.baseline[0]]
            entry["max_abs_diff_to_baseline"] = {n: max_abs_diff(kernel, o, first)
                                                 for n, o in outs.items()}
        times = {}
        for name in turns(args.baseline):
            fn = fns[name]
            times.setdefault(name, []).append(time_ms(lambda: launch(kernel, fn, inputs, dot)))
        entry["ms"] = times
        entry["single_launch_ms"] = single_launch_ms(
            lambda: ps.plane_sweep_multiview(*inputs, dot) if kernel == "forward"
            else ps.plane_sweep_backward(*inputs))
        entry["plain_ms"] = time_ms(plain_timer(kernel, inputs, dot))
        if args.probe:
            one_plane = mats[:, :, mats.shape[2] // 2:][:, :, :1].expand_as(mats).contiguous()
            identity = torch.eye(3, device=mats.device).expand_as(mats).contiguous()
            entry["probe_ms"] = {
                probe: {name: time_ms(lambda fn=fn, m=m: launch(
                    kernel, fn, (ref, meas, m, *inputs[3:]), dot)) for name, fn in fns.items()}
                for probe, m in (("one_plane", one_plane), ("identity", identity))}
        entry["share_of_bound"] = {n: entry["bound_ms"] / float(np.median(t))
                                   for n, t in times.items()}
        report["shapes"][shape_name] = entry
        print(f"[bench] {kernel} {shape_name} {entry['shape']}: bound {entry['bound_ms']:.4f} ms "
              f"({entry['bound_by']}); " + "; ".join(
                  f"{n} {', '.join(f'{v:.4f}' for v in t)} ms" for n, t in times.items())
              + f"; current through the wrapper, single launches "
              f"{entry['single_launch_ms']:.4f} ms; plain {entry['plain_ms']:.4f} ms; "
              + "".join(f"probe {p} " + ", ".join(f"{n} {t:.4f}" for n, t in d.items()) + " ms; "
                        for p, d in entry.get("probe_ms", {}).items())
              + "max_abs_err " + ", ".join(
                  f"{n} " + "/".join(f"{e:.2e}" for e in d.values())
                  for n, d in entry["max_abs_err"].items()), flush=True)
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
