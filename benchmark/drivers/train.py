"""Training cell: the port's graphed fusionnet training step,
``parallel/train.py::GraphedTrainStep(model, "fusionnet").train(optimizer,
batch)``, one replay an optimizer step, with ``make_optimizer`` over all
five modules (the last unfreeze stage: a capturable Adam) and the L1-inv
loss, cycling the mix's rendered batches until the window closes.

Set-up builds the model, the optimizer and the graphed step once, and
drives that same object through its first steps on the first batches (no
row repeated): after the first step it reads each leaf's gradient from
Adam's first moment (m = (1 - beta1) g after one step), and after the last
each leaf's change from the seeded weights. The window goes on with the
same object. At most two steps are queued on the device at a time, so the
window ends a step after its deadline.

Checked against the reference (``reference/loops.py::train_steps``: the
plain model in train mode and ``torch.optim.Adam``, from the same seeded
weights, on the same batches): each step's loss and metrics; after the
first step the worst leaf's norm of Adam's first and second moments (the
first as the gradient, m = (1 - beta1) g); after the last step the worst
leaf's norm of change of the parameters and of BatchNorm's running
statistics, and Adam's step counts (exactly). The parameters' change
leaves out the leaves whose reference gradient is under ``rounding_leaf``
of the median leaf's (a convolution bias before a BatchNorm: Adam moves
it by round-off alone). The moments after later steps are not compared:
float32's own rounding moves them as far as a lower precision does.
"""

from __future__ import annotations

import collections
import sys
import time

import numpy as np
import torch

from benchmark.harness import cells, checks, flops, trace, traffic, weights
from benchmark.harness.core import Run, seeds
from benchmark.harness.roofline import stack_calls
from benchmark.reference import loops


def norms(tensors: dict) -> dict:
    return {n: float(t.double().norm()) for n, t in tensors.items()}


def run(ctx) -> Run:
    from dvmvs_tpu_torch.models.fusionnet import FusionNet
    from dvmvs_tpu_torch.parallel.train import FUSIONNET_STAGES, GraphedTrainStep, make_optimizer

    work = ctx.workload
    kind, sizes, train = ctx.config["model"], ctx.config["sizes"], ctx.config["train"]
    traffic_seed, weight_seed = seeds(ctx.seed, 2)
    workers = traffic.render_workers() if torch.device(ctx.device).type == "cuda" else 0
    host = traffic.make(ctx.traffic, ctx.config, traffic_seed, workers)["batches"]
    ctx.mark("traffic (rendered)")
    batches = [{k: torch.from_numpy(v).to(ctx.device) for k, v in b.items()} for b in host]
    beta1, beta2 = train["adam_betas"]

    with torch.device(ctx.device):
        model = FusionNet(sizes["min_depth"], sizes["max_depth"], sizes["n_depth_levels"],
                          sizes["lstm_hidden_channels"])
    model.load_state_dict(weights.state_dict(kind, sizes, weight_seed, ctx.device))
    model.train()
    optimizer = make_optimizer(model, FUSIONNET_STAGES[-1], train["learning_rate"], beta1, beta2)
    step = GraphedTrainStep(model, kind, train["loss_type"])
    ctx.mark("model, weights and optimizer")
    unit = flops.train_step(kind, sizes, train)
    ctx.mark("flops")
    names = {p: n for n, p in model.named_parameters()}

    checked = work["checked_steps"]
    got = {"metrics": []}
    for i in range(checked):
        # the metrics are buffers that the next step rewrites
        got["metrics"].append({k: float(v) for k, v in step.train(optimizer, batches[i]).items()})
        if i == 0:
            got["grads"] = {names[p]: float(s["exp_avg"].double().norm()) / (1 - beta1)
                            for p, s in optimizer.state.items()}
            got["exp_avg_sq"] = norms({names[p]: s["exp_avg_sq"]
                                       for p, s in optimizer.state.items()})
    start_weights = weights.state_dict(kind, sizes, weight_seed, ctx.device)
    got["change"] = norms({n: p.detach() - start_weights[n] for n, p in model.named_parameters()})
    got["buffers"] = norms({n: b - start_weights[n] for n, b in model.named_buffers()
                            if b.is_floating_point()})
    got["adam_steps"] = {names[p]: float(s["step"]) for p, s in optimizer.state.items()}
    del start_weights
    cells.sync(ctx.device)
    ctx.mark("graph capture and the checked steps")

    cuda = torch.device(ctx.device).type == "cuda"
    queued = collections.deque()

    def advance(i: int):
        step.train(optimizer, batches[i % len(batches)])
        if cuda:
            queued.append(torch.cuda.Event())
            queued[-1].record()
            if len(queued) > 2:
                queued.popleft().synchronize()

    out = Run(ctx.cell, ctx.device)
    start = time.perf_counter()
    out.values["setup_s"] = start - ctx.t0
    deadline, n = start + ctx.seconds, 0
    while time.perf_counter() < deadline:
        advance(checked + n)
        n += 1
    cells.sync(ctx.device)
    out.values.update(window_s=time.perf_counter() - start, steps=n, attempted=n,
                      conv_flops=n * unit)

    if ctx.trace:
        holder, traced_steps = {}, 0
        trace.spanned(step, ("train",), prefix="train.")
        with trace.traced(holder, ctx.device):
            for _ in range(work["trace_steps"]):
                advance(checked + n + traced_steps)
                traced_steps += 1
        out.trace = holder["trace"]
        forward, backward = [], []
        half = 0.5 * train["image_size"]
        for i in range(traced_steps):
            b = host[(checked + n + i) % len(host)]
            for t in range(1, train["subsequence_length"]):
                mask = np.ones((train["batch_size"], 1), np.float32)
                mats, w8 = cells.sweep_call(b["poses"][:, t], b["poses"][:, t - 1][:, None], mask,
                                            cells.half_K(b["K"]), sizes, ctx.device)
                call = (mats, w8, int(half), int(half), sizes["fpn_channels"])
                forward.append(call)
                backward.append(call)
        out.sweeps = {"forward": stack_calls(forward), "backward": stack_calls(backward)}
    out.values["memory_peak_bytes"] = cells.memory_peak(ctx.device)
    del step, optimizer, model, queued
    cells.free(ctx.device)

    compare(ctx, out, batches[:checked], got, weight_seed)
    return out


def compare(ctx, out, batches, got, weight_seed):
    kind, sizes, train = ctx.config["model"], ctx.config["sizes"], ctx.config["train"]
    limits = ctx.workload["limits"]
    model = weights.reference_model(kind, sizes, weight_seed, ctx.device).train()
    with loops.ieee():
        ref = loops.train_steps(model, batches, train["learning_rate"],
                                tuple(train["adam_betas"]), train["adam_eps"])
    start = weights.state_dict(kind, sizes, weight_seed, ctx.device)
    ref["change"] = norms({n: p - start[n] for n, p in ref["params"].items()})
    ref["buffers"] = norms({n: b - start[n] for n, b in ref["buffers"].items()
                            if b.is_floating_point()})
    ref["grads"] = norms(ref["first_grads"])
    ref["exp_avg_sq"] = norms(ref["first_exp_avg_sq"])
    median = float(np.median(list(ref["grads"].values())))
    moved = [n for n, g in ref["grads"].items() if g >= ctx.workload["rounding_leaf"] * median]
    gaps = {}
    for label, key, names in (("grad_gap", "grads", None), ("change_gap", "change", moved),
                              ("buffer_gap", "buffers", None),
                              ("exp_avg_sq_gap", "exp_avg_sq", None)):
        names = list(ref[key]) if names is None else names
        program = {n: got[key].get(n, 0.0) for n in names}
        gaps[label] = checks.norm_gap(program, ref[key], names)
        scale = float(np.median([ref[key][n] for n in names]))
        leaves = sorted(names, key=lambda n: -abs(program[n] - ref[key][n])
                        / max(ref[key][n], scale))[:3]
        print(f"worst {key} leaves: " + ", ".join(
            f"{n} {program[n]!r} / {ref[key][n]!r}" for n in leaves), file=sys.stderr)
    losses = [m["loss"] for m in got["metrics"]]
    loss_gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
    metric_gaps = [abs(m.get(k, float("inf")) - r[k]) / max(abs(r[k]), 1e-30)
                   for m, r in zip(got["metrics"], ref["metrics"]) for k in r]
    print(f"loss gap by step: {loss_gaps!r}", file=sys.stderr)
    out.check("first_loss_gap", loss_gaps[0] if loss_gaps else float("inf"),
              limits["first_loss_gap"])
    out.check("loss_gap", checks.worst(loss_gaps), limits["loss_gap"])
    out.check("metric_gap", checks.worst(metric_gaps), limits["metric_gap"])
    for label, gap in gaps.items():
        out.check(label, gap, limits[label])
    out.check("adam_step_mismatches",
              sum(got["adam_steps"].get(n, -1.0) != s for n, s in ref["adam_steps"].items()),
              limits["adam_step_mismatches"])
