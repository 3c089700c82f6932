"""What the DELTAS cell adds to the harness: its seeded weights, the
convolution flops of one keyframe, the least time of a DLT-solve call, and
the readers of its per-layer metrics.

Weights follow ``weights.py``'s rule on the plain reference
(``reference/deltas.py``), whose state-dict names are the port's: every
convolution's weight and bias uniform in +-1/sqrt(fan_in), BatchNorm at
identity, all drawn by one ``torch.rand`` on a generator of the run's
device.

Flops: each ``nn.Conv2d`` call of the reference's forward of one keyframe
at the test shape counts 2 x its output's elements x (input channels /
groups) x kernel area, counted with hooks on the meta device (the strides
do not divide 240, so no count at a small size scales) and kept in
``flops.py``'s cache, keyed by the sizes, the shape and this reference's
source. The sampling, the matching and the solve are not counted, so a
share of the peak built on them is a floor.

The DLT bound is a copy of the port's ``ops/sweep_measure.py::dlt_bound``
that counts every row of every system from the shape alone, so the count
is the same whatever implements the solve: the systems read once and the
singular vectors written once over the HBM rate, or the float64 flops any
solve of these systems needs over the float64 rate, the larger.
"""

from __future__ import annotations

import hashlib
import math

import torch
import torch.nn as nn

from benchmark.harness import flops, roofline, spans
from benchmark.harness.core import BENCH
from benchmark.reference import deltas as reference

# NVIDIA H100 SXM5 data sheet: float64 outside the tensor cores
PEAK_F64_FLOPS = 34e12
# float64 flops of the least solve: folding a row into a 4x4 upper
# triangle; checking the triangle's six column pairs once; the norms and
# ranks (the port's DLT_ROW_FLOPS, DLT_CHECK_FLOPS, DLT_TAIL_FLOPS)
ROW_FLOPS, CHECK_FLOPS, TAIL_FLOPS = 84, 6 * 28, 80
# the kernel of the port's csrc/dlt_solve.cu (both its instantiations)
DLT_KERNELS = ("dlt_solve_kernel",)
ESTIMATOR = ("dvmvs.baseline.", "dvmvs.graph.")


def state_dict(sizes: dict, seed: int, device) -> dict:
    """The seeded state dict of the reference at ``sizes`` on ``device``."""
    with torch.device("meta"):
        model = reference.build(sizes)
    bounds = {}
    for name, module in model.named_modules():
        if isinstance(module, nn.Conv2d):
            bound = 1.0 / math.sqrt(module.weight[0].numel())
            bounds[f"{name}.weight"] = bound
            if module.bias is not None:
                bounds[f"{name}.bias"] = bound
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    generator = torch.Generator(device=device).manual_seed(seed)
    draw = torch.rand(sum(math.prod(shapes[k]) for k in bounds), generator=generator,
                      device=device)
    out, offset = {}, 0
    for key, shape in shapes.items():
        if key in bounds:
            n = math.prod(shape)
            out[key] = ((draw[offset:offset + n] * 2 - 1) * bounds[key]).view(shape)
            offset += n
        elif key.endswith("num_batches_tracked"):
            out[key] = torch.zeros((), dtype=torch.long, device=device)
        elif key.endswith(("weight", "running_var")):
            out[key] = torch.ones(shape, device=device)
        else:
            out[key] = torch.zeros(shape, device=device)
    return out


def reference_model(sizes: dict, seed: int, device) -> nn.Module:
    """The plain reference with the seeded weights, in eval mode."""
    with torch.device(device):
        model = reference.build(sizes)
    model.load_state_dict(state_dict(sizes, seed, device), strict=True)
    return model.eval()


def predict_flops(sizes: dict, test: dict) -> int:
    """Convolution flops of one keyframe at the test shape (cached)."""
    shape = [test["image_height"], test["image_width"], test["n_measurement_frames"]]
    source = hashlib.sha256((BENCH / "reference" / "deltas.py").read_bytes()).hexdigest()
    return flops.cached("deltas_predict", [sizes, shape, source],
                        lambda: _predict_flops(sizes, *shape))


def _predict_flops(sizes: dict, H: int, W: int, V: int) -> int:
    with torch.device("meta"):
        model = reference.build(sizes).eval()
    total = [0]

    def hook(module, args, out):
        total[0] += 2 * out.numel() * module.weight[0].numel()

    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            m.register_forward_hook(hook)
    with torch.device("meta"):
        model.stages(torch.zeros(1, 3, H, W), torch.zeros(1, V, 3, H, W),
                     torch.zeros(1, V, 4, 4), torch.zeros(1, 3, 3), torch.ones(1, V))
    return total[0]


def dlt_bound_s(shape) -> float:
    """The least time (s) of one solve of systems of ``shape`` (..., R, 4)."""
    rows = math.prod(shape[:-1])
    n = rows // shape[-2]
    n_bytes = 4 * (rows * 4 + n * 16)
    n_flops = rows * ROW_FLOPS + n * (CHECK_FLOPS + TAIL_FLOPS)
    return max(n_bytes / roofline.PEAK_BYTES_PER_S, n_flops / PEAK_F64_FLOPS)


def dlt_roofline(run):
    """Percent of the summed bound of the traced window's DLT solves
    (``run.sweeps["dlt_solve"]``: a shape a call) in the device time of the
    ``dlt_solve`` kernels; None without a trace of such a kernel."""
    calls = run.sweeps.get("dlt_solve") or []
    if run.trace is None or not calls:
        return None
    device_s = run.trace.kernel_s(DLT_KERNELS)
    if device_s <= 0:
        return None
    return 100.0 * sum(dlt_bound_s(shape) for shape in calls) / device_s


def host_idle_ms_per_kf(run):
    """Device-idle ms under the estimator's and graphs' spans, per depth
    read back (``dvmvs.baseline.readback``)."""
    return spans._idle_ms_per(run, ESTIMATOR, "dvmvs.baseline.readback")
