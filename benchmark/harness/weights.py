"""Seeded weights, made on the device in one draw.

The state dict is shaped by the plain reference (``reference/nets.py``),
whose names are the port's: every convolution's weight and bias uniform in
+-1/sqrt(fan_in) (PyTorch's default range), BatchNorm at identity. One
``torch.rand`` on a generator of the run's device gives every value, so the
same seed gives the same weights on the same device.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from benchmark.reference import nets


def reference_on_meta(kind: str, sizes: dict) -> nn.Module:
    with torch.device("meta"):
        return nets.build(kind, sizes)


def state_dict(kind: str, sizes: dict, seed: int, device) -> dict:
    """The seeded state dict of model ``kind`` at ``sizes`` on ``device``."""
    model = reference_on_meta(kind, sizes)
    bounds = {}
    for name, module in model.named_modules():
        if isinstance(module, nn.Conv2d):
            bound = 1.0 / math.sqrt(module.weight[0].numel())
            bounds[f"{name}.weight"] = bound
            if module.bias is not None:
                bounds[f"{name}.bias"] = bound
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    total = sum(math.prod(shapes[k]) for k in bounds)
    generator = torch.Generator(device=device).manual_seed(seed)
    draw = torch.rand(total, generator=generator, device=device)
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


def reference_model(kind: str, sizes: dict, seed: int, device) -> nn.Module:
    """The plain reference with the seeded weights."""
    with torch.device(device):
        model = nets.build(kind, sizes)
    model.load_state_dict(state_dict(kind, sizes, seed, device), strict=True)
    return model
