"""Convolution flops of a unit of each cell's work, counted once in set-up.

Each ``nn.Conv2d`` call of the plain reference counts 2 x its output's
elements x (input channels / groups) x kernel area, as
``torch.utils.flop_counter.FlopCounterMode`` counts a convolution; a
backward pass counts it again for the weight's gradient and once more for
the input's where the input takes a gradient (not the frames). The models
are fully convolutional and every layer's stride divides 32, so a count at
64x64 scales exactly with the frame's area: the count runs at 64x64 on the
CPU, on weights left uninitialised (the values do not change the count).
The sweep, the splat, the warps and the resizes are not counted, so a share
of the peak built on these flops is a floor.

A count takes seconds of set-up (the CPU's first convolutions), so it is
kept in ``build/benchmark/flops.json`` inside the checkout, keyed by what
it depends on (the configuration's sizes and shapes, and the sources of the
reference and of this file): only a checkout's first run counts.
"""

from __future__ import annotations

import hashlib
import json
import os

import torch
import torch.nn as nn

from benchmark.harness.core import BENCH, ROOT
from benchmark.harness.weights import reference_on_meta

BASE = 64
CACHE = ROOT / "build" / "benchmark" / "flops.json"


def cached(what: str, inputs: list, count):
    """``count()``, or the value kept for the same ``what`` and ``inputs``."""
    digest = hashlib.sha256(json.dumps([what, inputs], sort_keys=True).encode())
    for source in (BENCH / "reference" / "nets.py", BENCH / "harness" / "flops.py"):
        digest.update(source.read_bytes())
    key = digest.hexdigest()
    kept = json.loads(CACHE.read_text()) if CACHE.is_file() else {}
    if key not in kept:
        kept[key] = count()
        CACHE.parent.mkdir(parents=True, exist_ok=True)
        part = CACHE.with_name(f"flops.{os.getpid()}.json")
        part.write_text(json.dumps(kept))
        os.replace(part, CACHE)
    return kept[key]


def _model(kind: str, sizes: dict, train: bool, device="cpu") -> nn.Module:
    return reference_on_meta(kind, sizes).to_empty(device=device).train(train)


def _count(model: nn.Module, fn, first=()) -> tuple:
    """(forward flops, flops of the convolutions in ``first``, whose input
    takes no gradient) of the convolutions ``fn`` calls."""
    counts = {"all": 0, "first": 0}

    def hook(module, args, out):
        flops = 2 * out.numel() * module.weight[0].numel()
        counts["all"] += flops
        if module in first:
            counts["first"] += flops

    handles = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, nn.Conv2d)]
    try:
        with torch.no_grad():
            fn()
    finally:
        for h in handles:
            h.remove()
    return counts["all"], counts["first"]


def _scale(flops: int, H: int, W: int) -> int:
    return flops * H * W // (BASE * BASE)


def inference(kind: str, sizes: dict, test: dict) -> dict:
    """{"encode": flops of one frame's features, "predict": flops of one
    prediction from cached features} at the test shape."""
    return cached("inference", [kind, sizes, test["image_height"], test["image_width"]],
                  lambda: _inference(kind, sizes, test))


def _inference(kind: str, sizes: dict, test: dict, device="cpu") -> dict:
    model = _model(kind, sizes, False, device)
    P, hidden = sizes["n_depth_levels"], sizes.get("lstm_hidden_channels", 0)
    image = torch.zeros(1, 3, BASE, BASE, device=device)
    with torch.no_grad():
        feats = model.extract_features(image)

    def predict():
        out = model.cost_volume_encoder(*feats, torch.zeros(1, P, BASE // 2, BASE // 2,
                                                            device=device))
        bottom = out[-1]
        if hidden:
            h = torch.zeros(1, hidden, BASE // 32, BASE // 32, device=device)
            bottom = model.lstm_fusion(bottom, h, h)[0]
        model.cost_volume_decoder(image, *out[:4], bottom)

    H, W = test["image_height"], test["image_width"]
    return {"encode": _scale(_count(model, lambda: model.extract_features(image))[0], H, W),
            "predict": _scale(_count(model, predict)[0], H, W)}


def train_step(kind: str, sizes: dict, train: dict) -> int:
    """Flops of one fusionnet training step at the training shape
    (``_train_step``)."""
    shape = [train[k] for k in ("batch_size", "subsequence_length", "image_size")]
    return cached("train_step", [kind, sizes, shape], lambda: _train_step(kind, sizes, train))


def _train_step(kind: str, sizes: dict, train: dict, device="cpu") -> int:
    """Flops of one fusionnet training step (forward and backward) at the
    training shape: the backbone over the B*S frames, and S-1 recurrent
    steps (encoder, LSTM, decoder), as ``reference/loops.py::
    fusionnet_sequence_loss`` runs them. Every convolution's input takes a
    gradient but the first one's, which reads the frames."""
    model = _model(kind, sizes, True, device)
    B, S, size = train["batch_size"], train["subsequence_length"], train["image_size"]
    P, hidden = sizes["n_depth_levels"], sizes["lstm_hidden_channels"]
    image = torch.zeros(1, 3, BASE, BASE, device=device)
    first = {model.feature_extractor.layer1[0]}
    backbone, frames = _count(model, lambda: model.extract_features(image), first)
    with torch.no_grad():
        feats = model.extract_features(image)

    def step():
        out = model.cost_volume_encoder(*feats, torch.zeros(1, P, BASE // 2, BASE // 2,
                                                            device=device))
        h = torch.zeros(1, hidden, BASE // 32, BASE // 32, device=device)
        model.cost_volume_decoder(image, *out[:4], model.lstm_fusion(out[-1], h, h)[0])

    recurrent = _count(model, step)[0]
    per_frame = 3 * backbone - frames
    return _scale(B * (S * per_frame + (S - 1) * 3 * recurrent), size, size)
