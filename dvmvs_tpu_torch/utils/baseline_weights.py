"""Weight bridge for the baselines: the JAX package's Flax variables -> the
port's state dicts (the inverse of dvmvs_tpu/utils/baseline_convert.py).

The port's baseline modules carry the reference implementation's state-dict
names, so a released reference checkpoint loads with ``load_state_dict`` as
it is, and ``baseline_convert`` turns the port's state dicts into Flax
variables. Here each baseline's entries list (torch key prefix, Flax path,
kind), read in the converter's order: convolution kernels go from HWIO
(DHWIO for 3-D) to OIHW (OIDHW), BatchNorm ``scale/bias/mean/var`` to
``weight/bias/running_mean/running_var``. One function per baseline returns
the state dict of its model class (``MVDepthNetModel``, ``GPMVSModel``,
``DPSNetModel``, ``DeltasModel``). Inputs are NumPy arrays (or anything
``np.asarray`` takes), so nothing here needs JAX.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Iterator

import numpy as np
import torch

from dvmvs_tpu_torch.utils.weights import (
    BN,
    CONV,
    CONV_BIAS,
    Entry,
    _key,
    _node,
    _put_bn,
    _tensor,
)

GP_DEFAULTS = {"gamma2": 1.0, "ell": 1.0, "sigma2": 0.1}


def _put_conv(sd, prefix, p, bias: bool):
    kernel = np.asarray(p["kernel"])  # (..., I, O): HWIO or DHWIO
    order = (kernel.ndim - 1, kernel.ndim - 2) + tuple(range(kernel.ndim - 2))
    sd[_key(prefix, "weight")] = _tensor(kernel.transpose(order))
    if bias:
        sd[_key(prefix, "bias")] = _tensor(p["bias"])


def flax_state_dict(entries: Iterable[Entry], variables, prefix: str = "") -> Dict[str, torch.Tensor]:
    """State dict for ``(torch prefix, flax path, kind)`` entries read from a
    Flax ``{"params", "batch_stats"}`` tree; keys get ``prefix`` in front."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd = {}
    for key, path, kind in entries:
        key = _key(prefix, key)
        if kind == BN:
            _put_bn(sd, key, _node(params, path), _node(stats, path))
        else:
            _put_conv(sd, key, _node(params, path), bias=kind == CONV_BIAS)
    return sd


# ------------------------------------------------------ MVDepthNet / GP-MVS
def mvdepth_encoder_entries() -> Iterator[Entry]:
    """Reference Encoder: conv1..conv5, each Sequential(Conv, BN, ReLU, Conv,
    BN, ReLU) <- DownConv {conv0, bn0, conv1, bn1}."""
    for i in range(1, 6):
        for ours, t in ((0, 0), (1, 3)):
            yield f"conv{i}.{t}", (f"conv{i}", f"conv{ours}"), CONV
            yield f"conv{i}.{t + 1}", (f"conv{i}", f"bn{ours}"), BN


def mvdepth_decoder_entries() -> Iterator[Entry]:
    """Reference Decoder: upconv Sequential(Upsample, Conv, BN, ReLU), iconv
    Sequential(Conv, BN, ReLU), disp Sequential(Conv with bias, Sigmoid)."""
    for j in range(1, 6):
        yield f"upconv{j}.1", (f"upconv{j}", "conv", "conv"), CONV
        yield f"upconv{j}.2", (f"upconv{j}", "conv", "bn"), BN
        yield f"iconv{j}.0", (f"iconv{j}", "conv"), CONV
        yield f"iconv{j}.1", (f"iconv{j}", "bn"), BN
    for j in range(1, 5):
        yield f"disp{j}.0", (f"disp{j}", "conv"), CONV_BIAS


def mvdepthnet_state_dict(variables) -> Dict[str, torch.Tensor]:
    """``{"encoder": ..., "decoder": ...}`` Flax variables (as the JAX
    MVDepthNet holds them) -> ``MVDepthNetModel`` state dict."""
    return {**flax_state_dict(mvdepth_encoder_entries(), variables["encoder"], "encoder"),
            **flax_state_dict(mvdepth_decoder_entries(), variables["decoder"], "decoder")}


def gpmvs_state_dict(variables) -> Dict[str, torch.Tensor]:
    """As ``mvdepthnet_state_dict``, plus the GP hyper-parameters (floats in
    the Flax variables, defaults where absent) as the logs the reference's
    GP layer stores -> ``GPMVSModel`` state dict."""
    sd = mvdepthnet_state_dict(variables)
    for name, default in GP_DEFAULTS.items():
        value = float(variables.get(name, default))
        sd[f"gplayer.{name}"] = torch.tensor([math.log(value)], dtype=torch.float64)
    return sd


# ------------------------------------------------------------------ DPSNet
def dpsnet_entries(params) -> Iterator[Entry]:
    """Reference DPSNet (dpsnet.py:183-308). ``params`` tells which blocks
    have a downsample projection."""
    fe = ("feature_extraction",)
    for i in range(3):  # firstconv: Sequential(convbn, ReLU) x 3
        yield f"feature_extraction.firstconv.{2 * i}.0", fe + (f"first{i}_conv",), CONV
        yield f"feature_extraction.firstconv.{2 * i}.1", fe + (f"first{i}_bn",), BN
    for layer, n in (("layer1", 3), ("layer2", 16), ("layer3", 3), ("layer4", 3)):
        for b in range(n):
            tp, path = f"feature_extraction.{layer}.{b}", fe + (f"{layer}_{b}",)
            yield f"{tp}.conv1.0.0", path + ("c1_conv",), CONV
            yield f"{tp}.conv1.0.1", path + ("c1_bn",), BN
            yield f"{tp}.conv2.0", path + ("c2_conv",), CONV
            yield f"{tp}.conv2.1", path + ("c2_bn",), BN
            if "down_conv" in _node(params, path):
                yield f"{tp}.downsample.0", path + ("down_conv",), CONV
                yield f"{tp}.downsample.1", path + ("down_bn",), BN
    for i in range(4):  # branch1..4 = Sequential(AvgPool, convbn, ReLU)
        yield f"feature_extraction.branch{i + 1}.1.0", fe + (f"branch{i}_conv",), CONV
        yield f"feature_extraction.branch{i + 1}.1.1", fe + (f"branch{i}_bn",), BN
    yield "feature_extraction.lastconv.0.0", fe + ("last0_conv",), CONV
    yield "feature_extraction.lastconv.0.1", fe + ("last0_bn",), BN
    yield "feature_extraction.lastconv.2", fe + ("last1",), CONV
    hg = ("hourglass",)
    for i in range(5):  # dres0..4: Sequential(convbn_3d, ReLU, convbn_3d[, ReLU])
        for t, half in ((0, "a"), (2, "b")):
            yield f"dres{i}.{t}.0", hg + (f"dres{i}{half}_conv",), CONV
            yield f"dres{i}.{t}.1", hg + (f"dres{i}{half}_bn",), BN
    yield "classify.0.0", hg + ("classify0_conv",), CONV
    yield "classify.0.1", hg + ("classify0_bn",), BN
    yield "classify.2", hg + ("classify1",), CONV
    for i in range(7):  # convs = Sequential(convtext x 7), convtext = Sequential(Conv2d, LeakyReLU)
        yield f"convs.{i}.0", ("context", f"convtext{i}"), CONV


def dpsnet_state_dict(variables) -> Dict[str, torch.Tensor]:
    """DPSNetModel Flax variables -> ``DPSNetModel`` state dict (the
    reference's one weight file)."""
    return flax_state_dict(dpsnet_entries(variables["params"]), variables)


# ------------------------------------------------------------------ DELTAS
def resnet50_entries(params, path) -> Iterator[Entry]:
    """torchvision-layout ResNet-50 trunk <- our conv1/bn1 + layer{L}_{b}
    .c{1-3}/bn{1-3} (+ proj/bn_proj)."""
    yield "conv1", path + ("conv1",), CONV
    yield "bn1", path + ("bn1",), BN
    for layer, blocks in ((1, 3), (2, 4), (3, 6), (4, 3)):
        for b in range(blocks):
            tb, pb = f"layer{layer}.{b}", path + (f"layer{layer}_{b}",)
            for ci in (1, 2, 3):
                yield f"{tb}.conv{ci}", pb + (f"c{ci}",), CONV
                yield f"{tb}.bn{ci}", pb + (f"bn{ci}",), BN
            if "proj" in _node(params, pb):
                yield f"{tb}.downsample.0", pb + ("proj",), CONV
                yield f"{tb}.downsample.1", pb + ("bn_proj",), BN


def superpoint_entries(params) -> Iterator[Entry]:
    sp = ("superpoint",)
    yield from resnet50_entries(params, sp + ("trunk",))
    for conv, bn in (("convPa", "bnPa"), ("convPb", "bnPb"), ("convDa", "bnDa"),
                     ("convDb", "bnDb"), ("convDc", "bnDc")):
        yield conv, sp + (conv,), CONV_BIAS
        yield bn, sp + (bn,), BN
    yield "convPc", sp + ("convPc",), CONV_BIAS
    yield "convDd", sp + ("convDd",), CONV_BIAS


def sparse_to_dense_entries(params) -> Iterator[Entry]:
    dd = ("sparse_to_dense",)
    yield from resnet50_entries(params, dd + ("depth_trunk",))
    for i in range(1, 6):
        names = ["conv1", "bn1", "conv2", "bn2", "sc_conv1", "sc_bn1"]
        if i < 5:  # Gudi_UpProj_Block_Cat; the last block has no skip
            names[2:2] = ["conv1_1", "bn1_1"]
        for n in names:
            yield (f"gud_up_proj_layer{i}.{n}", dd + (f"gud_up_proj_layer{i}", n),
                   BN if n.startswith(("bn", "sc_bn")) else CONV)
    for i in range(1, 6):
        for n in ("conv1", "bn1", "conv2", "bn2"):
            yield (f"ASPP.daspp_{i}.{n}", dd + ("ASPP", f"daspp_{i}", n),
                   BN if n.startswith("bn") else CONV)
    yield "ASPP.convf", dd + ("ASPP", "convf"), CONV
    yield "ASPP.bnf", dd + ("ASPP", "bnf"), BN
    for head in ("conv_scale8", "conv_scale4", "conv_scale2", "conv_final"):
        yield head, dd + (head,), CONV_BIAS


def deltas_state_dict(variables) -> Dict[str, torch.Tensor]:
    """DeltasModel Flax variables -> ``DeltasModel`` state dict, whose
    ``superpoint``, ``triangulation`` and ``sparse_to_dense`` parts are the
    reference checkpoint's ``state_dict``, ``state_dict_tri`` and
    ``state_dict_depth``."""
    params = variables["params"]
    return {
        **flax_state_dict(superpoint_entries(params), variables, "superpoint"),
        **flax_state_dict([("bn_match_convD", ("triangulation", "bn_match"), BN)], variables,
                          "triangulation"),
        **flax_state_dict(sparse_to_dense_entries(params), variables, "sparse_to_dense"),
    }


BASELINE_STATE_DICTS = {
    "mvdepthnet": mvdepthnet_state_dict,
    "gpmvs": gpmvs_state_dict,
    "dpsnet": dpsnet_state_dict,
    "deltas": deltas_state_dict,
}
