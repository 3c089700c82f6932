"""Weight bridge: JAX/Flax variables -> the port's state dicts.

``load_jax_variables(model, variables)`` takes a Flax ``{"params",
"batch_stats"}`` tree of arrays (as ``dvmvs_tpu``'s models hold them) and
fills the port's submodules. It is the inverse of
``dvmvs_tpu/utils/torch_convert.py``: convolution kernels go from HWIO to
OIHW (depthwise ``(k, k, 1, C)`` becomes ``(C, 1, k, k)``) and BatchNorm
``scale/bias/mean/var`` become ``weight/bias/running_mean/running_var``.
Because the port's submodules carry the original per-module names, each
``model.<module>.state_dict()`` has exactly the keys the original
checkpoints use.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, Tuple

import numpy as np
import torch

CONV, CONV_BIAS, BN, CONV_BN = "conv", "conv_bias", "bn", "conv_bn"
Entry = Tuple[str, Tuple[str, ...], str]  # (torch prefix, flax path, kind)


def _feature_extractor() -> Iterator[Entry]:
    yield from [("layer1.0", ("stem_conv",), CONV), ("layer1.1", ("stem_bn",), BN),
                ("layer1.3", ("stem_dw",), CONV), ("layer1.4", ("stem_dw_bn",), BN),
                ("layer1.6", ("stem_proj",), CONV), ("layer1.7", ("stem_proj_bn",), BN)]
    stacks = [("layer2", 0, "stack1", 3), ("layer3", 0, "stack2", 3),
              ("layer4", 0, "stack3", 3), ("layer4", 1, "stack4", 2),
              ("layer5", 0, "stack5", 4), ("layer5", 1, "stack6", 1)]
    inner = [("0", "expand", CONV), ("1", "expand_bn", BN), ("3", "depthwise", CONV),
             ("4", "depthwise_bn", BN), ("6", "project", CONV), ("7", "project_bn", BN)]
    for layer, index, stack, n_blocks in stacks:
        for b in range(n_blocks):
            for i, name, kind in inner:
                yield f"{layer}.{index}.{b}.layers.{i}", (stack, f"block{b}", name), kind


def _feature_shrinker() -> Iterator[Entry]:
    for i in range(5):
        yield f"fpn.inner_blocks.{i}", (f"inner{i}",), CONV_BIAS
        yield f"fpn.layer_blocks.{i}", (f"layer{i}",), CONV_BIAS


def _cost_volume_encoder() -> Iterator[Entry]:
    for i in range(4):
        block = f"encoder_block{i}"
        yield f"aggregator{i}", (f"aggregator{i}",), CONV_BN
        yield f"{block}.down_convolution.down_conv", (block, "down_convolution"), CONV_BN
        for conv in ("conv1", "conv2"):
            yield (f"{block}.standard_convolution.{conv}",
                   (block, "standard_convolution", conv), CONV_BN)


def _lstm_fusion() -> Iterator[Entry]:
    yield "lstm_cell.conv", ("lstm_cell", "conv"), CONV


def _cost_volume_decoder() -> Iterator[Entry]:
    for i in range(1, 5):
        block = f"decoder_block{i}"
        yield f"{block}.up_convolution.conv", (block, "up_convolution", "conv"), CONV_BN
        yield f"{block}.convolution1", (block, "convolution1"), CONV_BN
        yield f"{block}.convolution2", (block, "convolution2"), CONV_BN
    yield "refine.0", ("refine0",), CONV_BN
    yield "refine.1", ("refine1",), CONV_BN
    for name in ("one_sixteen", "one_eight", "quarter", "half", "full"):
        yield f"depth_layer_{name}.0", (f"depth_layer_{name}", "conv"), CONV_BIAS


MODULE_ENTRIES = {
    "feature_extractor": _feature_extractor,
    "feature_shrinker": _feature_shrinker,
    "cost_volume_encoder": _cost_volume_encoder,
    "lstm_fusion": _lstm_fusion,
    "cost_volume_decoder": _cost_volume_decoder,
}


def _node(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _key(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def _put_conv(sd, prefix, p, bias: bool):
    sd[_key(prefix, "weight")] = _tensor(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if bias:
        sd[_key(prefix, "bias")] = _tensor(p["bias"])


def _put_bn(sd, prefix, p, s):
    sd[_key(prefix, "weight")] = _tensor(p["scale"])
    sd[_key(prefix, "bias")] = _tensor(p["bias"])
    sd[_key(prefix, "running_mean")] = _tensor(s["mean"])
    sd[_key(prefix, "running_var")] = _tensor(s["var"])


def entries_state_dict(entries: Iterable[Entry], params, batch_stats) -> Dict[str, torch.Tensor]:
    """State dict for ``(torch prefix, flax path, kind)`` entries read from
    Flax ``params`` / ``batch_stats`` trees."""
    sd = {}
    for prefix, path, kind in entries:
        if kind == CONV_BN:  # conv_layer: Sequential(Conv2d, BatchNorm2d, ReLU)
            _put_conv(sd, _key(prefix, "0"), _node(params, path + ("conv",)), bias=False)
            bn = path + ("bn",)
            _put_bn(sd, _key(prefix, "1"), _node(params, bn), _node(batch_stats, bn))
        elif kind == BN:
            _put_bn(sd, prefix, _node(params, path), _node(batch_stats, path))
        else:
            _put_conv(sd, prefix, _node(params, path), bias=kind == CONV_BIAS)
    return sd


def load_jax_variables(model: torch.nn.Module, variables, skip: Iterable[str] = ()) -> None:
    """Copy a Flax variables tree into ``model`` (PairNet or FusionNet),
    module by module, with strict key checking; the modules named in
    ``skip`` keep their values."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    for name in MODULE_ENTRIES:
        module = getattr(model, name, None)
        if module is None or name in skip:
            continue
        sd = entries_state_dict(MODULE_ENTRIES[name](), params[name], stats.get(name, {}))
        module.load_state_dict(sd, strict=True)


def _set(tree, path, value):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _array(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def entries_variables(entries: Iterable[Entry], sd) -> Tuple[dict, dict]:
    """The inverse of ``entries_state_dict``: Flax ``(params, batch_stats)``
    trees of float32 arrays read from a state dict."""
    params, stats = {}, {}

    def conv(prefix, path, bias):
        _set(params, path + ("kernel",), _array(sd[_key(prefix, "weight")].permute(2, 3, 1, 0)))
        if bias:
            _set(params, path + ("bias",), _array(sd[_key(prefix, "bias")]))

    def bn(prefix, path):
        _set(params, path + ("scale",), _array(sd[_key(prefix, "weight")]))
        _set(params, path + ("bias",), _array(sd[_key(prefix, "bias")]))
        _set(stats, path + ("mean",), _array(sd[_key(prefix, "running_mean")]))
        _set(stats, path + ("var",), _array(sd[_key(prefix, "running_var")]))

    for prefix, path, kind in entries:
        if kind == CONV_BN:
            conv(_key(prefix, "0"), path + ("conv",), bias=False)
            bn(_key(prefix, "1"), path + ("bn",))
        elif kind == BN:
            bn(prefix, path)
        else:
            conv(prefix, path, bias=kind == CONV_BIAS)
    return params, stats


def _sorted(tree):
    if not isinstance(tree, dict):
        return tree
    return {k: _sorted(tree[k]) for k in sorted(tree)}


def jax_variables(model: torch.nn.Module) -> dict:
    """The Flax ``{"params", "batch_stats"}`` tree of ``model`` (PairNet or
    FusionNet): the inverse of ``load_jax_variables``, module by module. Keys
    are sorted at every level, as in the trees JAX's tree functions return
    (``jax.tree.map``, a jitted init), so Flax serialises both to the same
    bytes."""
    params, stats = {}, {}
    for name in MODULE_ENTRIES:
        module = getattr(model, name, None)
        if module is None:
            continue
        p, s = entries_variables(MODULE_ENTRIES[name](), module.state_dict())
        params[name] = p
        if s:
            stats[name] = s
    return _sorted({"params": params, "batch_stats": stats})
