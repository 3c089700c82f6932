"""Port parity: every model module of dvmvs_tpu_torch against its Flax twin,
with the Flax variables carried across by utils/weights.py.

Flax modules are initialised from a seed, their BatchNorm statistics and
affine parameters are randomised so BatchNorm is not the identity, and the
same numpy inputs go through both. Tolerance: 1e-4 relative to the largest
output magnitude (float32 convolutions summed in another order); depth maps
1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvmvs_tpu.models import convlstm as jlstm
from dvmvs_tpu.models import layers as jl
from dvmvs_tpu.models.fusionnet import FusionNet as JFusionNet
from dvmvs_tpu.models.fusionnet import LSTMCarry as JCarry
from dvmvs_tpu.models.pairnet import PairNet as JPairNet
from dvmvs_tpu_torch.models import convlstm as tlstm
from dvmvs_tpu_torch.models import layers as tl
from dvmvs_tpu_torch.models.fusionnet import FusionNet, LSTMCarry
from dvmvs_tpu_torch.models.pairnet import PairNet
from dvmvs_tpu_torch.utils import weights as tw
from tests.conftest import random_pose

H, W, V, P = 64, 96, 2, 16
MIN_D, MAX_D = 0.25, 20.0
TOL = 1e-4


def _nhwc(a):
    return jnp.asarray(np.moveaxis(np.asarray(a), 1, -1))


def _nchw(a):
    return torch.from_numpy(np.array(np.moveaxis(np.asarray(a), -1, 1)))


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(1.0, np.abs(want).max()))


def _randomize_bn(variables, rs):
    """Non-trivial BatchNorm statistics and affine parameters, in place."""
    def walk(params, stats):
        for k, v in params.items():
            if isinstance(v, dict) and "scale" in v:
                n = v["scale"].shape
                v["scale"] = rs.rand(*n).astype(np.float32) + 0.5
                v["bias"] = rs.randn(*n).astype(np.float32) * 0.1
                stats[k]["mean"] = rs.randn(*n).astype(np.float32) * 0.1
                stats[k]["var"] = rs.rand(*n).astype(np.float32) + 0.5
            elif isinstance(v, dict):
                walk(v, stats.get(k, {}))
    variables = jax.tree.map(np.asarray, variables)  # a mutable copy
    walk(variables["params"], variables.get("batch_stats", {}))
    return variables


def _init(module, rs, *args):
    return _randomize_bn(module.init(jax.random.PRNGKey(0), *args), rs)


def _load(tmodule, variables, entries):
    sd = tw.entries_state_dict(entries, variables["params"], variables.get("batch_stats", {}))
    tmodule.load_state_dict(sd, strict=True)
    return tmodule.eval()


CB = tw.CONV_BN
LAYER_CASES = {
    "conv_bn_relu_stride2": (lambda: jl.ConvBnRelu(16, 3, 2), lambda: tl.ConvBnRelu(8, 16, 3, 2),
                             [("", (), CB)], 8),
    "standard_layer": (lambda: jl.StandardLayer(8, 3), lambda: tl.StandardLayer(8, 3),
                       [("conv1", ("conv1",), CB), ("conv2", ("conv2",), CB)], 8),
    "encoder_block": (lambda: jl.EncoderBlock(16, 5), lambda: tl.EncoderBlock(8, 16, 5),
                      [("down_convolution.down_conv", ("down_convolution",), CB),
                       ("standard_convolution.conv1", ("standard_convolution", "conv1"), CB),
                       ("standard_convolution.conv2", ("standard_convolution", "conv2"), CB)], 8),
    "upconvolution": (lambda: jl.UpconvolutionLayer(8, 3), lambda: tl.UpconvolutionLayer(16, 8, 3),
                      [("conv", ("conv",), CB)], 16),
    "depth_head": (lambda: jl.DepthHead(), lambda: tl.DepthHead(8),
                   [("0", ("conv",), tw.CONV_BIAS)], 8),
}


@pytest.mark.parametrize("name", sorted(LAYER_CASES))
def test_layer_matches_flax(name):
    rs = np.random.RandomState(0)
    make_flax, make_torch, entries, c_in = LAYER_CASES[name]
    x = rs.randn(1, c_in, 8, 12).astype(np.float32)
    fmod = make_flax()
    variables = _init(fmod, rs, _nhwc(x))
    want = fmod.apply(variables, _nhwc(x))
    got = _load(make_torch(), variables, entries)(torch.from_numpy(x))
    _close(got, _nchw(want))


@pytest.mark.parametrize("with_depth", [False, True])
def test_decoder_block_matches_flax(with_depth):
    rs = np.random.RandomState(1)
    x = rs.randn(1, 16, 4, 6).astype(np.float32)
    skip = rs.randn(1, 8, 8, 12).astype(np.float32)
    depth = rs.rand(1, 1, 4, 6).astype(np.float32) if with_depth else None
    fmod = jl.DecoderBlock(8, 3, True, with_depth)
    args = (_nhwc(x), _nhwc(skip), None if depth is None else _nhwc(depth))
    variables = _init(fmod, rs, *args)
    want = fmod.apply(variables, *args)
    tmod = _load(tl.DecoderBlock(16, 8, 3, True, with_depth), variables,
                 [("up_convolution.conv", ("up_convolution", "conv"), CB),
                  ("convolution1", ("convolution1",), CB),
                  ("convolution2", ("convolution2",), CB)])
    got = tmod(torch.from_numpy(x), torch.from_numpy(skip),
               None if depth is None else torch.from_numpy(depth))
    _close(got, _nchw(want))


@pytest.fixture(scope="module")
def nets():
    """Flax FusionNet variables (randomised BN) and the port's FusionNet and
    PairNet carrying them."""
    rs = np.random.RandomState(2)
    jmodel = JFusionNet(MIN_D, MAX_D, P)
    K = np.array([[70.0, 0, W / 2], [0, 70.0, H / 2], [0, 0, 1]], np.float32)[None]
    ref = jnp.zeros((1, H, W, 3))
    carry = JCarry(jnp.zeros((1, H // 32, W // 32, 512)), jnp.zeros((1, H // 32, W // 32, 512)))
    variables = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), ref, jnp.zeros((1, V, H, W, 3)), jnp.eye(4)[None],
        jnp.tile(jnp.eye(4)[None, None], (1, V, 1, 1)), jnp.asarray(K), carry,
        jnp.eye(4)[None], jnp.zeros((1, H // 32, W // 32)))
    variables = _randomize_bn(variables, rs)
    fusion = FusionNet(MIN_D, MAX_D, P)
    tw.load_jax_variables(fusion, variables)
    pair = PairNet(MIN_D, MAX_D, P)
    tw.load_jax_variables(pair, {
        "params": {k: v for k, v in variables["params"].items() if k != "lstm_fusion"},
        "batch_stats": variables["batch_stats"]})
    return variables, fusion.eval(), pair.eval(), K


def _sub(variables, name):
    return {"params": variables["params"][name],
            "batch_stats": variables["batch_stats"].get(name, {})}


def test_feature_extractor_and_fpn_match_flax(nets):
    from dvmvs_tpu.models.fpn import FeatureShrinker
    from dvmvs_tpu.models.mnasnet import MnasFeatureExtractor

    variables, fusion, _, _ = nets
    img = np.random.RandomState(3).randn(2, 3, H, W).astype(np.float32)
    with torch.no_grad():
        taps = fusion.feature_extractor(torch.from_numpy(img))
        feats = fusion.feature_shrinker(*taps)
    want_taps = MnasFeatureExtractor().apply(_sub(variables, "feature_extractor"), _nhwc(img))
    for g, w in zip(taps, want_taps):
        _close(g, _nchw(w))
    want_feats = FeatureShrinker(32).apply(
        {"params": variables["params"]["feature_shrinker"]}, *want_taps)
    assert len(feats) == len(want_feats) == 4
    for g, w in zip(feats, want_feats):
        _close(g, _nchw(w))


def test_encoder_and_decoder_match_flax(nets):
    from dvmvs_tpu.models.decoder import CostVolumeDecoder
    from dvmvs_tpu.models.encoder import CostVolumeEncoder

    variables, fusion, _, _ = nets
    rs = np.random.RandomState(4)
    h, w = H // 2, W // 2
    feats = [rs.randn(1, 32, h // s, w // s).astype(np.float32) for s in (1, 2, 4, 8)]
    cv = rs.randn(1, P, h, w).astype(np.float32)
    want = CostVolumeEncoder().apply(_sub(variables, "cost_volume_encoder"),
                                     *[_nhwc(f) for f in feats], _nhwc(cv))
    with torch.no_grad():
        got = fusion.cost_volume_encoder(*[torch.from_numpy(f) for f in feats],
                                         torch.from_numpy(cv))
    for g, wt in zip(got, want):
        _close(g, _nchw(wt))

    image = rs.randn(1, 3, H, W).astype(np.float32)
    skips = [np.asarray(_nchw(s)) for s in want[:4]]
    bottom = rs.randn(1, 512, H // 32, W // 32).astype(np.float32)
    want = CostVolumeDecoder(MIN_D, MAX_D).apply(
        _sub(variables, "cost_volume_decoder"), _nhwc(image), *[_nhwc(s) for s in skips],
        _nhwc(bottom))
    with torch.no_grad():
        got = fusion.cost_volume_decoder(torch.from_numpy(image),
                                         *[torch.from_numpy(s) for s in skips],
                                         torch.from_numpy(bottom))
    assert len(got) == 5
    for g, wt in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, wt)


def test_lstm_cell_and_hidden_warp_match_flax(nets):
    variables, fusion, _, _ = nets
    rs = np.random.RandomState(5)
    hh, ww = 4, 6
    x, h, c = (rs.randn(1, 512, hh, ww).astype(np.float32) * 0.5 for _ in range(3))
    want_h, want_c = jlstm.LSTMFusion(512).apply(
        {"params": variables["params"]["lstm_fusion"]}, _nhwc(x), _nhwc(h), _nhwc(c))
    with torch.no_grad():
        got_h, got_c = fusion.lstm_fusion(*(torch.from_numpy(a) for a in (x, h, c)))
    _close(got_h, _nchw(want_h))
    _close(got_c, _nchw(want_c))

    prev, cur = (random_pose(rs, 0.1).astype(np.float32)[None] for _ in range(2))
    depth = rs.uniform(1.0, 4.0, (1, hh, ww)).astype(np.float32)
    depth[0, 0, 0] = 0.005  # invalidated by the <= 0.01 m mask
    K = np.array([[6.0, 0, ww / 2], [0, 6.0, hh / 2], [0, 0, 1]], np.float32)[None]
    want = jlstm.warp_hidden_state(_nhwc(h), jnp.asarray(prev), jnp.asarray(cur),
                                   jnp.asarray(depth), jnp.asarray(K))
    got = tlstm.warp_hidden_state(torch.from_numpy(h), torch.from_numpy(prev),
                                  torch.from_numpy(cur), torch.from_numpy(depth),
                                  torch.from_numpy(K))
    assert float(got[0, :, 0, 0].abs().max()) == 0.0
    _close(got, _nchw(want))


def _step_inputs(seed):
    rs = np.random.RandomState(seed)
    ref_image = rs.randn(1, 3, H, W).astype(np.float32)
    meas_images = rs.randn(V, 3, H, W).astype(np.float32)
    ref_pose = np.eye(4, dtype=np.float32)[None]
    meas_poses = np.stack([random_pose(rs, 0.05) for _ in range(V)]).astype(np.float32)[None]
    for v in range(V):
        meas_poses[0, v, :3, :3] = np.eye(3)
        meas_poses[0, v, 0, 3] = 0.1 * (v + 1)
    return rs, ref_image, meas_images, ref_pose, meas_poses


@pytest.mark.parametrize("mask", [[1.0, 1.0], [1.0, 0.0]])
def test_pairnet_predict_depth_matches_flax(nets, mask):
    variables, _, pair, K = nets
    _, ref_image, meas_images, ref_pose, meas_poses = _step_inputs(6)
    jmodel = JPairNet(MIN_D, MAX_D, P)
    jvars = {"params": {k: v for k, v in variables["params"].items() if k != "lstm_fusion"},
             "batch_stats": variables["batch_stats"]}
    view_mask = np.asarray([mask], np.float32)
    jref = jmodel.apply(jvars, _nhwc(ref_image), method="extract_features")
    jmeas = jmodel.apply(jvars, _nhwc(meas_images), method="extract_features")[0][None]
    want = jmodel.apply(jvars, _nhwc(ref_image), jref, jmeas, jnp.asarray(ref_pose),
                        jnp.asarray(meas_poses), jnp.asarray(K), jnp.asarray(view_mask),
                        method="predict_depth")
    with torch.no_grad():
        tref = pair.extract_features(torch.from_numpy(ref_image))
        tmeas = pair.extract_features(torch.from_numpy(meas_images))[0][None]
        got = pair.predict_depth(torch.from_numpy(ref_image), tref, tmeas,
                                 torch.from_numpy(ref_pose), torch.from_numpy(meas_poses),
                                 torch.from_numpy(K), torch.from_numpy(view_mask))
    for g, w in zip(got, want):
        _close(g, w)


def test_fusionnet_predict_depth_matches_flax(nets):
    variables, fusion, _, K = nets
    rs, ref_image, meas_images, ref_pose, meas_poses = _step_inputs(7)
    hh, ww = H // 32, W // 32
    h0, c0 = (rs.randn(1, 512, hh, ww).astype(np.float32) * 0.1 for _ in range(2))
    prev_pose = random_pose(rs, 0.05).astype(np.float32)[None]
    hyp = rs.uniform(1.0, 5.0, (1, hh, ww)).astype(np.float32)
    hyp[0, 0, 0] = 0.0
    jmodel = JFusionNet(MIN_D, MAX_D, P)
    jref = jmodel.apply(variables, _nhwc(ref_image), method="extract_features")
    jmeas = jmodel.apply(variables, _nhwc(meas_images), method="extract_features")[0][None]
    want, want_carry = jmodel.apply(
        variables, _nhwc(ref_image), jref, jmeas, jnp.asarray(ref_pose),
        jnp.asarray(meas_poses), jnp.asarray(K), JCarry(_nhwc(h0), _nhwc(c0)),
        jnp.asarray(prev_pose), jnp.asarray(hyp), method="predict_depth")
    with torch.no_grad():
        tref = fusion.extract_features(torch.from_numpy(ref_image))
        tmeas = fusion.extract_features(torch.from_numpy(meas_images))[0][None]
        got, carry = fusion.predict_depth(
            torch.from_numpy(ref_image), tref, tmeas, torch.from_numpy(ref_pose),
            torch.from_numpy(meas_poses), torch.from_numpy(K),
            LSTMCarry(torch.from_numpy(h0), torch.from_numpy(c0)),
            torch.from_numpy(prev_pose), torch.from_numpy(hyp))
    _close(carry.h, _nchw(want_carry.h))
    _close(carry.c, _nchw(want_carry.c))
    for g, w in zip(got, want):
        _close(g, w)
