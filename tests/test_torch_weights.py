"""The weight bridge of dvmvs_tpu_torch (utils/weights.py) against the JAX
package's converter (utils/torch_convert.py): a Flax tree loaded into the
port and converted back through MODULE_CONVERTERS is the same tree, bit for
bit, and the port's state-dict keys are exactly the ones the converter
reads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvmvs_tpu.models.fusionnet import FusionNet as JFusionNet
from dvmvs_tpu.models.fusionnet import LSTMCarry as JCarry
from dvmvs_tpu.utils.torch_convert import MODULE_CONVERTERS
from dvmvs_tpu_torch.models import layers as tl
from dvmvs_tpu_torch.models import mnasnet as tm
from dvmvs_tpu_torch.models.fusionnet import FusionNet
from dvmvs_tpu_torch.models.pairnet import PairNet
from dvmvs_tpu_torch.utils import weights as tw

H, W, V, P = 64, 96, 2, 16


@pytest.fixture(scope="module")
def flax_variables():
    model = JFusionNet(0.25, 20.0, P)
    K = jnp.asarray(np.array([[70.0, 0, W / 2], [0, 70.0, H / 2], [0, 0, 1]], np.float32))[None]
    carry = JCarry(jnp.zeros((1, 2, 3, 512)), jnp.zeros((1, 2, 3, 512)))
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, H, W, 3)), jnp.zeros((1, V, H, W, 3)),
        jnp.eye(4)[None], jnp.tile(jnp.eye(4)[None, None], (1, V, 1, 1)), K, carry,
        jnp.eye(4)[None], jnp.zeros((1, 2, 3)))
    variables = jax.tree.map(np.asarray, variables)
    rs = np.random.RandomState(0)
    # distinct running statistics, so a swapped mean/var would show
    variables["batch_stats"] = jax.tree.map(
        lambda a: (rs.rand(*a.shape) + 0.5).astype(np.float32), variables["batch_stats"])
    return variables


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_round_trip_through_module_converters(flax_variables):
    model = FusionNet(0.25, 20.0, P)
    tw.load_jax_variables(model, flax_variables)
    params, stats = {}, {}
    for name, convert in MODULE_CONVERTERS.items():
        sd = {k: v.numpy() for k, v in getattr(model, name).state_dict().items()}
        convert(sd, params, stats)
    want = dict(_flatten(flax_variables["params"]))
    got = dict(_flatten(params))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=str(key))
    want = dict(_flatten(flax_variables["batch_stats"]))
    got = dict(_flatten(stats))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=str(key))


def test_depthwise_kernels_become_oihw(flax_variables):
    model = FusionNet(0.25, 20.0, P)
    tw.load_jax_variables(model, flax_variables)
    dw = flax_variables["params"]["feature_extractor"]["stem_dw"]["kernel"]  # (3, 3, 1, 32)
    got = model.feature_extractor.layer1[3].weight
    assert tuple(got.shape) == (32, 1, 3, 3)
    np.testing.assert_array_equal(got.detach().numpy(), dw.transpose(3, 2, 0, 1))


def test_pairnet_loads_without_lstm_and_strict_keys(flax_variables):
    pair = PairNet(0.25, 20.0, P)
    tw.load_jax_variables(pair, flax_variables)  # lstm_fusion is ignored
    broken = jax.tree.map(lambda a: a, flax_variables)
    del broken["params"]["cost_volume_encoder"]["aggregator0"]
    with pytest.raises(KeyError):
        tw.load_jax_variables(pair, broken)
    wrong_p = PairNet(0.25, 20.0, 2 * P)  # aggregator0 expects 32 + 2P channels
    with pytest.raises(RuntimeError):
        tw.load_jax_variables(wrong_p, flax_variables)


def test_batchnorm_momentum_follows_torch_convention():
    assert tl.ConvBnRelu(4, 4, 3)[1].momentum == pytest.approx(1 - 0.9)
    bns = [m for m in tm.MnasFeatureExtractor().modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert bns and all(m.momentum == pytest.approx(1 - 0.9997) for m in bns)
    assert all(m.eps == 1e-5 for m in bns)


def test_seeded_initialisation_is_deterministic():
    a, b = PairNet(0.25, 20.0, P), PairNet(0.25, 20.0, P)
    tl.init_parameters(a, torch.Generator().manual_seed(5))
    tl.init_parameters(b, torch.Generator().manual_seed(5))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
