"""The port's BatchNorm against flax.linen.BatchNorm in train mode.

One train-mode forward at n = 8 values per channel (a batch of 2 at 2x2,
what the 1/32 blocks see for 64x64 images): the output and the updated
running mean and variance must match Flax to 1e-6 relative, for the
layers' momentum (Flax 0.9, torch 0.1) and MnasNet's (Flax 0.9997, torch
3e-4). Stock ``nn.BatchNorm2d`` would fail this: it folds the unbiased batch
variance into the running variance, n/(n-1) = 8/7 of Flax's, which moves the
running variance by m * v / 7 (1.4% of the batch variance at momentum 0.1);
the test asserts that gap too, so it cannot pass by accident.
"""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from dvmvs_tpu_torch.models.layers import BN_EPS, BN_MOMENTUM, BatchNorm2d
from dvmvs_tpu_torch.models.mnasnet import MNAS_BN_MOMENTUM

C = 6


@pytest.mark.parametrize("flax_momentum,torch_momentum", [(0.9, BN_MOMENTUM),
                                                          (0.9997, MNAS_BN_MOMENTUM)])
def test_train_forward_matches_flax(flax_momentum, torch_momentum):
    rs = np.random.RandomState(0)
    x = (rs.randn(2, C, 2, 2) * 1.5 + 0.3).astype(np.float32)  # n = 8 per channel
    scale = rs.rand(C).astype(np.float32) + 0.5
    bias = rs.randn(C).astype(np.float32) * 0.1
    mean0 = rs.randn(C).astype(np.float32) * 0.1
    var0 = rs.rand(C).astype(np.float32) + 0.5

    fbn = fnn.BatchNorm(use_running_average=False, momentum=flax_momentum, epsilon=BN_EPS)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}
    want, mutated = fbn.apply(variables, jnp.asarray(x.transpose(0, 2, 3, 1)),
                              mutable=["batch_stats"])
    want = np.asarray(want).transpose(0, 3, 1, 2)
    want_mean = np.asarray(mutated["batch_stats"]["mean"])
    want_var = np.asarray(mutated["batch_stats"]["var"])

    def run(bn_class):
        bn = bn_class(C, eps=BN_EPS, momentum=torch_momentum).train()
        bn.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                            "running_mean": torch.from_numpy(mean0),
                            "running_var": torch.from_numpy(var0),
                            "num_batches_tracked": torch.tensor(0)})
        y = bn(torch.from_numpy(x).requires_grad_())
        assert y.grad_fn is not None
        return y.detach().numpy(), bn.running_mean.numpy(), bn.running_var.numpy()

    got, got_mean, got_var = run(BatchNorm2d)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose(got_mean, want_mean, rtol=1e-6)
    np.testing.assert_allclose(got_var, want_var, rtol=1e-6)

    # stock torch: same output and mean, running variance off by m * v / 7
    stock, stock_mean, stock_var = run(torch.nn.BatchNorm2d)
    np.testing.assert_allclose(stock, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    batch_var = x.transpose(1, 0, 2, 3).reshape(C, -1).var(axis=1)
    np.testing.assert_allclose(stock_var - want_var, torch_momentum * batch_var / 7, rtol=1e-2)


def test_eval_mode_uses_running_statistics():
    bn = BatchNorm2d(C, eps=BN_EPS, momentum=BN_MOMENTUM).eval()
    with torch.no_grad():
        bn.running_mean.fill_(0.5)
        bn.running_var.fill_(4.0)
    x = torch.randn(2, C, 3, 3, generator=torch.Generator().manual_seed(0))
    before = bn.running_var.clone()
    y = bn(x)
    torch.testing.assert_close(y, (x - 0.5) / torch.sqrt(torch.tensor(4.0 + BN_EPS)))
    assert torch.equal(bn.running_var, before)
