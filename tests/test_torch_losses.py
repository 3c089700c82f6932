"""Port parity: dvmvs_tpu_torch/utils/losses.py against dvmvs_tpu.utils.losses.

Every loss sum (L1, L1-inv, L1-rel, Huber) and the valid count, with
zero-depth (invalid) ground-truth pixels, at full and reduced prediction
scales; values and gradients with respect to the prediction at rtol 1e-5
(float32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvmvs_tpu.utils import losses as jl
from dvmvs_tpu_torch.utils import losses as tl

RTOL = 1e-5


def _inputs(seed, h, w):
    rs = np.random.RandomState(seed)
    gt = rs.uniform(0.3, 6.0, (2, 32, 48)).astype(np.float32)
    gt[rs.rand(*gt.shape) < 0.2] = 0.0  # invalid pixels
    gt[0, :4, :4] = 0.0
    # |gt - pred| on both sides of the Huber knee at 1
    pred = (np.asarray(jl.resize_nearest(jnp.asarray(gt), h, w)) +
            rs.uniform(-2.0, 2.0, (2, h, w))).clip(0.2, None).astype(np.float32)
    return gt, pred


@pytest.mark.parametrize("h,w", [(32, 48), (16, 24), (2, 3)])
@pytest.mark.parametrize("key", ["l1", "l1_inv", "l1_rel", "huber", "valid_count"])
def test_calculate_loss_matches_jax(h, w, key):
    gt, pred = _inputs(0, h, w)
    want, want_grad = jax.value_and_grad(
        lambda p: jl.calculate_loss(jnp.asarray(gt), p)[key])(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_()
    got = tl.calculate_loss(torch.from_numpy(gt), p)[key]
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    if key == "valid_count":
        assert got.grad_fn is None and got.item() == float(np.sum(
            np.asarray(jl.resize_nearest(jnp.asarray(gt), h, w)) != 0))
        return
    got.backward()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grad), rtol=RTOL,
                               atol=RTOL * np.abs(np.asarray(want_grad)).max())


@pytest.mark.parametrize("loss_type", tl.LOSS_TYPES)
def test_multi_scale_loss_matches_jax(loss_type):
    gt, _ = _inputs(1, 32, 48)
    preds = [_inputs(2 + i, h, w)[1] for i, (h, w) in enumerate([(32, 48), (16, 24), (8, 12)])]
    weights = [1.0, 0.5, 0.25]

    def jax_loss(ps):
        return jl.multi_scale_loss(ps, weights, jnp.asarray(gt), loss_type)[0]

    want, want_grads = jax.value_and_grad(jax_loss)([jnp.asarray(p) for p in preds])
    ps = [torch.from_numpy(p).requires_grad_() for p in preds]
    got, last = tl.multi_scale_loss(ps, weights, torch.from_numpy(gt), loss_type)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    for p, g in zip(ps, want_grads):
        g = np.asarray(g)
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=RTOL, atol=RTOL * np.abs(g).max())
    assert set(last) == {"l1", "l1_inv", "l1_rel", "huber", "valid_count"}


def test_loss_meter():
    meter = tl.LossMeter()
    meter.update(2.0, 1.0)
    meter.update(4.0, 3.0)
    assert meter.avg == 1.5 and meter.item_average == 4.0 / 3.0
    assert repr(meter) == "1.3333 (1.5000)"
