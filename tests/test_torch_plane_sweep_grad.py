"""Port parity: the differentiable plane sweep (``PlaneSweepFunction``, the
training entry ``plane_sweep_train`` and ``plane_sweep_cost_volume_train``)
against the JAX custom-VJP pair on the same numpy inputs.

On CPU tensors the Function's forward is the plain version and its backward
is autograd through it; the JAX side runs the Pallas forward and backward
kernels in interpret mode (``make_diff_plane_sweep(band)`` for K3/K5,
``make_diff_plane_sweep_dyn`` for K4/K6). Cases and limits are
tests/test_pallas_vjp.py's: rtol 1e-4 on the summed value and atol
2e-4 * max(|grad|, 1) on d_ref and d_meas. The CUDA kernels are held to the
plain version on the card in test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import jax
import jax.numpy as jnp

from dvmvs_tpu.ops import cost_volume as jcv
from dvmvs_tpu.ops.pallas.cost_volume_kernel import build_plane_matrices
from dvmvs_tpu.ops.pallas.cost_volume_vjp import make_diff_plane_sweep, make_diff_plane_sweep_dyn
from dvmvs_tpu_torch.ops import cost_volume as tcv
from dvmvs_tpu_torch.ops import plane_sweep as tps
from dvmvs_tpu_torch.utils.profiling import counters

P = 16
H = W = 64


def _pose(euler_deg, t):
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = Rotation.from_euler("xyz", euler_deg, degrees=True).as_matrix()
    pose[:3, 3] = t
    return pose


def _K(w, h):
    return np.array([[40.0, 0, w / 2], [0, 40.0, h / 2], [0, 0, 1]], np.float32)


def _grads_close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-4 * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("euler,t,band,C", [
    ([0, 0, 0], [0.12, 0.0, 0.0], 8, 8),       # lateral baseline
    ([2, 3, 1], [0.12, 0.03, 0.02], 16, 8),    # typical keyframe motion
    ([2, 3, 1], [0.12, 0.03, 0.02], 16, 5),    # C = 5 (the JAX side pads to 8)
    ([0, 0, 14], [0.1, 0.0, 0.05], 32, 8),     # strong roll tier
    ([0, 0, 35], [0.1, 0.0, 0.0], None, 5),    # extreme roll: the dynamic-trip pair
    ([8, 0, 25], [0.15, 0.05, 0.1], None, 5),  # strong roll, dynamic-trip pair
])
def test_function_matches_jax_vjp(rng, euler, t, band, C):
    ref = rng.randn(H, W, C).astype(np.float32)
    meas = rng.randn(H, W, C).astype(np.float32)
    cot = rng.randn(P, H, W).astype(np.float32)
    M = np.array(build_plane_matrices(
        jnp.asarray(np.eye(4, dtype=np.float32)), jnp.asarray(_pose(euler, t)),
        jnp.asarray(_K(W, H)), jcv.inverse_depth_planes(0.25, 20.0, P)))
    f = make_diff_plane_sweep(band, interpret=True) if band else \
        make_diff_plane_sweep_dyn(interpret=True)
    val_j, (dref_j, dmeas_j) = jax.value_and_grad(
        lambda r, m: jnp.sum(f(r, m, jnp.asarray(M)) * cot), (0, 1))(
        jnp.asarray(ref), jnp.asarray(meas))

    r = torch.from_numpy(ref)[None].requires_grad_()
    m = torch.from_numpy(meas)[None].requires_grad_()
    mats = torch.from_numpy(M)[None].requires_grad_()
    out = tps.plane_sweep_train(r, m, mats)
    assert out.shape == (1, P, H, W) and out.grad_fn is not None
    val = (out * torch.from_numpy(cot)[None]).sum()
    val.backward()
    np.testing.assert_allclose(val.item(), float(val_j), rtol=1e-4)
    _grads_close(r.grad[0], dref_j)
    _grads_close(m.grad[0], dmeas_j)
    assert mats.grad is None  # the geometry gets no gradient
    # CPU: plain versions
    assert counters[tps.FORWARD_LAUNCHES] == 0 and counters[tps.BACKWARD_LAUNCHES] == 0


def test_cost_volume_train_matches_jax_ladder_on_mixed_batch(rng):
    """A batch of an easy pair and a 35-degree roll (span beyond every band
    tier at 128x128): the JAX ladder routes them to a band tier and to the
    dynamic-trip rung; the port makes one call for both."""
    h = w = 128
    C, B = 8, 2
    ref = rng.randn(B, h, w, C).astype(np.float32)
    meas = rng.randn(B, h, w, C).astype(np.float32)
    cot = rng.randn(B, h, w, P).astype(np.float32)
    poses_ref = np.stack([np.eye(4, dtype=np.float32)] * B)
    poses_meas = np.stack([_pose([1, 2, 0.5], [0.1, 0.02, 0.0]), _pose([0, 0, 35], [0.1, 0, 0])])
    Ks = np.stack([_K(w, h)] * B)

    def loss(r, m):
        cost = jcv.plane_sweep_cost_volume_train(
            r, m, jnp.asarray(poses_ref), jnp.asarray(poses_meas), jnp.asarray(Ks),
            0.25, 20.0, P, method="pallas_interpret")
        return jnp.sum(cost * cot)

    val_j, (dref_j, dmeas_j) = jax.value_and_grad(loss, (0, 1))(
        jnp.asarray(ref), jnp.asarray(meas))

    r = torch.from_numpy(ref.transpose(0, 3, 1, 2).copy()).requires_grad_()
    m = torch.from_numpy(meas.transpose(0, 3, 1, 2).copy()).requires_grad_()
    cost = tcv.plane_sweep_cost_volume_train(
        r, m, torch.from_numpy(poses_ref), torch.from_numpy(poses_meas), torch.from_numpy(Ks),
        0.25, 20.0, P)
    assert cost.shape == (B, P, h, w)
    val = (cost * torch.from_numpy(cot.transpose(0, 3, 1, 2).copy())).sum()
    val.backward()
    # the scalar is a ~500k-term sum with cancellation (test_pallas_vjp.py's
    # own limit for it); the gradients carry the tight check
    np.testing.assert_allclose(val.item(), float(val_j), rtol=1e-3)
    _grads_close(r.grad.permute(0, 2, 3, 1), dref_j)
    _grads_close(m.grad.permute(0, 2, 3, 1), dmeas_j)


def _multiview(rng, c=8, views=2):
    ref = torch.from_numpy(rng.randn(1, 32, 48, c).astype(np.float32))
    meas = torch.from_numpy(rng.randn(1, views, 32, 48, c).astype(np.float32))
    poses = torch.from_numpy(np.stack(
        [_pose([2, 3, 1], [0.12, 0.03, 0.02]), _pose([1, 2, 0.5], [0.1, 0.02, 0])][:views]))
    mats = tps.build_plane_matrices(torch.eye(4), poses, torch.from_numpy(_K(48, 32)),
                                    tcv.inverse_depth_planes(0.25, 20.0, P))[None].contiguous()
    return ref, meas, mats


@pytest.mark.parametrize("weights", [[0.5, 0.5], [1.0, 0.0]])
def test_multiview_wrapper_keeps_gradients(rng, weights):
    """R1: with a gradient asked for, the fused wrapper returns a result with
    a grad_fn whose gradients are autograd's through the plain version, for
    V=2 with view weights (a masked view gets none); mats and weights get
    no gradient."""
    ref, meas, mats = _multiview(rng)
    w = torch.tensor([weights])
    r, m = ref.clone().requires_grad_(), meas.clone().requires_grad_()
    mats.requires_grad_()
    out = tps.plane_sweep_multiview(r, m, mats, w)
    assert out.grad_fn is not None
    cot = torch.from_numpy(rng.randn(*out.shape).astype(np.float32))
    (out * cot).sum().backward()
    assert mats.grad is None
    want_r, want_m = ref.clone().requires_grad_(), meas.clone().requires_grad_()
    (tps.plane_sweep_multiview_plain(want_r, want_m, mats.detach(), w) * cot).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), tps.plane_sweep_multiview_plain(
        ref, meas, mats.detach(), w).numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(r.grad.numpy(), want_r.grad.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(m.grad.numpy(), want_m.grad.numpy(), rtol=1e-6, atol=1e-7)
    if weights[1] == 0.0:
        assert float(m.grad[0, 1].abs().max()) == 0.0


def test_multiview_wrapper_l1_with_gradient_raises(rng):
    ref, meas, mats = _multiview(rng)
    w = torch.full((1, 2), 0.5)
    with pytest.raises(NotImplementedError, match="backward kernel"):
        tps.plane_sweep_multiview(ref.requires_grad_(), meas, mats, w, dot_product=False)
    with torch.no_grad():  # no gradient asked for: L1 runs
        assert tps.plane_sweep_multiview(ref, meas, mats, w, dot_product=False).grad_fn is None
    with pytest.raises(ValueError):  # the backward checks its cotangent
        tps.plane_sweep_backward(ref.detach(), meas, mats, w, torch.zeros(1, P, 32, 47))
