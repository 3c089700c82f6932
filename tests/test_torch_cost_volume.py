"""Port parity: dvmvs_tpu_torch's plane sweep and cost volume against the
JAX package on the same numpy inputs.

The plain PyTorch version of the plane-sweep kernel is held to the Pallas
kernels in interpret mode (K1 where the band covers every row's span, K2 on
extreme roll and behind-camera geometry; dot mode at C=8, and L1 mode at the
baselines' C=3 and at C=1, the channel counts the CUDA kernel's
small-channel variant takes) and to the JAX gather path with a masked view,
C=30 and L1 mode. Tolerance 5e-4 absolute, the JAX kernel tests' own: it
covers the (W-1)/W coordinate fold against the normalised-grid route and
the order of summation. The CUDA kernel itself is compared with the plain
version on the card in test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import jax.numpy as jnp

from dvmvs_tpu.ops import cost_volume as jcv
from dvmvs_tpu.ops.pallas import cost_volume_kernel as jk
from dvmvs_tpu_torch.ops import cost_volume as tcv
from dvmvs_tpu_torch.ops import plane_sweep as tps
from dvmvs_tpu_torch.utils.profiling import counters

H, W, C, P = 32, 48, 8, 16  # half-res features of 64x96 frames
ATOL = 5e-4


def _pose(euler_deg, t):
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = Rotation.from_euler("xyz", euler_deg, degrees=True).as_matrix()
    pose[:3, 3] = t
    return pose


def _K():
    return np.array([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]], np.float32)


def _inputs(rng, meas_euler, meas_t, c=C, views=2):
    ref = rng.randn(H, W, c).astype(np.float32)
    meas = rng.randn(views, H, W, c).astype(np.float32)
    ref_pose = np.eye(4, dtype=np.float32)
    poses = [_pose(meas_euler, meas_t)] + [
        _pose([1, 2, 0.5], [0.1, 0.02, 0.0]) for _ in range(views - 1)]
    return ref, meas, ref_pose, np.stack(poses)


def _jax_mats(ref_pose, meas_poses, K):
    invd = jcv.inverse_depth_planes(0.25, 20.0, P)
    return jnp.stack([jk.build_plane_matrices(
        jnp.asarray(ref_pose), jnp.asarray(p), jnp.asarray(K), invd) for p in meas_poses])


def _port_sweep(ref, meas, mats, weights, dot_product=True):
    return tps.plane_sweep_multiview(
        torch.from_numpy(ref)[None], torch.from_numpy(meas)[None],
        torch.from_numpy(np.array(mats))[None],
        torch.from_numpy(np.asarray(weights, np.float32))[None], dot_product)[0].numpy()


def test_build_plane_matrices_matches_jax(rng):
    _, _, ref_pose, poses = _inputs(rng, [2, 3, 1], [0.12, 0.03, 0.02])
    want = np.asarray(_jax_mats(ref_pose, poses, _K()))
    got = tps.build_plane_matrices(
        torch.from_numpy(ref_pose), torch.from_numpy(poses), torch.from_numpy(_K()),
        tcv.inverse_depth_planes(0.25, 20.0, P))
    assert got.shape == (2, P, 3, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tcv.inverse_depth_planes(0.25, 20.0, P).numpy(),
                               np.asarray(jcv.inverse_depth_planes(0.25, 20.0, P)), rtol=1e-7)


@pytest.mark.parametrize("euler,t,c,dot_product", [
    pytest.param([0, 0, 0], [0.12, 0.0, 0.0], C, True, id="euler0-t0"),    # lateral
    pytest.param([2, 3, 1], [0.12, 0.03, 0.02], C, True, id="euler1-t1"),  # typical keyframe motion
    pytest.param([0, 0, 4], [0.05, 0.0, 0.1], C, True, id="euler2-t2"),    # roll + forward
    pytest.param([2, 3, 1], [0.12, 0.03, 0.02], 3, False, id="l1_c3_typical"),  # the RGB sweep
    pytest.param([0, 0, 4], [0.05, 0.0, 0.1], 3, False, id="l1_c3_roll_forward"),
    pytest.param([0, 0, 0], [0.12, 0.0, 0.0], 1, False, id="l1_c1_lateral"),
])
def test_plain_sweep_matches_pallas_band_kernel(rng, euler, t, c, dot_product):
    ref, meas, ref_pose, poses = _inputs(rng, euler, t, c=c)
    mats = _jax_mats(ref_pose, poses, _K())
    band = 16
    spans = [float(jk.max_row_span(m, H, W, band)) for m in mats]
    assert max(spans) <= band, "the band must cover the span for K1 to be exact"
    weights = np.array([0.6, 0.4], np.float32)
    want = jk.pallas_plane_sweep_multiview(
        jnp.asarray(ref), jnp.asarray(meas), mats, jnp.asarray(weights),
        interpret=True, band_h=band, dot_product=dot_product)
    got = _port_sweep(ref, meas, mats, weights, dot_product)
    assert counters[tps.FORWARD_LAUNCHES] == 0  # CPU tensors take the plain version
    assert got.shape == (P, H, W)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("euler,t,c,dot_product", [
    # extreme roll: span beyond every band
    pytest.param([0, 0, 35], [0.1, 0.0, 0.0], C, True, id="euler0-t0"),
    # most samples behind the camera
    pytest.param([0, 120, 0], [0.1, 0.0, 2.0], C, True, id="euler1-t1"),
    pytest.param([0, 0, 35], [0.1, 0.0, 0.0], 3, False, id="l1_c3_extreme_roll"),
    pytest.param([0, 120, 0], [0.1, 0.0, 2.0], 3, False, id="l1_c3_behind_camera"),
    pytest.param([0, 120, 0], [0.1, 0.0, 2.0], 1, False, id="l1_c1_behind_camera"),
])
def test_plain_sweep_matches_pallas_dyn_kernel(rng, euler, t, c, dot_product):
    ref, meas, ref_pose, poses = _inputs(rng, euler, t, c=c)
    mats = _jax_mats(ref_pose, poses, _K())
    weights = np.array([0.6, 0.4], np.float32)
    want = jk.pallas_plane_sweep_multiview_dyn(
        jnp.asarray(ref), jnp.asarray(meas), mats, jnp.asarray(weights), interpret=True,
        dot_product=dot_product)
    got = _port_sweep(ref, meas, mats, weights, dot_product)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("mask,c,dot_product", [
    ([1.0, 0.0], C, True),    # padded second view
    ([1.0, 1.0], 30, True),   # channel count not a multiple of 4 or 8
    ([1.0, 1.0], C, False),   # L1 mode
    ([1.0, 0.0], 30, False),
])
def test_cost_volume_fused_matches_jax_gather(rng, mask, c, dot_product):
    ref, meas, ref_pose, poses = _inputs(rng, [2, 3, 1], [0.12, 0.03, 0.02], c=c)
    K = _K()
    view_mask = np.asarray([mask], np.float32)
    want = jcv.cost_volume_fused(
        jnp.asarray(ref)[None], jnp.asarray(meas)[None], jnp.asarray(ref_pose)[None],
        jnp.asarray(poses)[None], jnp.asarray(K)[None], 0.25, 20.0, P,
        dot_product=dot_product, view_mask=jnp.asarray(view_mask), method="gather")
    got = tcv.cost_volume_fused(
        torch.from_numpy(ref.transpose(2, 0, 1))[None],
        torch.from_numpy(meas.transpose(0, 3, 1, 2))[None],
        torch.from_numpy(ref_pose)[None], torch.from_numpy(poses)[None],
        torch.from_numpy(K)[None], 0.25, 20.0, P, dot_product=dot_product,
        view_mask=torch.from_numpy(view_mask))
    assert got.shape == (1, P, H, W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2), atol=ATOL)


@pytest.mark.parametrize("dot_product", [True, False])
def test_gather_reference_matches_jax(rng, dot_product):
    ref, meas, ref_pose, poses = _inputs(rng, [0, 0, 4], [0.05, 0.0, 0.1], views=1)
    K = _K()
    want = jcv.plane_sweep_cost_volume(
        jnp.asarray(ref)[None], jnp.asarray(meas), jnp.asarray(ref_pose)[None],
        jnp.asarray(poses), jnp.asarray(K)[None], 0.25, 20.0, P,
        dot_product=dot_product, plane_chunk=4)
    got = tcv.plane_sweep_cost_volume(
        torch.from_numpy(ref.transpose(2, 0, 1))[None],
        torch.from_numpy(meas.transpose(0, 3, 1, 2)),
        torch.from_numpy(ref_pose)[None], torch.from_numpy(poses),
        torch.from_numpy(K)[None], 0.25, 20.0, P, dot_product=dot_product, plane_chunk=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2), atol=ATOL)


def test_masked_view_mean_matches_jax(rng):
    per_view = rng.randn(2, 3, 4, 5, 6).astype(np.float32)  # (V, B, P, H, W)
    mask = np.array([[1, 0], [1, 1], [0, 0]], np.float32)
    want = jcv._masked_view_mean(jnp.asarray(per_view.transpose(0, 1, 3, 4, 2)),
                                 jnp.asarray(mask))
    got = tcv._masked_view_mean(torch.from_numpy(per_view), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tcv._masked_view_mean(torch.from_numpy(per_view), None).numpy(),
                               per_view.mean(0), rtol=1e-6)


def test_wrapper_validates_inputs():
    ref = torch.zeros(1, H, W, C)
    meas = torch.zeros(1, 2, H, W, C)
    mats = torch.zeros(1, 2, P, 3, 3)
    w = torch.full((1, 2), 0.5)
    with pytest.raises(TypeError):
        tps.plane_sweep_multiview(ref.double(), meas, mats, w)
    with pytest.raises(ValueError):
        tps.plane_sweep_multiview(ref.transpose(1, 2), meas, mats, w)
    with pytest.raises(ValueError):
        tps.plane_sweep_multiview(ref, meas[:, :1], mats, w)
    with pytest.raises(ValueError):
        tps.plane_sweep_multiview(ref[0], meas, mats, w)
