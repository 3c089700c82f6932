"""Port parity: geometry, sampling and warping in dvmvs_tpu_torch against the
JAX package on the same numpy inputs (small shapes, float32).

Tolerances: 1e-5 relative for closed-form geometry (the same float32
arithmetic in another order), 1e-5 absolute for sampling and resizing
(the JAX package re-implements the torch primitives with gathers and
interpolation matrices), 1e-4 for the depth warp (its oracle's own bound in
tests/test_warp.py). The forward splat is not continuous (round and
% stride), so it is compared exactly on identical inputs; the soft splat
and its gradients by the limits stated in its test.
"""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import jax
import jax.numpy as jnp

from dvmvs_tpu.ops import geometry as jg
from dvmvs_tpu.ops import sampling as js
from dvmvs_tpu.ops import warp as jw
from dvmvs_tpu_torch.ops import geometry as tg
from dvmvs_tpu_torch.ops import sampling as ts
from dvmvs_tpu_torch.ops import warp as tw
from tests.conftest import random_pose


def _K(h, w, f=40.0):
    return np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_pose_helpers_match_jax(rng):
    a, b = random_pose(rng, 0.3), random_pose(rng, 0.3)
    assert tg.pose_distance_np(a, b) == jg.pose_distance_np(a, b)
    bad = a.copy()
    bad[0, 0] = np.nan
    assert tg.is_pose_available_np(a) and not tg.is_pose_available_np(bad)
    poses = np.stack([a, b]).astype(np.float32)
    np.testing.assert_allclose(tg.inverse_pose(_t(poses)).numpy(),
                               np.asarray(jg.inverse_pose(jnp.asarray(poses))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tg.matmul_f32(_t(poses), _t(poses[::-1])).numpy(),
                               poses @ poses[::-1], rtol=1e-5, atol=1e-6)


def test_warp_grid_and_projection_match_jax(rng):
    H, W = 6, 10
    np.testing.assert_array_equal(tg.make_warp_grid(W, H).numpy(), jg.make_warp_grid(W, H))
    depth = rng.uniform(0.5, 5.0, (2, H, W)).astype(np.float32)
    K = np.stack([_K(H, W), _K(H, W, 33.0)])
    trans = np.stack([random_pose(rng, 0.2), random_pose(rng, 0.2)]).astype(np.float32)

    want = jg.depth_to_3d(jnp.asarray(depth), jnp.asarray(K))
    got = tg.depth_to_3d(_t(depth), _t(K))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)

    want = jg.transform_points(jnp.asarray(trans), want)
    got = tg.transform_points(_t(trans), got)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    pts = np.asarray(want).copy()
    pts[0, 0, 0, 2] = 0.0      # |z| <= 1e-8 stays undivided (kornia guard)
    pts[0, 0, 1, 2] = -1e-9
    want = jg.project_points(jnp.asarray(pts), jnp.asarray(K))
    got = tg.project_points(_t(pts), _t(K))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)

    want = jg.normalize_pixel_coordinates(want, H, W)
    got = tg.normalize_pixel_coordinates(got, H, W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_grid_sample_matches_jax(rng, mode):
    img = rng.randn(2, 7, 9, 3).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 5, 6, 2)).astype(np.float32)
    want = js.grid_sample(jnp.asarray(img), jnp.asarray(grid), mode=mode)
    got = ts.grid_sample(_t(img.transpose(0, 3, 1, 2)), _t(grid), mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2), atol=1e-5)


@pytest.mark.parametrize("align_corners", [True, False])
def test_resizes_match_jax(rng, align_corners):
    x = rng.randn(1, 4, 6, 3).astype(np.float32)
    want = js.resize_bilinear_align_corners(jnp.asarray(x), 8, 12, align_corners)
    got = ts.resize_bilinear_align_corners(_t(x.transpose(0, 3, 1, 2)), 8, 12, align_corners)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2), atol=1e-5)

    y = rng.randn(1, 8, 12, 3).astype(np.float32)
    want = js.resize_nearest(jnp.asarray(y), 4, 6)
    got = ts.resize_nearest(_t(y.transpose(0, 3, 1, 2)), 4, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2))
    want = js.resize_nearest(jnp.asarray(y[..., 0]), 2, 3)
    np.testing.assert_array_equal(ts.resize_nearest(_t(y[..., 0]), 2, 3).numpy(), np.asarray(want))


def test_warp_frame_depth_matches_jax(rng):
    B, C, H, W = 1, 6, 8, 10
    img = rng.randn(B, H, W, C).astype(np.float32)
    depth = rng.uniform(1.0, 5.0, (B, H, W)).astype(np.float32)
    trans = (np.linalg.inv(random_pose(rng, 0.2)) @ random_pose(rng, 0.2)
             ).astype(np.float32)[None]
    K = _K(H, W, 9.0)[None]
    want = jw.warp_frame_depth(jnp.asarray(img), jnp.asarray(depth), jnp.asarray(trans),
                               jnp.asarray(K))
    got = tw.warp_frame_depth(_t(img.transpose(0, 3, 1, 2)), _t(depth), _t(trans), _t(K))
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2), atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_splat_depth_max_strided_matches_jax(seed):
    """Depths drawn so the splat hits several stride sites; JAX and the port
    get identical inputs and must agree exactly."""
    rs = np.random.RandomState(seed)
    H, W, stride = 64, 96, 16
    depth = rs.uniform(1.0, 4.0, (1, H, W)).astype(np.float32)
    prev_pose = np.eye(4, dtype=np.float32)[None]
    cur_pose = np.eye(4, dtype=np.float32)
    cur_pose[:3, 3] = rs.uniform(-0.05, 0.05, 3)
    cur_pose = cur_pose[None]
    K = _K(H, W, 70.0)[None]
    half_K = K * np.array([0.5, 0.5, 1.0], np.float32)[None, :, None]
    args = (depth, prev_pose, cur_pose, K, half_K)
    want = np.asarray(jw.splat_depth_max_strided(
        *[jnp.asarray(a) for a in args], H // 32, W // 32, stride))
    got = tw.splat_depth_max_strided(*[_t(a) for a in args], H // 32, W // 32, stride)
    assert (want > 0).sum() >= 2, "the case must hit stride sites"
    np.testing.assert_array_equal(got.numpy(), want)


def _splat_args(rs, H, W, rotate):
    """Depths, poses and intrinsics of a forward splat: the previous pose the
    identity and the current one translated (rotated too with ``rotate``)."""
    depth = rs.uniform(1.0, 4.0, (2, H, W)).astype(np.float32)
    prev_pose = np.stack([np.eye(4, dtype=np.float32)] * 2)
    cur_pose = np.stack([np.eye(4)] * 2)
    if rotate:  # a few degrees about each axis
        cur_pose[:, :3, :3] = Rotation.from_euler("xyz", rs.uniform(-3, 3, (2, 3)),
                                                  degrees=True).as_matrix()
    cur_pose[:, :3, 3] = rs.uniform(-0.05, 0.05, (2, 3))
    K = np.stack([_K(H, W, 70.0 * W / 96)] * 2)
    half_K = K * np.array([0.5, 0.5, 1.0], np.float32)[None, :, None]
    return depth, prev_pose, cur_pose.astype(np.float32), K, half_K


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_splat_depth_max_matches_jax(seed):
    """The full half-resolution splat, on the strided test's geometry: the
    same landing pixels and the same largest z, exactly."""
    rs = np.random.RandomState(seed)
    H, W = 64, 96
    args = _splat_args(rs, H, W, rotate=False)
    want = np.asarray(jw.splat_depth_max(*[jnp.asarray(a) for a in args], H // 2, W // 2))
    got = tw.splat_depth_max(*[_t(a) for a in args], H // 2, W // 2)
    assert 0.2 < (want > 0).mean() < 1.0, "the case must hit some pixels and miss others"
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_splat_depth_soft_and_its_gradients_match_jax(seed):
    """Values within 1e-5 m (measured 1.4e-6 at depths up to 4 m), and the
    gradients with respect to the depth and both poses within 1e-4 of each
    one's largest |gradient| (measured 5e-5: the two sides invert the pose
    and sum the projection in another order). At a tie with the clip's
    bound both pass half the gradient (jnp.clip is maximum then minimum)."""
    rs = np.random.RandomState(seed)
    H, W = 24, 32
    depth, prev_pose, cur_pose, K, half_K = _splat_args(rs, H, W, rotate=True)
    cot = rs.randn(2, H // 2, W // 2).astype(np.float32)

    def jax_loss(d, p, c):
        out = jw.splat_depth_soft(d, p, c, jnp.asarray(K), jnp.asarray(half_K), H // 2, W // 2)
        return jnp.sum(out * cot), out

    (_, want), grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        *[jnp.asarray(a) for a in (depth, prev_pose, cur_pose)])
    inputs = [_t(a).requires_grad_() for a in (depth, prev_pose, cur_pose)]
    got = tw.splat_depth_soft(*inputs, _t(K), _t(half_K), H // 2, W // 2)
    got_grads = torch.autograd.grad((got * _t(cot)).sum(), inputs)
    assert (np.asarray(want) > 0).mean() > 0.5
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    for g, w in zip(got_grads, grads):
        w = np.asarray(w)
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * np.abs(w).max())
