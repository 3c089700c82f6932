"""The baselines' path of the port against the JAX package on the CPU:
MVDepthNet, GP-MVS and DPSNet (DELTAS: tests/test_torch_deltas.py), their
weight mapping and the shared evaluation loop.

Weights travel both ways: the port's seeded weights, with random BatchNorm
statistics so eval-mode BatchNorm is exercised, go to Flax through
dvmvs_tpu/utils/baseline_convert.py; Flax weights come back through the
port's utils/baseline_weights.py, bit-equal after the round trip. The JAX
cost volume on the CPU is its gather path, the port's its plain version.

Tolerances (each measured gap is printed):
  - L1 cost volume, C=3 at 64x96: absolute 2e-3 on costs that reach about
    10 (the sum of three |differences| of unit-variance inputs). The two
    sides compute the sample positions in another order (the port from
    per-plane matrices, JAX from a warp grid); measured 2.2e-4. A planted fault (the measurement images swapped against
    their poses, or the dot product in place of L1) must exceed 100x it.
  - Depths: rtol 1e-5, the online slice's limit (random weights keep the
    depth in a narrow band, so a looser limit lets faults through).
  - GP-MVS Kalman state: rtol 1e-5 of its largest entry, the depth's limit.
  - DPSNet at 128x128 with 8 labels: SPP features 1e-4 of their largest
    value (measured 1.4e-6); inverse_warp absolute 1e-4 (measured 1.1e-5);
    both depths rtol 1e-5 (measured 3.1e-7).
"""

import math
import os

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from dvmvs_tpu.apps import run_testing_baseline as jrtb
from dvmvs_tpu.baselines import dpsnet as jdps
from dvmvs_tpu.baselines.gpmvs import GPMVS as JGPMVS
from dvmvs_tpu.baselines.gpmvs import KalmanLatentState as JKalman
from dvmvs_tpu.baselines.gpmvs import gp_batch_smooth as jgp_batch_smooth
from dvmvs_tpu.baselines.mvdepthnet import MVDepthNet as JMVDepthNet
from dvmvs_tpu.ops.cost_volume import cost_volume_fused as jax_cost_volume_fused
from dvmvs_tpu.utils.baseline_convert import (
    convert_dpsnet,
    convert_gplayer,
    convert_mvdepth_decoder,
    convert_mvdepth_encoder,
)
from dvmvs_tpu.utils.results import save_results as jax_save_results
from dvmvs_tpu_torch.apps import run_testing_baseline as rtb
from dvmvs_tpu_torch.apps import run_testing_online
from dvmvs_tpu_torch.apps.engine import InferenceEngine
from dvmvs_tpu_torch.baselines import dpsnet, gpmvs, mvdepthnet
from dvmvs_tpu_torch.baselines.registry import BASELINE_REGISTRY
from dvmvs_tpu_torch.data import preprocess
from dvmvs_tpu_torch.ops.sampling import resize_bilinear_align_corners
from dvmvs_tpu_torch.utils import baseline_weights as bw
from tests.conftest import random_pose
from tests.test_drivers_e2e import png_scene, tiny_cfg  # noqa: F401 (fixtures)
from tests.test_torch_engine import one_torch_thread  # noqa: F401 (autouse fixture)

H, W = 64, 96  # the U-Nets need multiples of 32
CV_ATOL = 2e-3  # measured 1.1e-4 (two views) and 2.2e-4 (padded view)
FAULT_FACTOR = 100.0
RTOL = 1e-5
DPS_SIZE, DPS_LABELS = 128, 8  # the SPP pools need at least 128 px
DPS_RTOL = 1e-4
# inverse_warp, absolute on unit-variance features: the two sides sum the
# projection's products in another order, which moves a sample by about 1e-6
# px; measured 1.1e-5
WARP_ATOL = 1e-4

INDEX = ["00002.png 00001.png 00000.png", "00004.png 00003.png 00002.png",
         "00005.png 00004.png", "TRACKING LOST", "00017.png 00016.png 00015.png",
         "00019.png 00018.png 00017.png"]


def numpy_sd(module: nn.Module) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}


@torch.no_grad()
def randomize_batchnorm(module: nn.Module, seed: int):
    """Seeded statistics and affine parameters for every BatchNorm, so that
    eval-mode BatchNorm tests the mapping of all four tensors."""
    rs = np.random.RandomState(seed)
    for m in module.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            n = m.num_features
            m.running_mean.copy_(torch.from_numpy(0.1 * rs.randn(n).astype(np.float32)))
            m.running_var.copy_(torch.from_numpy((0.5 + rs.rand(n)).astype(np.float32)))
            m.weight.copy_(torch.from_numpy((1.0 + 0.2 * rs.randn(n)).astype(np.float32)))
            m.bias.copy_(torch.from_numpy(0.1 * rs.randn(n).astype(np.float32)))


def small(cls, height=H, width=W):
    """The estimator class at a test size."""
    return type(f"Small{cls.__name__}", (cls,), {"image_height": height, "image_width": width})


def mvdepth_variables(model) -> dict:
    """The port's MVDepthNet/GP-MVS model -> the JAX estimator's variables."""
    out = {"encoder": convert_mvdepth_encoder(numpy_sd(model.encoder)),
           "decoder": convert_mvdepth_decoder(numpy_sd(model.decoder))}
    if hasattr(model, "gplayer"):
        out.update(convert_gplayer(numpy_sd(model.gplayer)))
    return out


def pair(name, seed=0, **kwargs):
    """(port estimator on the CPU with random BatchNorm, JAX estimator with
    the same weights), both at H x W."""
    port_cls = {"mvdepthnet": mvdepthnet.MVDepthNet, "gpmvs": gpmvs.GPMVS}[name]
    jax_cls = {"mvdepthnet": JMVDepthNet, "gpmvs": JGPMVS}[name]
    port = small(port_cls)(n_measurement_frames=2, seed=seed, device="cpu", **kwargs)
    randomize_batchnorm(port.model, seed + 100)
    return port, small(jax_cls)(n_measurement_frames=2, variables=mvdepth_variables(port.model))


def frames(rs, n, height=H, width=W, scale=1.0):
    """n seeded normalised frames (H, W, 3) float32."""
    return [(scale * rs.randn(height, width, 3)).astype(np.float32) for _ in range(n)]


def intrinsics(height=H, width=W, focal=0.8):
    return np.array([[focal * width, 0, width / 2], [0, focal * width, height / 2], [0, 0, 1]],
                    np.float32)


def walk(rs, n, t_scale=0.1):
    """n camera-to-world poses of a jittered walk along x."""
    poses = []
    for i in range(n):
        p = random_pose(rs, 0.02)
        p[:3, :3] = np.linalg.qr(np.eye(3) + 0.03 * rs.randn(3, 3))[0]
        p[:3, :3] *= np.sign(np.linalg.det(p[:3, :3]))
        p[0, 3] += t_scale * i
        poses.append(p)
    return poses


# ------------------------------------------------------------ cost volume
def _sweeps(rs, meas_order=(0, 1), dot_product=False, mask=(1.0, 1.0)):
    """The port's and JAX's L1 sweep (B=1, V=2, C=3) on the same inputs;
    the port's images may be reordered against their poses (a fault)."""
    ref, m0, m1 = frames(rs, 3)
    pose, p0, p1 = walk(rs, 3)
    K = intrinsics()
    meas, poses = np.stack([m0, m1]), np.stack([p0, p1]).astype(np.float32)
    mask = np.asarray([mask], np.float32)
    want = jax_cost_volume_fused(
        jnp.asarray(ref)[None], jnp.asarray(meas)[None], jnp.asarray(pose, jnp.float32)[None],
        jnp.asarray(poses)[None], jnp.asarray(K)[None], mvdepthnet.MIN_DEPTH,
        mvdepthnet.MAX_DEPTH, 64, dot_product=False, view_mask=jnp.asarray(mask))
    t = torch.from_numpy
    with torch.no_grad():
        got = mvdepthnet.cost_volume_fused(
            t(ref).permute(2, 0, 1)[None], t(meas[list(meas_order)]).permute(0, 3, 1, 2)[None],
            t(pose.astype(np.float32))[None], t(poses)[None], t(K)[None], mvdepthnet.MIN_DEPTH,
            mvdepthnet.MAX_DEPTH, 64, dot_product=dot_product, view_mask=t(mask))
    return got[0].numpy(), np.asarray(want[0]).transpose(2, 0, 1)


@pytest.mark.parametrize("mask", [(1.0, 1.0), (1.0, 0.0)], ids=["two_views", "padded_view"])
def test_l1_cost_volume_matches_jax(mask):
    """The L1 sweep at C=3 (the baselines' RGB sweep) equals JAX's within
    CV_ATOL, with two real views and with the second padded under the mask."""
    got, want = _sweeps(np.random.RandomState(3), mask=mask)
    gap = float(np.abs(got - want).max())
    print(f"L1 cost volume {mask}: max |port - jax| {gap:.3e}, max |cost| "
          f"{np.abs(want).max():.3f} (limit {CV_ATOL:g})")
    assert got.shape == (64, H, W) and np.isfinite(got).all()
    assert gap <= CV_ATOL


@pytest.mark.parametrize("fault", ["views_swapped", "dot_product"])
def test_cost_volume_limit_catches_planted_faults(fault):
    """A planted fault breaks the cost volume's limit by far: the check can
    fail, where the seeded depth could not show it."""
    kwargs = {"views_swapped": {"meas_order": (1, 0)}, "dot_product": {"dot_product": True}}
    got, want = _sweeps(np.random.RandomState(3), **kwargs[fault])
    gap = float(np.abs(got - want).max())
    print(f"planted fault {fault}: max |port - jax| {gap:.3e}")
    assert gap > FAULT_FACTOR * CV_ATOL


# ------------------------------------------------------------------ models
def _keyframes(rs, n):
    """n keyframes of (ref image, meas images, ref pose, meas poses): the
    first with one measurement view (padded), the rest with two."""
    poses = walk(rs, n + 2)
    images = frames(rs, n + 2)
    out = []
    for i in range(2, n + 2):
        views = [i - 1] if i == 2 else [i - 1, i - 2]
        out.append((images[i], [images[j] for j in views], poses[i], [poses[j] for j in views]))
    return out


def test_mvdepthnet_matches_jax():
    """Depth and cost volume of the port's MVDepthNet against the JAX
    estimator on the same weights, inputs padded to two views."""
    port, jest = pair("mvdepthnet")
    K = intrinsics()
    worst = 0.0
    for ref, meas, pose, meas_poses in _keyframes(np.random.RandomState(5), 2):
        got = port.predict(ref, meas, pose, meas_poses, K)
        want = np.asarray(jest.predict(ref, meas, pose, meas_poses, K))
        assert got.shape == (H, W) and np.isfinite(got).all()
        worst = max(worst, float(np.max(np.abs(got - want) / want)))
        np.testing.assert_allclose(got, want, rtol=RTOL)
    print(f"mvdepthnet depth: max relative gap {worst:.3e} (limit {RTOL:g}), depth range "
          f"{want.min():.4f}..{want.max():.4f}")


def test_gpmvs_matches_jax_across_keyframes_and_a_reset():
    """GP-MVS over five keyframes with a reset after the second: depth, and
    the Kalman state after each step, against the JAX estimator. The first
    keyframe after each reset measures its distance to its last measurement
    pose; the state restarts at the reset."""
    port, jest = pair("gpmvs", seed=1, gamma2=1.3, ell=0.8, sigma2=0.05)
    assert port.kalman.sigma2 == pytest.approx(jest.kalman.sigma2, rel=1e-12)
    K = intrinsics()
    port.reset()
    jest.reset()
    worst = [0.0, 0.0]
    for i, (ref, meas, pose, meas_poses) in enumerate(_keyframes(np.random.RandomState(6), 5)):
        if i == 2:
            port.reset()
            jest.reset()
            assert not port.kalman.M.any()
        got = port.predict(ref, meas, pose, meas_poses, K)
        want = np.asarray(jest.predict(ref, meas, pose, meas_poses, K))
        np.testing.assert_allclose(got, want, rtol=RTOL)
        # the latent is flattened NCHW here, NHWC in JAX: compare as NHWC
        c, h, w = 512, H // 32, W // 32
        M = port.kalman.M.reshape(2, c, h, w).transpose(0, 2, 3, 1).reshape(2, -1)
        scale = np.abs(jest.kalman.M).max()
        np.testing.assert_allclose(M, jest.kalman.M, rtol=0, atol=RTOL * scale)
        np.testing.assert_allclose(port.kalman.P, jest.kalman.P, rtol=1e-12)
        assert np.array_equal(port.prev_pose, jest.prev_pose)
        worst = [max(worst[0], float(np.max(np.abs(got - want) / want))),
                 max(worst[1], float(np.abs(M - jest.kalman.M).max() / scale))]
    print(f"gpmvs over 5 keyframes with a reset: depth gap {worst[0]:.3e}, Kalman state gap "
          f"{worst[1]:.3e} of its largest value (limit {RTOL:g})")


def test_gp_helpers_match_jax():
    """The host-side GP code (NumPy float64) is the JAX package's."""
    rs = np.random.RandomState(2)
    D = np.abs(np.subtract.outer(rs.rand(5), rs.rand(5)))
    Y = rs.randn(5, 7)
    np.testing.assert_array_equal(gpmvs.gp_batch_smooth(D, Y, 1.3, 0.7, 0.05),
                                  jgp_batch_smooth(D, Y, 1.3, 0.7, 0.05))
    ours, theirs = gpmvs.KalmanLatentState(7, 1.3, 0.7, 0.05), JKalman(7, 1.3, 0.7, 0.05)
    for dt in (0.0, 0.4, 0.3):
        y = rs.randn(7)
        np.testing.assert_array_equal(ours.step(y, dt), theirs.step(y, dt))


# -------------------------------------------------------------- DPSNet
def dpsnet_variables(model) -> dict:
    return convert_dpsnet(numpy_sd(model))


@pytest.fixture(scope="module")
def dps_models():
    """(port DPSNetModel on the CPU with random BatchNorm, Flax model and
    variables with its weights) at DPS_LABELS labels."""
    port = dpsnet.DPSNetModel(DPS_LABELS)
    dpsnet.seeded_model(port, 7, "cpu")
    randomize_batchnorm(port, 8)
    return port, jdps.DPSNetModel(nlabel=DPS_LABELS), dpsnet_variables(port)


def test_spp_features_and_half_pixel_resizes_match_jax(dps_models):
    """SPP features at 128x128 (the 32-pool branch is 1x1 there) against
    Flax; the port's align_corners=False resize against jax.image.resize
    (the branches' and the regression's upsampling) from 1x1, 2x2, 3x5 and a
    label stack."""
    port, jmodel, variables = dps_models
    rs = np.random.RandomState(9)
    x = rs.randn(1, DPS_SIZE, DPS_SIZE, 3).astype(np.float32)
    fv = {k: v["feature_extraction"] for k, v in variables.items()}
    want = np.asarray(jdps.SPPFeatures().apply(fv, jnp.asarray(x))).transpose(0, 3, 1, 2)
    with torch.no_grad():
        got = port.feature_extraction(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    gap = float(np.abs(got - want).max() / np.abs(want).max())
    print(f"SPP features: max gap {gap:.3e} of the largest value (limit {DPS_RTOL:g})")
    assert got.shape == (1, 32, DPS_SIZE // 4, DPS_SIZE // 4) and gap <= DPS_RTOL
    for shape in [(1, 32, 1, 1), (1, 32, 2, 2), (2, 3, 3, 5), (1, DPS_LABELS, 8, 8)]:
        a = rs.randn(*shape).astype(np.float32)
        want = np.asarray(jax.image.resize(jnp.asarray(a), shape[:2] + (32, 40), "bilinear"))
        got = resize_bilinear_align_corners(torch.from_numpy(a), 32, 40,
                                            align_corners=False).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_inverse_warp_matches_jax():
    """inverse_warp against JAX: z clamp, (size - 1) normalisers, out-of-range
    coordinates pushed to 2, label 0's depth mindepth * nlabel / 1e-16."""
    rs = np.random.RandomState(10)
    B, C, h, w = 3, 5, 20, 24
    feat = rs.randn(B, h, w, C).astype(np.float32)
    depth = np.stack([np.full((h, w), 0.5 * 64 / 1e-16), rs.uniform(0.3, 5.0, (h, w)),
                      rs.uniform(0.01, 0.2, (h, w))]).astype(np.float32)
    poses = walk(rs, B + 1, t_scale=0.3)
    rel = np.stack([(np.linalg.inv(p) @ poses[0])[:3] for p in poses[1:]]).astype(np.float32)
    rel[2, :3, :3] = np.diag([-1.0, 1.0, -1.0])  # turned around: points behind the camera
    K = np.stack([intrinsics(h, w)] * B)
    want = np.asarray(jdps.inverse_warp(jnp.asarray(feat), jnp.asarray(depth), jnp.asarray(rel),
                                        jnp.asarray(K)))
    t = torch.from_numpy
    got = dpsnet.inverse_warp(t(feat).permute(0, 3, 1, 2), t(depth), t(rel), t(K))
    got = got.permute(0, 2, 3, 1).numpy()
    print(f"inverse_warp: max gap {np.abs(got - want).max():.3e}, zero samples "
          f"{(want == 0).all(-1).sum()} of {B * h * w}")
    assert (want == 0).all(-1).any() and not (want == 0).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=WARP_ATOL)


def test_dpsnet_matches_jax(dps_models):
    """DPSNet through the port's estimator (one view padded under the mask)
    against the Flax model applied as the JAX estimator does, at 128x128
    with 8 labels: both depths (before and after the context network)."""
    port, jmodel, variables = dps_models
    rs = np.random.RandomState(11)
    est = small(dpsnet.DPSNet, DPS_SIZE, DPS_SIZE)(device="cpu")
    est.model = port  # DPS_LABELS labels
    ref, m0 = frames(rs, 2, DPS_SIZE, DPS_SIZE, scale=0.5)
    pose, p0 = walk(rs, 2, t_scale=0.2)
    K = intrinsics(DPS_SIZE, DPS_SIZE)
    got = est.predict(ref, [m0], pose, [p0], K)
    rel = np.stack([(np.linalg.inv(p) @ pose)[:3].astype(np.float32) for p in (p0, p0)])
    args = (jnp.asarray(ref)[None], jnp.asarray(np.stack([m0, m0]))[None],
            jnp.asarray(rel)[None], jnp.asarray(K)[None], jnp.asarray([[1.0, 0.0]]))
    want0, want = (np.asarray(d[0]) for d in jax.jit(jmodel.apply)(variables, *args))
    t = torch.from_numpy
    with torch.no_grad():
        got0 = port(t(ref).permute(2, 0, 1)[None], t(np.stack([m0, m0])).permute(0, 3, 1, 2)[None],
                    t(rel)[None], t(K)[None], t(np.asarray([[1.0, 0.0]], np.float32)))[0][0]
    for name, g, w in (("depth0", got0.numpy(), want0), ("depth", got, want)):
        gap = float(np.max(np.abs(g - w) / w))
        print(f"dpsnet {name}: max relative gap {gap:.3e} (limit {RTOL:g}), range "
              f"{w.min():.4f}..{w.max():.4f}")
        assert g.shape == (DPS_SIZE, DPS_SIZE) and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=RTOL)


# ----------------------------------------------------------- weight bridge
def _flax_init(module, *args):
    return jax.tree.map(np.asarray, jax.jit(module.init)(jax.random.PRNGKey(3), *args))


def _assert_trees_equal(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("name", ["mvdepthnet", "gpmvs", "dpsnet"])
def test_flax_weights_round_trip_bit_equal(name):
    """Flax variables -> the port's state dict (baseline_weights, loaded
    strictly) -> Flax again (baseline_convert): every array bit-equal; the GP
    hyper-parameters (a log and an exp in float64) within 1e-15."""
    if name == "dpsnet":
        x = jnp.zeros((1, DPS_SIZE, DPS_SIZE, 3))
        variables = _flax_init(jdps.DPSNetModel(nlabel=DPS_LABELS), x, x[:, None],
                               jnp.zeros((1, 1, 3, 4)), jnp.eye(3)[None])
        model = dpsnet.DPSNetModel(DPS_LABELS)
        model.load_state_dict(bw.dpsnet_state_dict(variables), strict=True)
        _assert_trees_equal(dpsnet_variables(model), variables)
        return
    jest = small({"mvdepthnet": JMVDepthNet, "gpmvs": JGPMVS}[name])(n_measurement_frames=2)
    variables = {"encoder": jax.tree.map(np.asarray, getattr(jest, "enc_vars", None)
                                         or jest.model.enc_vars),
                 "decoder": jax.tree.map(np.asarray, getattr(jest, "dec_vars", None)
                                         or jest.model.dec_vars)}
    model = {"mvdepthnet": mvdepthnet.MVDepthNetModel, "gpmvs": gpmvs.GPMVSModel}[name]()
    if name == "gpmvs":
        variables.update(gamma2=1.7, ell=0.3, sigma2=0.07)
        model.load_state_dict(bw.gpmvs_state_dict(variables), strict=True)
        assert model.gplayer.gamma2.item() == math.log(1.7)
    else:
        model.load_state_dict(bw.mvdepthnet_state_dict(variables), strict=True)
    back = mvdepth_variables(model)
    for part in ("encoder", "decoder"):
        _assert_trees_equal(back[part], variables[part])
    for key in gpmvs.HYPERPARAMETERS if name == "gpmvs" else ():
        assert back[key] == pytest.approx(variables[key], rel=1e-15, abs=0)


def test_registry_and_state_dict_names():
    """All four baselines are registered by importing the driver; the
    models' keys are the reference's (spot checks of each naming scheme)."""
    assert set(BASELINE_REGISTRY) >= {"mvdepthnet", "gpmvs", "dpsnet", "deltas"}
    keys = set(mvdepthnet.MVDepthNetModel().state_dict())
    assert {"encoder.conv1.0.weight", "encoder.conv5.4.running_var", "decoder.upconv5.1.weight",
            "decoder.iconv1.1.bias", "decoder.disp1.0.bias"} <= keys
    assert {"gplayer.gamma2", "gplayer.ell", "gplayer.sigma2"} <= set(gpmvs.GPMVSModel().state_dict())
    keys = set(dpsnet.DPSNetModel().state_dict())
    assert {"feature_extraction.firstconv.4.1.running_mean",
            "feature_extraction.layer2.0.downsample.1.weight",
            "feature_extraction.layer1.0.conv1.0.0.weight", "feature_extraction.branch1.1.0.weight",
            "feature_extraction.lastconv.2.weight", "dres4.2.1.bias", "classify.2.weight",
            "convs.6.0.weight"} <= keys
    assert "feature_extraction.layer1.0.downsample.0.weight" not in keys


# ---------------------------------------------------------- evaluation loop
@pytest.fixture(scope="module")
def baseline_scene(png_scene):
    """The PNG scene of tests/test_drivers_e2e.py (96x64 frames, a NaN-pose
    stretch) with an index file holding a TRACKING LOST line."""
    d = os.path.join(png_scene, "indices_torch_baselines")
    os.makedirs(d, exist_ok=True)
    index = os.path.join(d, "keyframe+tinyset+000+nmeas+2")
    with open(index, "w") as f:
        f.write("\n".join(INDEX) + "\n")
    return os.path.join(png_scene, "tinyset", "000"), index


def test_evaluate_scene_baseline_matches_jax(baseline_scene, tmp_path, monkeypatch):
    """evaluate_scene_baseline with GP-MVS over an index with a TRACKING LOST
    line (the Kalman state resets there) against the JAX loop; then main
    with --checkpoint (the port's state dict) and --device cpu writes the
    npz files that the JAX package's save_results writes for the JAX run."""
    scene, index = baseline_scene
    monkeypatch.setattr(gpmvs.GPMVS, "image_width", W)
    monkeypatch.setattr(gpmvs.GPMVS, "image_height", H)
    monkeypatch.setattr(JGPMVS, "image_width", W)
    monkeypatch.setattr(JGPMVS, "image_height", H)
    port, jest = pair("gpmvs", seed=2)
    resets = []
    real_reset = port.reset
    monkeypatch.setattr(port, "reset", lambda: (resets.append(1), real_reset())[1])
    got, got_gts = rtb.evaluate_scene_baseline(port, scene, index)
    want, want_gts = jrtb.evaluate_scene_baseline(jest, scene, index)
    assert len(resets) == 2  # the scene's start and its TRACKING LOST line
    assert len(got) == len(want) == 5 and len(got_gts) == len(want_gts) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL)
    for g, w in zip(got_gts, want_gts):
        np.testing.assert_array_equal(g, w)

    data = tmp_path / "data"
    (data / "indices").mkdir(parents=True)
    os.symlink(os.path.dirname(scene), data / "tinyset")
    os.symlink(index, data / "indices" / os.path.basename(index))
    checkpoint = str(tmp_path / "gpmvs.pt")
    torch.save(port.model.state_dict(), checkpoint)
    rtb.main(["--baseline", "gpmvs", "--data", str(data), "--checkpoint", checkpoint,
              "--output", str(tmp_path / "port"), "--device", "cpu"])
    jax_save_results(want, want_gts, "jax", "000", str(tmp_path / "jax"))
    system = f"keyframe_tinyset_{W}_{H}_2_gpmvs"  # the JAX package's system name
    for kind, rtol in (("predictions", RTOL), ("errors", 1e-4)):
        g = np.load(tmp_path / "port" / f"{system}_{kind}_000.npz")["arr_0"]
        w = np.load(tmp_path / "jax" / f"jax_{kind}_000.npz")["arr_0"]
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-6)


def test_baseline_driver_runs_on_the_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    """--device defaults to cuda and raises without a card, naming the CPU
    option, for every baseline."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "indices").mkdir()
    for name in ("mvdepthnet", "gpmvs", "dpsnet", "deltas"):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            rtb.main(["--baseline", name, "--data", str(tmp_path)])


# ------------------------------------------------- online driver repair
def test_predict_scene_preprocesses_accepted_frames_only(png_scene, tiny_cfg, monkeypatch):
    """predict_scene calls apply_rgb once per frame the keyframe buffer
    accepts (the first frame and every keyframe), not once per frame, and
    its depths equal predict_stream's on frames all preprocessed up front
    (the parent's way) bit for bit."""
    import dvmvs_tpu_torch.utils.keyframe_buffer as tkb
    from dvmvs_tpu_torch.data.io import load_image, load_scene

    monkeypatch.setattr(tkb, "TRACKING_LOST_LIMIT", 3)
    cfg = tiny_cfg
    engine = InferenceEngine("pairnet", cfg, device="cpu", seed=3)
    scene_path = os.path.join(png_scene, "tinyset", "000")
    calls = []
    real = preprocess.PreprocessImage.apply_rgb
    monkeypatch.setattr(preprocess.PreprocessImage, "apply_rgb",
                        lambda self, *a, **k: (calls.append(1), real(self, *a, **k))[1])
    accepted = []
    real_try = tkb.KeyframeBuffer.try_new_keyframe
    monkeypatch.setattr(tkb.KeyframeBuffer, "try_new_keyframe",
                        lambda self, *a: (lambda r: (accepted.append(r in (0, 1)), r)[1])(
                            real_try(self, *a)))
    got, _ = run_testing_online.predict_scene(engine, scene_path, cfg, evaluate=False)
    assert len(calls) == sum(accepted) < len(accepted)
    print(f"apply_rgb calls {len(calls)} for {len(accepted)} frames, "
          f"{sum(accepted)} accepted, {len(got)} keyframes predicted")

    scene = load_scene(scene_path)
    first = load_image(scene.image_filenames[0])
    pre = preprocess.PreprocessImage(K=scene.K, old_width=first.shape[1],
                                     old_height=first.shape[0], new_width=cfg.image_width,
                                     new_height=cfg.image_height,
                                     distortion_crop=cfg.distortion_crop,
                                     perform_crop=cfg.perform_crop)
    all_frames = [real(pre, load_image(f), run_testing_online.SCALE_RGB,
                       run_testing_online.MEAN_RGB, run_testing_online.STD_RGB)
                  for f in scene.image_filenames[:len(scene.poses)]]
    want, _ = run_testing_online.predict_stream(
        engine, all_frames, scene.poses, pre.get_updated_intrinsics().astype(np.float32), cfg)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
