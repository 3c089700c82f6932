"""The port's DELTAS against the JAX package on the CPU, stage by stage, at
64x48 (the smallest size whose 1/32 trunk and epipolar ROIs still work).

The port's seeded weights, with random BatchNorm statistics, go to Flax
through dvmvs_tpu/utils/baseline_convert.py::convert_deltas; Flax weights
come back bit-equal through the port's utils/baseline_weights.py.

A near-tie at the k-th score can flip a keypoint between torch and XLA, so
each stage after the detector is fed the JAX side's inputs:
  - SuperPoint: scores, descriptors (unit vectors) and skips within 1e-5
    of their largest value (measured at most 6.0e-7);
  - NMS and top-k on identical scores: equal exactly, ties included (a
    stable descending sort against lax.top_k's lower-index rule);
  - triangulation on identical keypoints and descriptors: range mask equal,
    points within 1e-4 of their largest coordinate where the mask is set
    (an SVD per keypoint: LAPACK's float32 solution and XLA's differ in the
    last bits, and the smallest singular vector amplifies them; measured
    2.7e-6);
  - densification on identical sparse depth and skips: within 1e-5 of the
    largest |depth| (measured 4.1e-7);
  - end to end: the share of keypoints the two detectors agree on is
    printed, and must be at least 0.9.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dvmvs_tpu.baselines import deltas as jd
from dvmvs_tpu.utils.baseline_convert import convert_deltas
from dvmvs_tpu_torch.baselines import deltas
from dvmvs_tpu_torch.utils import baseline_weights as bw
from tests.test_torch_baselines import intrinsics, numpy_sd, randomize_batchnorm, walk
from tests.test_torch_engine import one_torch_thread  # noqa: F401 (autouse fixture)

H, W = 48, 64
N_KP = 512
SCORE_TOL, FEATURE_TOL, POINT_TOL, DEPTH_TOL = 1e-5, 1e-5, 1e-4, 1e-5
MIN_KEYPOINT_AGREEMENT = 0.9


def flax_variables(model) -> dict:
    return convert_deltas({"state_dict": numpy_sd(model.superpoint),
                           "state_dict_tri": numpy_sd(model.triangulation),
                           "state_dict_depth": numpy_sd(model.sparse_to_dense)})


def part(variables, name):
    return {k: v[name] for k, v in variables.items()}


def rel_gap(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def case():
    """Port model with random BatchNorm, its Flax variables, and one
    keyframe's inputs (normalised frames, two measurement views of which
    the second is padded, rel poses measurement <- reference, K)."""
    model = deltas.DeltasModel(N_KP)
    deltas.seeded_model(model, 4, "cpu")
    randomize_batchnorm(model, 5)
    rs = np.random.RandomState(6)
    # smooth images: the detector's scores then have distinct maxima
    base = rs.randn(3, H // 4, W // 4, 3).astype(np.float32)
    images = np.kron(base, np.ones((1, 4, 4, 1), np.float32)) + 0.1 * rs.randn(3, H, W, 3)
    images = images.astype(np.float32)
    poses = walk(rs, 3, t_scale=0.1)
    rel = np.stack([np.linalg.inv(p) @ poses[0] for p in (poses[1], poses[1])])
    return {"model": model, "variables": flax_variables(model), "ref": images[0],
            "meas": np.stack([images[1], images[1]]), "rel": rel.astype(np.float32),
            "K": intrinsics(H, W), "mask": np.array([[1.0, 0.0]], np.float32)}


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def jax_stages(case):
    """The JAX side's stage results on the case's inputs."""
    v = case["variables"]
    sp = jax.jit(jd.SuperPoint().apply)
    scores, desc, skips = sp(part(v, "superpoint"), jnp.asarray(case["ref"])[None])
    nms = np.asarray(jd.simple_nms(scores, deltas.NMS_RADIUS))
    kp, kp_scores = jd.top_k_keypoints(jnp.asarray(nms), N_KP, deltas.BORDER)
    ref_d = jd.sample_descriptors(kp, desc)
    meas_descs = jnp.stack([sp(part(v, "superpoint"), jnp.asarray(m)[None])[1]
                            for m in case["meas"]], axis=1)
    tri = jax.jit(jd.TriangulationNet().apply, static_argnums=(7, 8))
    pts3d, range_mask = tri(part(v, "triangulation"), kp, kp_scores, ref_d, meas_descs,
                            jnp.asarray(case["rel"])[None], jnp.asarray(case["K"])[None], H, W,
                            jnp.asarray(case["mask"]))
    full = jax.jit(jd.DeltasModel(n_keypoints=N_KP).apply)
    depth = full(v, jnp.asarray(case["ref"])[None], jnp.asarray(case["meas"])[None],
                 jnp.asarray(case["rel"])[None], jnp.asarray(case["K"])[None],
                 jnp.asarray(case["mask"]))
    out = {"scores": scores, "desc": desc, "skips": skips, "nms": nms, "kp": kp,
           "kp_scores": kp_scores, "ref_d": ref_d, "meas_descs": meas_descs, "pts3d": pts3d,
           "range_mask": range_mask, "depth": depth}
    return jax.tree.map(np.array, out)


def test_superpoint_matches_jax(case, jax_stages):
    with torch.no_grad():
        scores, desc, skips = case["model"].superpoint(nchw(case["ref"][None]))
    gaps = {"scores": rel_gap(scores.numpy(), jax_stages["scores"]),
            "descriptors": rel_gap(desc.permute(0, 2, 3, 1).numpy(), jax_stages["desc"])}
    for name, s in skips.items():
        gaps[name] = rel_gap(s.permute(0, 2, 3, 1).numpy(), jax_stages["skips"][name])
    print("superpoint gaps (of the largest value): "
          + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items()))
    assert gaps.pop("scores") <= SCORE_TOL
    assert max(gaps.values()) <= FEATURE_TOL


def test_nms_and_top_k_equal_jax_on_identical_scores(jax_stages):
    """On the JAX scores: the same NMS mask and the same keypoints in the
    same order (most picks past the surviving maxima are ties at 0, which
    must go to the lower index); then a hand-made plateau of ties."""
    scores = torch.from_numpy(jax_stages["scores"])
    nms = deltas.simple_nms(scores, deltas.NMS_RADIUS)
    np.testing.assert_array_equal(nms.numpy(), jax_stages["nms"])
    kp, vals = deltas.top_k_keypoints(nms, N_KP, deltas.BORDER)
    n_ties = int((jax_stages["kp_scores"] == 0).sum())
    print(f"top-k: {N_KP} keypoints, {N_KP - n_ties} NMS maxima and {n_ties} ties at 0")
    assert n_ties > 0
    np.testing.assert_array_equal(kp.numpy(), jax_stages["kp"])
    np.testing.assert_array_equal(vals.numpy(), jax_stages["kp_scores"])

    plateau = np.zeros((2, 16, 20), np.float32)
    plateau[:, 5:9, 6:12] = 0.5  # a plateau: every pixel equals its max pool
    plateau[1, 2, 3] = 0.7
    plateau[1, 13, 17] = 0.5
    got = deltas.top_k_keypoints(deltas.simple_nms(torch.from_numpy(plateau), 2), 40, 1)
    want = jd.top_k_keypoints(jd.simple_nms(jnp.asarray(plateau), 2), 40, 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_sample_descriptors_and_dlt_match_jax(jax_stages):
    """Descriptor sampling on identical inputs; DLT on a known point seen by
    three cameras recovers it, as the JAX one does, whatever the SVD's sign."""
    kp = torch.from_numpy(jax_stages["kp"])
    got = deltas.sample_descriptors(kp, torch.from_numpy(jax_stages["desc"]).permute(0, 3, 1, 2))
    assert rel_gap(got.numpy(), jax_stages["ref_d"]) <= FEATURE_TOL

    K = np.array([[100.0, 0, 32], [0, 100.0, 24], [0, 0, 1]])
    X = np.array([0.3, -0.2, 2.5])
    projs, pts = [], []
    for tx in (0.0, 0.2, -0.15):
        T = np.eye(4)
        T[0, 3] = tx
        P = K @ T[:3]
        p = P @ np.append(X, 1.0)
        pts.append(p[:2] / p[2])
        projs.append(P)
    projs, pts = np.stack(projs).astype(np.float32), np.stack(pts)[None].astype(np.float32)
    got = deltas.triangulate_dlt(torch.from_numpy(projs)[None], torch.from_numpy(pts)[None],
                                 torch.ones(1, 1, 3))[0, 0].numpy()
    want = np.asarray(jd.triangulate_dlt(jnp.asarray(projs), jnp.asarray(pts),
                                         jnp.ones((1, 3))))[0]
    np.testing.assert_allclose(got, X, atol=1e-3)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_triangulation_matches_jax_on_identical_inputs(case, jax_stages):
    j = jax_stages
    t = torch.from_numpy
    with torch.no_grad():
        pts3d, range_mask = case["model"].triangulation(
            t(j["kp"]), t(j["kp_scores"]), t(j["ref_d"]),
            t(j["meas_descs"]).permute(0, 1, 4, 2, 3), t(case["rel"])[None], t(case["K"])[None],
            H, W, t(case["mask"]))
    np.testing.assert_array_equal(range_mask.numpy(), j["range_mask"])
    m = j["range_mask"]
    gap = rel_gap(pts3d.numpy()[m], j["pts3d"][m])
    print(f"triangulation: {int(m.sum())} of {N_KP} keypoints in range, point gap {gap:.3e} "
          f"of the largest coordinate (limit {POINT_TOL:g})")
    assert m.sum() > 0 and gap <= POINT_TOL


def test_densification_matches_jax_on_identical_inputs(case, jax_stages):
    """The densifier fed the JAX run's sparse depth and image skips."""
    j = jax_stages
    z = np.clip(j["pts3d"][..., 2], 0.0, deltas.MAX_DEPTH)
    valid = j["range_mask"] & (z > deltas.MIN_DEPTH) & (z < deltas.MAX_DEPTH)
    sparse = np.zeros((1, H * W), np.float32)
    lin = (j["kp"][..., 1].astype(int) * W + j["kp"][..., 0].astype(int))[valid]
    sparse[0, lin] = z[valid]
    sparse = sparse.reshape(1, H, W)
    skips = {k: jnp.asarray(v) for k, v in j["skips"].items()}
    want = jax.jit(jd.SparseToDenseNet().apply)(part(case["variables"], "sparse_to_dense"),
                                                jnp.asarray(sparse), jnp.asarray(sparse > 0),
                                                skips)[0]
    with torch.no_grad():
        got = case["model"].sparse_to_dense(
            torch.from_numpy(sparse), None,
            {k: torch.from_numpy(v).permute(0, 3, 1, 2) for k, v in j["skips"].items()})[0]
    gap = rel_gap(got.numpy(), want)
    print(f"densification: {int(valid.sum())} sparse depths, depth gap {gap:.3e} of the "
          f"largest |depth| (limit {DEPTH_TOL:g})")
    assert valid.sum() > 0 and gap <= DEPTH_TOL


def test_deltas_end_to_end_against_jax(case, jax_stages):
    """The whole model: the share of keypoints the two detectors agree on
    (printed, at least MIN_KEYPOINT_AGREEMENT), and with the JAX keypoints
    forced the port's depth equals JAX's within DEPTH_TOL."""
    t = torch.from_numpy
    args = (nchw(case["ref"][None]), t(case["meas"]).permute(0, 3, 1, 2)[None],
            t(case["rel"])[None], t(case["K"])[None], t(case["mask"]))
    with torch.no_grad():
        own = case["model"].stages(*args)
        forced = case["model"].stages(*args, keypoints=t(jax_stages["kp"]))
    kp, want_kp = own["keypoints"].numpy()[0], jax_stages["kp"][0]
    agree = len({tuple(p) for p in kp} & {tuple(p) for p in want_kp}) / N_KP
    gap = rel_gap(forced["depth"].numpy(), jax_stages["depth"])
    print(f"deltas end to end: {agree:.1%} of the keypoints agree, depth gap with the JAX "
          f"keypoints {gap:.3e} (limit {DEPTH_TOL:g})")
    assert agree >= MIN_KEYPOINT_AGREEMENT and gap <= DEPTH_TOL


def test_estimator_predicts_clipped_depth(case):
    """The registered estimator at 64x48: preprocessed frames in, depth in
    [0.5, 10] out, with one measurement view padded."""
    est = type("SmallDeltas", (deltas.Deltas,), {"image_width": W, "image_height": H})(
        device="cpu")
    est.model = case["model"]
    pose0, pose1 = np.eye(4), np.linalg.inv(case["rel"][0].astype(np.float64))
    depth = est.predict(case["ref"], [case["meas"][0]], pose0, [pose1], case["K"])
    assert depth.shape == (H, W) and np.isfinite(depth).all()
    assert depth.min() >= deltas.MIN_DEPTH and depth.max() <= deltas.MAX_DEPTH


def test_flax_weights_round_trip_bit_equal():
    """Flax variables -> the port's state dict (loaded strictly) -> Flax
    again: every array bit-equal, the tree unchanged; the reference's key
    names on the port's side."""
    x = jnp.zeros((1, H, W, 3))
    variables = jax.tree.map(np.asarray, jax.jit(jd.DeltasModel(n_keypoints=16).init)(
        jax.random.PRNGKey(3), x, x[:, None], jnp.eye(4)[None, None], jnp.eye(3)[None]))
    model = deltas.DeltasModel(16)
    model.load_state_dict(bw.deltas_state_dict(variables), strict=True)
    back = flax_variables(model)
    assert jax.tree.structure(back) == jax.tree.structure(variables)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    keys = set(model.state_dict())
    assert {"superpoint.conv1.weight", "superpoint.layer4.2.bn3.running_var",
            "superpoint.layer1.0.downsample.0.weight", "superpoint.convDd.bias",
            "triangulation.bn_match_convD.weight", "sparse_to_dense.layer3.5.conv2.weight",
            "sparse_to_dense.gud_up_proj_layer1.conv1_1.weight",
            "sparse_to_dense.ASPP.daspp_5.bn2.running_mean",
            "sparse_to_dense.conv_final.bias"} <= keys
