"""The baselines' forwards on static buffers (baselines/steps.py with
graphs=True) against their eager path (graphs=False) on the CPU, at small
sizes: MVDepthNet and GP-MVS at 96x64, DPSNet at 128x128 with 8 labels,
DELTAS at 64x48.

On the CPU the static-buffer body runs without capture, with the card's
semantics: inputs copied into fixed buffers, outputs in buffers that the
next step rewrites, GP-MVS's decoder reading the first step's output
buffers in place. DELTAS is one step, detector to densifier with the DLT
solve between (on the CPU its plain version, ``torch.linalg.svd``). Tolerances: against the eager path
bit for bit (the same operations on the same values); DELTAS on its raw
depth, before the clip to [0.5, 10] m (with seeded weights every clipped
depth is one constant). Planted fault: the new reference frame left out of
its static input must move the depth by more than FAULT_GAP (1e-3, max
|diff| over max |eager|). Seeded weights leave DPSNet's soft-argmin nearly
flat (a whole other frame moves its depth by about 3e-4), so that test
sharpens its two last layers by SHARPEN: the depth then follows the frame.
The rewrites made so that the forwards capture (``inv_ex`` for ``inv``,
the resize indices made on the device, DPSNet's K scaled without a host
tensor) equal the expressions they replace bit for bit, and so does
GP-MVS's Kalman step with OpenBLAS on one thread.
"""

import inspect

import numpy as np
import pytest
import torch

from dvmvs_tpu_torch.apps.graphs import leaves
from dvmvs_tpu_torch.baselines import deltas, dpsnet, gpmvs, mvdepthnet, steps
from dvmvs_tpu_torch.models.layers import seeded_model
from dvmvs_tpu_torch.utils import blas_threads
from tests.test_torch_baselines import randomize_batchnorm, walk
from tests.test_torch_engine import one_torch_thread  # noqa: F401 (autouse fixture)

NAMES = ["mvdepthnet", "gpmvs", "dpsnet", "deltas"]
SIZES = {"mvdepthnet": (96, 64), "gpmvs": (96, 64), "dpsnet": (128, 128), "deltas": (64, 48)}
CLASSES = {"mvdepthnet": mvdepthnet.MVDepthNet, "gpmvs": gpmvs.GPMVS, "dpsnet": dpsnet.DPSNet,
           "deltas": deltas.Deltas}
STEPS = {"mvdepthnet": 1, "gpmvs": 2, "dpsnet": 1, "deltas": 1}  # graphs a predict runs
DPS_LABELS, N_KEYFRAMES, GPMVS_RESET = 8, 3, 2  # GP-MVS resets before its third keyframe
FAULT_GAP, SHARPEN = 1e-3, 30.0


def estimator(name, graphs, sharpen=False):
    """The seeded estimator at its test size on the CPU, random BatchNorm
    (``sharpen``: DPSNet's last two layers by SHARPEN); ``raw``: every depth
    it reads back, before DELTAS's clip."""
    w, h = SIZES[name]
    cls = type(f"Small{CLASSES[name].__name__}", (CLASSES[name],),
               {"image_width": w, "image_height": h})
    est = cls(device="cpu", seed=3, graphs=graphs)
    if name == "dpsnet":
        est.model = seeded_model(dpsnet.DPSNetModel(DPS_LABELS), 3, "cpu")
    randomize_batchnorm(est.model, 4)
    if sharpen and name == "dpsnet":
        with torch.no_grad():
            est.model.classify[2].weight.mul_(SHARPEN)
            est.model.convs[6][0].weight.mul_(SHARPEN)
    est.raw = []
    est._readback = lambda depth, real=est._readback: (est.raw.append(real(depth)),
                                                       est.raw[-1])[1]
    return est


def keyframes(name, n=N_KEYFRAMES):
    """n keyframes (ref image, meas images, ref pose, meas poses) and K of a
    seeded walk: the first with one measurement view, the rest with two."""
    w, h = SIZES[name]
    rs = np.random.RandomState(7)
    images = [rs.randn(h, w, 3).astype(np.float32) for _ in range(n + 2)]
    poses = walk(rs, n + 2)
    out = []
    for i in range(2, n + 2):
        views = [i - 1] if i == 2 else [i - 1, i - 2]
        out.append((images[i], [images[j] for j in views], poses[i], [poses[j] for j in views]))
    K = np.array([[0.8 * w, 0, w / 2], [0, 0.8 * w, h / 2], [0, 0, 1]], np.float32)
    return out, K


def run(est, name, frames):
    """Predict every keyframe (GP-MVS resets before GPMVS_RESET); returns
    the returned depths."""
    kfs, K = frames
    out = []
    for i, kf in enumerate(kfs):
        if name == "gpmvs" and i == GPMVS_RESET:
            est.reset()
        out.append(est.predict(*kf, K))
    return out


def gap(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def eager_runs():
    """name -> (the eager estimator, its returned depths) over the
    keyframes, made on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            est = estimator(name, graphs=False)
            cache[name] = est, run(est, name, keyframes(name))
        return cache[name]

    return get


@pytest.mark.parametrize("name", NAMES)
def test_static_buffers_equal_eager(name, eager_runs):
    """graphs=True (the default) on the CPU equals graphs=False bit for bit
    over the keyframes (GP-MVS across a reset, its Kalman state too), with
    the number of steps the card captures."""
    eager, want = eager_runs(name)
    est = estimator(name, graphs=True)
    assert inspect.signature(CLASSES[name]).parameters["graphs"].default is True
    got = run(est, name, keyframes(name))
    for g, w, raw_g, raw_w in zip(got, want, est.raw, eager.raw):
        assert g.shape == SIZES[name][::-1] and np.isfinite(g).all()
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(raw_g, raw_w)
    assert len(est.step_graphs) == STEPS[name] and not eager.step_graphs
    if name == "gpmvs":
        np.testing.assert_array_equal(est.kalman.M, eager.kalman.M)
        np.testing.assert_array_equal(est.kalman.P, eager.kalman.P)
    spread = max(gap(r, est.raw[0]) for r in est.raw[1:])
    print(f"{name}: {len(got)} keyframes bit-equal to eager; raw depths differ across "
          f"keyframes by up to {spread:.3e}")


@pytest.mark.parametrize("name", NAMES)
def test_predict_returns_a_new_array_each_call(name):
    """Successive predict calls return distinct arrays that the next call
    leaves alone, none of them sharing memory with a step's buffers (on the
    CPU ``.cpu()`` of a buffer is the buffer itself)."""
    est = estimator(name, graphs=True)
    kfs, K = keyframes(name, 2)
    first = est.predict(*kfs[0], K)
    kept = first.copy()
    second = est.predict(*kfs[1], K)
    np.testing.assert_array_equal(first, kept)
    buffers = [t.numpy() for step in est.step_graphs.values()
               for t in leaves((step.outputs, step.args))]
    for depth in (first, second, *est.raw):
        assert not any(np.shares_memory(depth, b) for b in buffers)
    assert not np.shares_memory(first, second)
    assert not np.array_equal(est.raw[0], est.raw[1])


@pytest.mark.parametrize("name", NAMES)
def test_a_reference_frame_left_out_of_its_buffer_is_caught(name, monkeypatch):
    """The planted fault: the second keyframe leaves its reference frame
    out of the static input, so the step reads the first one again; its
    depth must then leave the eager one by more than FAULT_GAP."""
    frames = keyframes(name, 2)
    eager = estimator(name, graphs=False, sharpen=True)
    run(eager, name, frames)
    later = [kf[0] for kf in frames[0][1:]]
    real = steps.GraphedEstimator._fill

    def stale(self, buffer, value):
        if not any(value is frame for frame in later):
            real(self, buffer, value)

    monkeypatch.setattr(steps.GraphedEstimator, "_fill", stale)
    faulty = estimator(name, graphs=True, sharpen=True)
    run(faulty, name, frames)
    assert np.array_equal(faulty.raw[0], eager.raw[0])
    worst = max(gap(f, e) for f, e in zip(faulty.raw[1:], eager.raw[1:]))
    print(f"{name}: stale reference frame moves the depth by {worst:.3e} (must exceed "
          f"{FAULT_GAP:g})")
    assert worst > FAULT_GAP


def _old_fundamental_matrix(rel_pose, K):
    Kinv = torch.linalg.inv(K)
    R, t = rel_pose[:, :3, :3], rel_pose[:, :3, 3]
    zero = torch.zeros_like(t[:, 0])
    t_skew = torch.stack([zero, -t[:, 2], t[:, 1], t[:, 2], zero, -t[:, 0], -t[:, 1], t[:, 0],
                          zero], dim=1).reshape(-1, 3, 3)
    F_ = Kinv.transpose(1, 2) @ (t_skew @ R) @ Kinv
    f22 = F_[:, 2:, 2:]
    return F_ / torch.where(f22 == 0.0, 1.0, f22)


def _old_reproject_at_depth(keypoints, rel_pose, K, depth):
    uv1 = torch.cat([keypoints, torch.ones_like(keypoints[..., :1])], dim=-1)
    A = K @ rel_pose[:, :3, :3] @ torch.linalg.inv(K)
    Kt = (K @ rel_pose[:, :3, 3:4])[..., 0]
    proj = torch.einsum("bij,bnj->bni", A, uv1) + Kt[:, None] / depth
    return proj[..., :2] / proj[..., 2:3]


def test_inverse_rewrites_equal_inv():
    """fundamental_matrix and reproject_at_depth with inv_ex equal the
    torch.linalg.inv expressions bit for bit on random intrinsics and
    poses."""
    rs = np.random.RandomState(11)
    B = 6
    K = np.zeros((B, 3, 3), np.float32)
    K[:, 0, 0], K[:, 1, 1] = rs.uniform(30, 400, B), rs.uniform(30, 400, B)
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = rs.uniform(20, 200, B), rs.uniform(20, 200, B), 1.0
    K[:, 0, 1] = rs.uniform(-1, 1, B)
    rel = np.stack([np.linalg.inv(a) @ b for a, b in zip(walk(rs, B), walk(rs, B, 0.3))])
    K, rel = torch.from_numpy(K), torch.from_numpy(rel.astype(np.float32))
    kp = torch.from_numpy(rs.uniform(0, 300, (B, 50, 2)).astype(np.float32))
    assert torch.equal(deltas.fundamental_matrix(rel, K), _old_fundamental_matrix(rel, K))
    for depth in (deltas.MIN_DEPTH, deltas.MAX_DEPTH, 1.7):
        assert torch.equal(deltas.reproject_at_depth(kp, rel, K, depth),
                           _old_reproject_at_depth(kp, rel, K, depth))


@pytest.mark.parametrize("n_in,n_out", [(8, 15), (10, 20), (15, 30), (30, 60), (60, 120),
                                        (7, 11), (13, 240), (240, 37), (3, 1000)])
def test_nearest_indices_equal_the_host_tables(n_in, n_out):
    """The resize indices made on the device equal the NumPy float32 tables
    they replace, and so does the resize itself on random input."""
    want = np.floor(np.arange(n_out, dtype=np.float32)
                    * np.float32(n_in / n_out)).astype(np.int64)
    got = deltas.nearest_indices(n_out, n_in)
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)
    x = torch.from_numpy(np.random.RandomState(n_in).randn(1, 2, n_in, 5).astype(np.float32))
    assert torch.equal(deltas.nearest_resize_torch(x, n_out, 5),
                       x[:, :, torch.from_numpy(want)])


def test_dpsnet_feature_intrinsics_equal_the_old_product():
    """DPSNet's K at the feature size without a host tensor equals the
    product with the [0.25, 0.25, 1] column it replaces, bit for bit."""
    K = torch.from_numpy(np.random.RandomState(12).uniform(-500, 500, (5, 3, 3))
                         .astype(np.float32))
    old = K * torch.tensor([0.25, 0.25, 1.0], dtype=K.dtype)[None, :, None]
    new = dpsnet.feature_intrinsics(K)
    assert new.is_contiguous() and torch.equal(new, old)


def test_single_threaded_blas_keeps_the_kalman_step_bit_equal():
    """GP-MVS's Kalman step inside single_threaded_blas (as predict runs
    it) equals the step with OpenBLAS's own thread count bit for bit; the
    loaded OpenBLAS pools are on one thread inside and restored after."""
    pools = blas_threads.openblas_pools()
    before = [get() for get, _ in pools]
    rs = np.random.RandomState(13)
    free, single = (gpmvs.KalmanLatentState(512 * 8 * 10, 1.3, 0.7, 0.05) for _ in range(2))
    for dt in (0.0, 0.4, 0.3):
        y = rs.randn(512 * 8 * 10)
        want = free.step(y, dt)
        with blas_threads.single_threaded_blas():
            assert all(get() == 1 for get, _ in pools)
            got = single.step(y, dt)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(single.P, free.P)
    assert [get() for get, _ in pools] == before
