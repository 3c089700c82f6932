"""The port's DELTAS estimator against the benchmark's plain PyTorch
reference (benchmark/reference/deltas.py) on the CPU, at
tests/test_torch_deltas.py's 64x48 with 512 keypoints, on one seeded state
dict with random BatchNorm statistics (the reference keeps the port's
state-dict names, so it loads strictly).

Each keyframe's ``predict`` (eager and on static buffers) is held to the
reference's forward of the same inputs, through the estimator's
``outputs`` (raw depth, keypoints, points):

  - scores after NMS (the port's model on the same frame): within
    SCORE_TOL of the largest, the same float32 operations in the same
    order (measured 0);
  - keypoints: the same set, exactly (the same scores, the same stable
    sort);
  - points where the reference's enters the sparse depth (range-valid, its
    depth strictly inside 0.5-10 m): within POINT_TOL of their largest
    coordinate; the port solves its systems in float32 on the CPU, the
    reference in float64, and the smallest singular vector amplifies the
    rounding (measured 1.5e-6);
  - raw depth, before the clip: within DEPTH_TOL of the largest |depth|
    (the sparse depth carries the points' rounding; measured 2e-7).

Planted faults that must fail the comparison: the two measurement views
handed each other's relative pose, and the DLT's confidences dropped (every
view weighted 1). The baselines' loop reads the same frames from memory
(``assets``) as from the scene folder's PNGs, and then opens no file.
"""

import os

import numpy as np
import pytest
import torch

from benchmark.reference import deltas as reference
from dvmvs_tpu_torch.apps import run_testing_baseline as rtb
from dvmvs_tpu_torch.baselines import deltas, steps
from dvmvs_tpu_torch.data.io import write_png
from dvmvs_tpu_torch.utils.precision import ieee_float32

H, W = 48, 64
SIZES = {"image_trunk_width": 64, "densifier_width": 16, "descriptor_dim": 128,
         "n_keypoints": deltas.N_KEYPOINTS, "nms_radius": deltas.NMS_RADIUS,
         "border": deltas.BORDER, "out_length": deltas.OUT_LENGTH,
         "dist_ortho": deltas.DIST_ORTHO, "min_depth": deltas.MIN_DEPTH,
         "max_depth": deltas.MAX_DEPTH}
SCORE_TOL, POINT_TOL, DEPTH_TOL = 1e-6, 2e-5, 1e-5
N_KEYFRAMES = 3


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class SmallDeltas(deltas.Deltas):
    image_width, image_height = W, H


@torch.no_grad()
def random_batchnorm(model, seed: int):
    rs = np.random.RandomState(seed)
    for m in model.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            n = m.num_features
            m.running_mean.copy_(torch.from_numpy(0.1 * rs.randn(n).astype(np.float32)))
            m.running_var.copy_(torch.from_numpy((0.5 + rs.rand(n)).astype(np.float32)))
            m.weight.copy_(torch.from_numpy((1.0 + 0.2 * rs.randn(n)).astype(np.float32)))
            m.bias.copy_(torch.from_numpy(0.1 * rs.randn(n).astype(np.float32)))


def estimator(graphs: bool):
    est = SmallDeltas(seed=4, device="cpu", graphs=graphs)
    random_batchnorm(est.model, 5)
    return est


@pytest.fixture(scope="module")
def ref_model():
    model = reference.build(SIZES).eval()
    model.load_state_dict(estimator(False).model.state_dict(), strict=True)
    return model


def walk(rs, n):
    """n camera-to-world poses, 0.1 m apart along x, slightly rotated."""
    poses = []
    for i in range(n):
        p = np.eye(4)
        p[:3, :3] = np.linalg.qr(np.eye(3) + 0.03 * rs.randn(3, 3))[0]
        p[:3, :3] *= np.sign(np.linalg.det(p[:3, :3]))
        p[:3, 3] = (0.1 * i, 0.02 * rs.randn(), 0.02 * rs.randn())
        poses.append(p)
    return poses


def keyframes():
    """N_KEYFRAMES keyframes (ref frame, meas frames, ref pose, meas poses)
    of a seeded walk, the first with one measurement view, and K. Smooth
    frames, so the detector's maxima are distinct."""
    rs = np.random.RandomState(6)
    n = N_KEYFRAMES + 2
    base = rs.randn(n, H // 4, W // 4, 3).astype(np.float32)
    images = np.kron(base, np.ones((1, 4, 4, 1), np.float32)) + 0.1 * rs.randn(n, H, W, 3)
    images = images.astype(np.float32)
    poses = walk(rs, n)
    out = []
    for i in range(2, n):
        views = [i - 1] if i == 2 else [i - 1, i - 2]
        out.append((images[i], [images[j] for j in views], poses[i], [poses[j] for j in views]))
    K = np.array([[0.8 * W, 0, W / 2], [0, 0.8 * W, H / 2], [0, 0, 1]], np.float32)
    return out, K


def reference_args(kf, K):
    """The reference's arguments of a keyframe, views padded as the port
    pads them."""
    host = steps.relative_inputs(2, *kf, K)
    t = torch.from_numpy
    return (t(host["ref"]).permute(2, 0, 1)[None], t(host["meas"]).permute(0, 3, 1, 2)[None],
            t(host["rel"].astype(np.float32))[None], t(K)[None], t(host["mask"]))


def gaps(est, ref_model) -> list:
    """Per keyframe: (score gap or None, keypoints equal as sets, point gap,
    depth gap) of the estimator's predict against the reference."""
    kfs, K = keyframes()
    out = []
    for kf in kfs:
        est.predict(*kf, K)
        got = {k: v.clone() for k, v in est.outputs.items()}
        args = reference_args(kf, K)
        want = ref_model.stages(*args)
        score = None
        if not est.graphs:
            with torch.inference_mode(), ieee_float32():
                scores = est.model.stages(*est.inputs(*kf, K))["scores"]
            score = float((scores - want["scores"]).abs().max() / want["scores"].abs().max())
        same = ({tuple(p) for p in got["keypoints"][0].tolist()}
                == {tuple(p) for p in want["keypoints"][0].tolist()})
        held = ref_model.stages(*args, keypoints=got["keypoints"])
        z = held["points3d"][0, :, 2]
        used = held["range_mask"][0] & (z > deltas.MIN_DEPTH) & (z < deltas.MAX_DEPTH)
        assert int(used.sum()) > 50
        p, q = got["points3d"][0][used].double(), held["points3d"][0][used]
        point = float((p - q).abs().max() / q.abs().max())
        depth = float((got["depth"] - held["depth"]).abs().max() / held["depth"].abs().max())
        out.append((score, same, point, depth))
    return out


@pytest.mark.parametrize("graphs", [False, True], ids=["eager", "graphed"])
def test_the_port_holds_to_the_plain_reference(graphs, ref_model):
    readings = gaps(estimator(graphs), ref_model)
    print(f"graphs={graphs}: (score gap, keypoints equal, point gap, depth gap) {readings}")
    for score, same, point, depth in readings:
        assert score is None or score <= SCORE_TOL
        assert same
        assert point <= POINT_TOL and depth <= DEPTH_TOL


def swapped_poses(real):
    def relative_inputs(*args, **kwargs):
        host = real(*args, **kwargs)
        return {**host, "rel": host["rel"][::-1].copy()}
    return relative_inputs


def dropped_confidences(real):
    return lambda proj, points, confidences: real(proj, points, torch.ones_like(confidences))


@pytest.mark.parametrize("owner, name, fault", [
    (deltas, "relative_inputs", swapped_poses),
    (deltas, "dlt_system", dropped_confidences)], ids=["poses_swapped", "confidences_dropped"])
def test_a_planted_fault_fails_the_comparison(owner, name, fault, ref_model, monkeypatch):
    monkeypatch.setattr(owner, name, fault(getattr(owner, name)))
    readings = gaps(estimator(True), ref_model)
    print(f"{name} planted: (score gap, keypoints equal, point gap, depth gap) {readings}")
    assert any(point > POINT_TOL or depth > DEPTH_TOL for _, _, point, depth in readings)


MEAN = np.asarray(SmallDeltas.mean_rgb)
STD = np.asarray(SmallDeltas.std_rgb)


class MemoryAssets:
    """Frames normalised here from the same uint8 pixels, by name."""

    depth_filenames = None

    def __init__(self, rgb, poses, K):
        self.rgb, self.poses, self.updated_K = rgb, poses, K

    def image(self, name):
        return (self.rgb[int(name[:6])] / SmallDeltas.scale_rgb - MEAN) / STD

    def pose(self, name):
        return self.poses[int(name[:6])]


def test_evaluate_scene_baseline_reads_assets_as_the_files(tmp_path, monkeypatch):
    """The scene's frames as PNGs at the estimator's size, or in memory:
    the same predictions bit for bit over an index with a TRACKING LOST
    line (two resets), and with assets no file is opened."""
    rs = np.random.RandomState(8)
    n = 5
    rgb = rs.randint(0, 256, (n, H, W, 3), dtype=np.uint8)
    poses = walk(rs, n)
    K = np.array([[0.8 * W, 0, W / 2], [0, 0.8 * W, H / 2], [0, 0, 1]], np.float32)
    scene = tmp_path / "scene"
    (scene / "images").mkdir(parents=True)
    for i in range(n):
        write_png(str(scene / "images" / f"{i:06d}.png"), rgb[i])
    np.savetxt(scene / "K.txt", K)
    np.savetxt(scene / "poses.txt", np.stack(poses).reshape(n, 16))
    index = tmp_path / "keyframe+test+scene+nmeas+2"
    index.write_text("000002.png 000001.png 000000.png\nTRACKING LOST\n"
                     "000004.png 000003.png\n")

    est = estimator(True)
    resets = []
    real_reset = est.reset
    monkeypatch.setattr(est, "reset", lambda: (resets.append(1), real_reset())[1])
    from_files, gts = rtb.evaluate_scene_baseline(est, str(scene), str(index), evaluate=False)
    assert gts is None and len(from_files) == 2 and len(resets) == 2

    def no_file(*args, **kwargs):
        raise AssertionError("a file was read")

    monkeypatch.setattr(rtb, "load_image", no_file)
    monkeypatch.setattr(np, "loadtxt", no_file)
    assets = MemoryAssets(rgb, np.stack(poses), K)
    from_memory, _ = rtb.evaluate_scene_baseline(est, "", str(index), assets=assets)
    assert len(resets) == 4
    for a, b in zip(from_files, from_memory):
        np.testing.assert_array_equal(a, b)
    assert os.path.isdir(scene)
