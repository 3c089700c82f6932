"""TSDF reconstruction of the port (ops/tsdf.py, utils/native.py,
apps/run_tsdf.py, run_testing_online.LiveTSDF) against the NumPy oracle of
tests/test_tsdf.py and the JAX package.

Tolerances: colour and weight volumes exactly equal, tsdf within atol 1e-5
(tests/test_tsdf.py's limits for the JAX integrate: the oracle runs in
float64, the integrate in float32). Against the JAX integrate the same
limits: both round the pixel of a voxel with C roundf from the same float32
operations. The native library is built into a temporary build root.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dvmvs_tpu.apps import run_tsdf as jrun_tsdf
from dvmvs_tpu.apps.engine import InferenceEngine as JEngine
from dvmvs_tpu.apps.run_testing_online import LiveTSDF as JLiveTSDF
from dvmvs_tpu.apps.run_testing_online import predict_scene as jax_predict_scene
from dvmvs_tpu.ops import tsdf as jtsdf
from dvmvs_tpu_torch.apps import run_tsdf
from dvmvs_tpu_torch.apps.engine import InferenceEngine
from dvmvs_tpu_torch.apps.run_testing_online import LiveTSDF, predict_scene
from dvmvs_tpu_torch.ops import tsdf
from dvmvs_tpu_torch.utils import native
from tests.test_drivers_e2e import png_scene, tiny_cfg  # noqa: F401 (fixtures)
from tests.test_torch_engine import one_torch_thread  # noqa: F401 (autouse fixture)
from tests.test_tsdf import numpy_integrate_oracle

H, W = 12, 16
K = np.array([[14.0, 0, W / 2], [0, 14.0, H / 2], [0, 0, 1]], np.float32)
BOUNDS = np.array([[-0.5, 0.5], [-0.5, 0.5], [0.5, 1.5]])


@pytest.fixture(autouse=True)
def build_root(tmp_path_factory, monkeypatch):
    """The native library goes to a temporary build root, never build/."""
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path_factory.getbasetemp() / "native")


def _frames(n, seed=0):
    rs = np.random.RandomState(seed)
    poses, depths, images = [], [], []
    for i in range(n):
        pose = np.eye(4, dtype=np.float32)
        pose[0, 3] = 0.05 * i
        pose[2, 3] = -1.0  # 1 m behind the origin, looking at +z
        poses.append(pose)
        d = rs.uniform(1.0, 3.0, (H, W)).astype(np.float32)
        d[0, :] = 0.0  # an invalid row
        depths.append(d)
        images.append(rs.randint(0, 255, (H, W, 3)).astype(np.uint8))
    return poses, depths, images


def test_integrate_matches_the_oracle_and_jax():
    poses, depths, images = _frames(3)
    vol = tsdf.TSDFVolume(BOUNDS, voxel_size=0.2, device="cpu")
    jvol = jtsdf.TSDFVolume(BOUNDS, voxel_size=0.2)
    want_t = np.ones(tuple(vol.vol_dim), np.float32)
    want_w, want_c = np.zeros_like(want_t), np.zeros_like(want_t)
    for d, img, pose in zip(depths, images, poses):
        vol.integrate(img, d, K, pose)
        jvol.integrate(img, d, K, pose)
        want_t, want_w, want_c = numpy_integrate_oracle(
            want_t, want_w, want_c, vol.vol_origin, vol.voxel_size, tsdf.pack_color(img), d, K,
            pose, 1.0, vol.trunc_margin)
    got_t, got_c = vol.get_volume()
    np.testing.assert_allclose(got_t, want_t, atol=1e-5)
    np.testing.assert_array_equal(vol.weight.numpy().reshape(want_w.shape), want_w)
    np.testing.assert_array_equal(got_c, want_c)
    assert (want_w > 0).any() and (want_c > 0).any()

    jt, jc = jvol.get_volume()
    np.testing.assert_allclose(got_t, jt, atol=1e-5)
    np.testing.assert_array_equal(vol.weight.numpy(), np.asarray(jvol.weight))
    np.testing.assert_array_equal(got_c, jc)


def test_integrate_step_matches_jax_on_a_tilted_camera():
    """integrate_step alone on a rotated camera, a packed colour image and a
    partly filled volume, against the JAX step."""
    rs = np.random.RandomState(4)
    dims = (7, 6, 5)
    n = int(np.prod(dims))
    c, s = np.cos(0.3), np.sin(0.3)
    pose = np.array([[c, 0, s, 0.1], [0, 1, 0, -0.05], [-s, 0, c, -1.2], [0, 0, 0, 1]],
                    np.float32)
    vols = [rs.uniform(-1, 1, n).astype(np.float32), rs.randint(0, 3, n).astype(np.float32),
            tsdf.pack_color(rs.randint(0, 256, (n, 1, 3))).reshape(-1).astype(np.float32)]
    depth = rs.uniform(0.8, 2.5, (H, W)).astype(np.float32)
    packed = tsdf.pack_color(rs.randint(0, 256, (H, W, 3))).astype(np.float32)
    origin = np.array([-0.6, -0.5, 0.3], np.float32)
    args = (origin, 0.2, packed, depth, K, pose, 1.0, 0.6)
    got = tsdf.integrate_step(*[torch.from_numpy(v) for v in vols], torch.from_numpy(origin),
                              0.2, torch.from_numpy(packed), torch.from_numpy(depth),
                              torch.from_numpy(K), torch.from_numpy(pose), 1.0, 0.6, dims)
    want = jtsdf.integrate_step(*[jnp.asarray(v) for v in vols],
                                *[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                  for a in args], im_h=H, im_w=W, vol_dim=dims)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert (got[1].numpy() != vols[1]).any()


def test_integrate_frames_equals_sequential_and_pack_round_trip():
    poses, depths, images = _frames(5, seed=1)
    seq = tsdf.TSDFVolume(BOUNDS, voxel_size=0.2, device="cpu")
    for img, d, p in zip(images, depths, poses):
        seq.integrate(img, d, K, p)
    frames = tsdf.TSDFVolume(BOUNDS, voxel_size=0.2, device="cpu")
    frames.integrate_frames(images, depths, K, poses)
    for a, b in ((frames.tsdf, seq.tsdf), (frames.weight, seq.weight),
                 (frames.color, seq.color)):
        assert torch.equal(a, b)
    img = np.random.RandomState(2).randint(0, 256, (4, 5, 3)).astype(np.uint8)
    np.testing.assert_array_equal(tsdf.unpack_color(tsdf.pack_color(img)), img)
    np.testing.assert_array_equal(tsdf.pack_color(img), jtsdf.pack_color(img))


def test_volume_bounds_match_jax():
    rs = np.random.RandomState(3)
    depths = [rs.uniform(0.5, 4.0, (8, 10)).astype(np.float32) for _ in range(3)]
    Kb = np.array([[10.0, 0, 5], [0, 10.0, 4], [0, 0, 1]])
    poses = [np.eye(4) for _ in range(3)]
    for i, p in enumerate(poses):
        p[:3, 3] = [0.3 * i, -0.1 * i, 0.05]
    np.testing.assert_array_equal(tsdf.calculate_volume_bounds(depths, poses, Kb),
                                  jtsdf.calculate_volume_bounds(depths, poses, Kb))
    np.testing.assert_array_equal(tsdf.get_view_frustum(depths[0], Kb, poses[1]),
                                  jtsdf.get_view_frustum(depths[0], Kb, poses[1]))


def test_volume_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tsdf.TSDFVolume(BOUNDS, voxel_size=0.2)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        LiveTSDF().integrate(np.zeros((H, W, 3)), np.ones((H, W), np.float32), K, np.eye(4))


def test_marching_cubes_sphere_and_ply_writers(tmp_path):
    """tests/test_tsdf.py's checks through the port's own build."""
    n = 24
    g = np.arange(n) - (n - 1) / 2.0
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    verts, faces, norms = native.marching_cubes(
        (np.sqrt(X ** 2 + Y ** 2 + Z ** 2) - 8.0).astype(np.float32), level=0.0)
    assert len(verts) > 100 and len(faces) > 100
    r = np.linalg.norm(verts - (n - 1) / 2.0, axis=1)
    np.testing.assert_allclose(r, 8.0, atol=0.2)
    assert np.mean(np.sum(norms * (verts - (n - 1) / 2.0) / r[:, None], axis=1)) > 0.95
    assert faces.min() >= 0 and faces.max() < len(verts)
    lib = native.build()
    assert lib.parent.parent == native.BUILD_ROOT and lib.is_file()
    assert os.path.realpath(lib) != os.path.realpath(native.NATIVE / "libdvmvs_native.so")

    rs = np.random.RandomState(0)
    v = rs.rand(5, 3).astype(np.float32)
    colors = rs.randint(0, 255, (5, 3)).astype(np.uint8)
    native.write_mesh_ply(str(tmp_path / "mesh.ply"), v, np.array([[0, 1, 2], [2, 3, 4]]),
                          np.tile([0, 0, 1.0], (5, 1)), colors)
    content = (tmp_path / "mesh.ply").read_bytes().split(b"end_header\n")[0].decode()
    assert "element vertex 5" in content and "element face 2" in content
    native.write_points_ply(str(tmp_path / "pc.ply"), v, colors)
    assert b"element vertex 5" in (tmp_path / "pc.ply").read_bytes()


def test_native_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    cxx = tmp_path / "g++"
    cxx.write_text("#!/bin/sh\ncase \"$1\" in -dump*) echo 0;; *) echo 'mc.cpp: error: "
                   "boom' >&2; exit 1;; esac\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(native.NativeBuildError, match="boom"):
        native.build()
    assert not any((tmp_path / "build").rglob("*.so"))


def test_run_tsdf_matches_jax(png_scene, tiny_cfg, tmp_path):
    """load_keyframe_data + reconstruct on the same saved predictions (a
    TRACKING LOST line in the index): the same frames, the same volume and
    the same mesh vertex count."""
    scene = os.path.join(png_scene, "tinyset", "000")
    index_file = str(tmp_path / "keyframe+tinyset+000+nmeas+2")
    with open(index_file, "w") as f:
        f.write("00002.png 00001.png 00000.png\n00004.png 00003.png 00002.png\n"
                "TRACKING LOST\n00008.png 00007.png 00006.png\n")
    rs = np.random.RandomState(5)
    # predictions at half the frame size: load_keyframe_data resizes the frames
    saved = rs.uniform(1.5, 3.5, (3, 32, 48)).astype(np.float32)
    got = run_tsdf.load_keyframe_data(scene, index_file, saved, 3.0, "tinyset")
    want = jrun_tsdf.load_keyframe_data(scene, index_file, saved, 3.0, "tinyset")
    for g, w in zip(got[:3], want[:3]):
        assert len(g) == len(w) == 3
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    for g, w in zip(got[3:], want[3:]):
        np.testing.assert_array_equal(g, w)

    poses, images, depths, scaled_K = got[:4]
    vol = run_tsdf.reconstruct(poses, images, depths, scaled_K, voxel_size=0.35,
                               mesh_path=str(tmp_path / "port_complete.ply"), device="cpu")
    jvol = jrun_tsdf.reconstruct(poses, images, depths, scaled_K, voxel_size=0.35,
                                 mesh_path=str(tmp_path / "jax_complete.ply"))
    np.testing.assert_allclose(vol.get_volume()[0], jvol.get_volume()[0], atol=1e-5)
    np.testing.assert_array_equal(vol.get_volume()[1], jvol.get_volume()[1])
    np.testing.assert_array_equal(vol.weight.numpy(), np.asarray(jvol.weight))
    assert (vol.tsdf.numpy() < 0.999).any()
    assert len(vol.get_mesh()[0]) == len(jvol.get_mesh()[0]) > 0
    assert os.path.isfile(tmp_path / "port_complete.ply")

    # main on a data folder (indices/ beside the dataset) and the saved npz
    data = tmp_path / "data"
    (data / "indices").mkdir(parents=True)
    os.symlink(os.path.join(png_scene, "tinyset"), data / "tinyset")
    os.replace(index_file, data / "indices" / os.path.basename(index_file))
    np.savez_compressed(tmp_path / "predictions.npz", saved)
    run_tsdf.main(["--predictions", str(tmp_path / "predictions.npz"), "--data", str(data),
                   "--dataset-name", "tinyset", "--scene", "000", "--voxel-size", "0.35",
                   "--output", str(tmp_path / "recon"), "--device", "cpu"])
    assert any(f.endswith("_PREDICTION_tinyset_000_complete.ply")
               for f in os.listdir(tmp_path / "recon"))


@pytest.fixture(scope="module")
def pairnet_engines(tiny_cfg):
    import jax

    jengine = JEngine("pairnet", tiny_cfg)
    return jengine, InferenceEngine("pairnet", tiny_cfg, device="cpu",
                                    variables=jax.tree.map(np.asarray, jengine.variables))


# explicit bounds, then automatic ones around the first keyframe. Voxel sizes
# and bounds off the scene's 0.12 m grid of camera positions: on a regular
# grid some voxel centres project exactly onto a pixel boundary (x.5), and
# XLA's fused multiply-adds and torch's separately rounded products may then
# take neighbouring pixels
LIVE_CASES = [(0.37, 20.0, np.array([[-2.013, 6.0], [-1.987, 2.0], [0.011, 4.0]])),
              (0.4373, 2.3137, None)]


@pytest.mark.parametrize("voxel,max_depth,bounds", LIVE_CASES)
def test_live_tsdf_matches_jax(png_scene, tiny_cfg, pairnet_engines, tmp_path, voxel, max_depth,
                               bounds):
    """predict_scene with LiveTSDF, the same weights on both sides: each
    side fuses its own depths (within rtol 1e-5 of each other) and colours."""
    scene = os.path.join(png_scene, "tinyset", "000")
    jengine, engine = pairnet_engines
    live = LiveTSDF(voxel_size=voxel, max_depth=max_depth, bounds=bounds, device="cpu")
    jlive = JLiveTSDF(voxel_size=voxel, max_depth=max_depth, bounds=bounds)
    got, _ = predict_scene(engine, scene, tiny_cfg, evaluate=False, max_frames=4,
                           live_tsdf=live)
    want, _ = jax_predict_scene(jengine, scene, tiny_cfg, evaluate=False, max_frames=4,
                                live_tsdf=jlive)
    assert live.n_integrated == jlive.n_integrated == len(got) == len(want) == 4
    np.testing.assert_array_equal(live.volume.vol_bnds, jlive.volume.vol_bnds)
    np.testing.assert_allclose(live.volume.get_volume()[0], jlive.volume.get_volume()[0],
                               atol=1e-5)
    np.testing.assert_array_equal(live.volume.get_volume()[1], jlive.volume.get_volume()[1])
    np.testing.assert_array_equal(live.volume.weight.numpy(), np.asarray(jlive.volume.weight))
    assert (live.volume.weight.numpy() > 0).sum() > 100
    if bounds is not None:
        live.save_mesh(str(tmp_path / "live_complete.ply"))
        assert os.path.isfile(tmp_path / "live_complete.ply")
    else:
        ext = live.volume.vol_bnds[:, 1] - live.volume.vol_bnds[:, 0]
        assert (ext >= 2 * max_depth).all()
        assert abs(live.volume.vol_bnds[0, 0] - (0.12 - max_depth - 2 * voxel)) < 0.2
