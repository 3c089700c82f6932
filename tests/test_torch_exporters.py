"""The port's dataset exporters (dvmvs_tpu_torch/data/exporters/, no
OpenCV) against the JAX package's (dvmvs_tpu/data/exporters/, OpenCV) on
the same synthetic raw layouts, and the port's read_pfm against the JAX
one.

Tolerance: none. The exported PNGs decode to equal pixels, the training
.npz arrays are equal, poses.txt and K.txt are byte-equal, the NaN-pose
frame is skipped by both train exports, sanity_check agrees, and the point
clouds' PLY files are byte-equal.
"""

import os
import struct

import cv2
import numpy as np
import pytest

from dvmvs_tpu.data.exporters import iclnuim as j_icl
from dvmvs_tpu.data.exporters import point_cloud as j_pc
from dvmvs_tpu.data.exporters import rgbd_scenes as j_rgbd
from dvmvs_tpu.data.exporters import scannet as j_scannet
from dvmvs_tpu.data.exporters import sevenscenes as j_7s
from dvmvs_tpu.data.exporters import tum_rgbd as j_tum
from dvmvs_tpu.data.io import read_pfm as jax_read_pfm
from dvmvs_tpu_torch.data.exporters import iclnuim, point_cloud, rgbd_scenes, scannet
from dvmvs_tpu_torch.data.exporters import sevenscenes, tum_rgbd
from dvmvs_tpu_torch.data.io import read_pfm
from tests.test_exporters import _write_sens


def assert_same_tree(got_root, want_root):
    """Both trees hold the same files; PNGs decode (by cv2) to equal pixels,
    .npz archives hold equal arrays, every other file is byte-equal."""
    got_files = sorted(os.path.relpath(os.path.join(d, f), got_root)
                       for d, _, fs in os.walk(got_root) for f in fs)
    want_files = sorted(os.path.relpath(os.path.join(d, f), want_root)
                        for d, _, fs in os.walk(want_root) for f in fs)
    assert got_files == want_files and got_files
    for rel in got_files:
        got, want = os.path.join(got_root, rel), os.path.join(want_root, rel)
        if rel.endswith(".png"):
            g, w = cv2.imread(got, cv2.IMREAD_UNCHANGED), cv2.imread(want, cv2.IMREAD_UNCHANGED)
            assert g.dtype == w.dtype and np.array_equal(g, w), rel
        elif rel.endswith(".npz"):
            with np.load(got) as g, np.load(want) as w:
                assert sorted(g.files) == sorted(w.files)
                for k in w.files:
                    assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), (rel, k)
        else:
            with open(got, "rb") as g, open(want, "rb") as w:
                assert g.read() == w.read(), rel


@pytest.fixture
def sens_scene(tmp_path):
    """tests/test_exporters.py's .sens (JPEG colour by cv2, a NaN-pose frame),
    with colour larger than depth so registration resamples."""
    scene = tmp_path / "raw" / "scene0000_00"
    scene.mkdir(parents=True)
    _write_sens(str(scene / "scene0000_00.sens"), n_frames=5, color_hw=(20, 28),
                depth_hw=(10, 14), rng=np.random.RandomState(3))
    return scene


@pytest.mark.parametrize("train", [False, True])
def test_scannet_export_equals_jax(sens_scene, tmp_path, train):
    got, want = tmp_path / "port", tmp_path / "jax"
    scannet.export_scene(str(sens_scene), str(got), train=train, frame_skip=1)
    j_scannet.export_scene(str(sens_scene), str(want), train=train, frame_skip=1)
    assert_same_tree(got, want)
    assert scannet.sanity_check(str(got), train) == j_scannet.sanity_check(str(want), train) == []
    poses = np.loadtxt(got / "scene0000_00" / "poses.txt")
    assert len(poses) == (4 if train else 5)  # the NaN-pose frame is dropped in training
    assert np.isfinite(poses).all() == train


def test_scannet_reader_and_registration_equal_jax(sens_scene):
    got = scannet.SensorData(str(sens_scene / "scene0000_00.sens"))
    want = j_scannet.SensorData(str(sens_scene / "scene0000_00.sens"))
    assert (got.num_frames, got.color_compression, got.depth_compression) == \
        (want.num_frames, want.color_compression, want.depth_compression)
    for fg, fw in zip(got.frames, want.frames):
        for a, b in zip(got.decode_frame(fg), want.decode_frame(fw)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    got.color_compression = "png"
    with pytest.raises(ValueError, match="color compression png"):
        got.decode_frame(got.frames[0])


def test_scannet_command_line_and_sanity_check(sens_scene, tmp_path, capsys):
    """main (a spawned pool) exports every scan folder; sanity_check names
    a scene whose counts disagree, as the JAX one does."""
    out = tmp_path / "out"
    assert scannet.main(["--input", str(sens_scene.parent), "--output", str(out),
                         "--workers", "1"]) == []
    assert "finished scene0000_00" in capsys.readouterr().out
    os.remove(out / "scene0000_00" / "depth" / "000001.png")
    assert scannet.sanity_check(str(out), False) == j_scannet.sanity_check(str(out), False) \
        == ["scene0000_00"]


def test_tum_export_equals_jax(tmp_path):
    rs = np.random.RandomState(1)
    seq = "rgbd_dataset_test"
    raw = tmp_path / "raw" / seq
    (raw / "rgb").mkdir(parents=True)
    (raw / "depth").mkdir()
    lines = {"rgb": [], "depth": [], "gt": []}
    for i in range(5):
        t = 100.0 + i * 0.1
        cv2.imwrite(str(raw / "rgb" / f"{t + 0.003:.4f}.png"),
                    rs.randint(0, 255, (8, 10, 3)).astype(np.uint8))
        cv2.imwrite(str(raw / "depth" / f"{t:.4f}.png"),
                    rs.randint(1000, 20000, (8, 10)).astype(np.uint16))
        lines["rgb"].append(f"{t + 0.003:.4f} rgb/{t + 0.003:.4f}.png")
        lines["depth"].append(f"{t:.4f} depth/{t:.4f}.png")
        q = rs.randn(4)
        q /= np.linalg.norm(q)
        lines["gt"].append(f"{t + 0.01:.4f} {0.1 * i:.3f} 0.2 -0.1 " + " ".join(f"{v:.6f}" for v in q))
    for name, key in (("rgb.txt", "rgb"), ("depth.txt", "depth"), ("groundtruth.txt", "gt")):
        (raw / name).write_text("\n".join(lines[key]) + "\n")
    tum_rgbd.export_sequence(seq, str(tmp_path / "raw"), str(tmp_path / "port"))
    j_tum.export_sequence(seq, str(tmp_path / "raw"), str(tmp_path / "jax"))
    assert_same_tree(tmp_path / "port", tmp_path / "jax")


def test_sevenscenes_export_equals_jax(tmp_path):
    rs = np.random.RandomState(2)
    raw, depth_root = tmp_path / "raw" / "chess" / "seq-01", tmp_path / "depth"
    depth_dir = depth_root / "7scenes_chess" / "train" / "depth"
    raw.mkdir(parents=True)
    depth_dir.mkdir(parents=True)
    for i in range(4):
        cv2.imwrite(str(raw / f"frame-{i:06d}.color.png"),
                    rs.randint(0, 255, (6, 9, 3)).astype(np.uint8))
        pose = np.eye(4)
        pose[:3, 3] = rs.randn(3)
        np.savetxt(raw / f"frame-{i:06d}.pose.txt", pose)
        for seq in ("01", "02"):
            cv2.imwrite(str(depth_dir / f"seq{seq}_frame-{i:06d}.pose.depth.tiff.png"),
                        rs.randint(0, 5000, (6, 9)).astype(np.uint16))
    for exporter, color, depth in ((sevenscenes, "port", "port"), (j_7s, "jax", "jax")):
        exporter.export_color_scene(("chess", "01"), str(tmp_path / "raw"), str(tmp_path / color))
        exporter.export_depth_scene(("chess", "01"), str(depth_root), str(tmp_path / depth))
    assert_same_tree(tmp_path / "port", tmp_path / "jax")
    assert len(os.listdir(tmp_path / "port" / "chess-seq-01" / "depth")) == 4


def test_iclnuim_export_equals_jax(tmp_path):
    """ICL-NUIM colour is JPEG: the port decodes it with data/jpeg.py."""
    rs = np.random.RandomState(4)
    raw = tmp_path / "raw"
    (raw / "office1-color").mkdir(parents=True)
    (raw / "office1-depth-clean").mkdir()
    traj = []
    for i in range(3):
        image = cv2.GaussianBlur(rs.randint(0, 255, (24, 32, 3)).astype(np.uint8), (5, 5), 0)
        cv2.imwrite(str(raw / "office1-color" / f"{i}.jpg"), image)
        cv2.imwrite(str(raw / "office1-depth-clean" / f"{i}.png"),
                    rs.randint(0, 8000, (24, 32)).astype(np.uint16))
        pose = np.eye(4)
        pose[:3, 3] = rs.randn(3)
        traj += [f"{i} {i} {i + 1}"] + [" ".join(f"{v:.6f}" for v in row) for row in pose]
    (raw / "office1-traj.txt").write_text("\n".join(traj) + "\n")
    iclnuim.export_scene("office1", str(raw), str(tmp_path / "port"))
    j_icl.export_scene("office1", str(raw), str(tmp_path / "jax"))
    assert_same_tree(tmp_path / "port", tmp_path / "jax")


def test_rgbd_scenes_export_equals_jax(tmp_path):
    rs = np.random.RandomState(5)
    imgs = tmp_path / "raw" / "imgs" / "scene_01"
    imgs.mkdir(parents=True)
    (tmp_path / "raw" / "pc").mkdir()
    rows = []
    for i in range(3):
        cv2.imwrite(str(imgs / f"{i:05d}-color.png"),
                    rs.randint(0, 255, (6, 8, 3)).astype(np.uint8))
        depth = rs.randint(0, 65535, (6, 8)).astype(np.uint16)  # some beyond 50 m (x 1e4)
        cv2.imwrite(str(imgs / f"{i:05d}-depth.png"), depth)
        q = rs.randn(4)
        q /= np.linalg.norm(q)
        rows.append(np.concatenate([q, rs.randn(3)]))
    np.savetxt(tmp_path / "raw" / "pc" / "01.pose", np.array(rows))
    rgbd_scenes.export_scene("01", str(tmp_path / "raw"), str(tmp_path / "port"))
    j_rgbd.export_scene("01", str(tmp_path / "raw"), str(tmp_path / "jax"))
    assert_same_tree(tmp_path / "port", tmp_path / "jax")


def test_point_cloud_equals_jax(sens_scene, tmp_path):
    """On an exported ScanNet scene: the backprojection and the PLY chunks
    (3 frames a chunk, so both a numbered and the last part)."""
    scannet.export_scene(str(sens_scene), str(tmp_path / "data"), train=False, frame_skip=1)
    for frames_per_chunk, stride in ((3, 1), (2, 2)):
        got = point_cloud.build_point_cloud(str(tmp_path / "data"), "scene0000_00",
                                            str(tmp_path / "port"), stride, frames_per_chunk)
        j_pc.build_point_cloud(str(tmp_path / "data"), "scene0000_00", str(tmp_path / "jax"),
                               stride, frames_per_chunk)
        assert len(got) >= 2 and all(os.path.isfile(p) for p in got)
        assert_same_tree(tmp_path / "port", tmp_path / "jax")
    rs = np.random.RandomState(6)
    rgb = rs.randint(0, 255, (4, 6, 3)).astype(np.uint8)
    depth = rs.uniform(0.0, 3.0, (4, 6)).astype(np.float32)
    depth[0, :3] = 0.0
    K = np.array([[6.0, 0, 3.0], [0, 6.0, 2.0], [0, 0, 1]])
    pose = np.eye(4)
    pose[:3, 3] = (1.0, -2.0, 0.5)
    np.testing.assert_array_equal(point_cloud.depth_image_to_point_cloud(rgb, depth, K, pose),
                                  j_pc.depth_image_to_point_cloud(rgb, depth, K, pose))


@pytest.mark.parametrize("header", [b"PF", b"Pf"])
@pytest.mark.parametrize("endian", ["<", ">"])
def test_read_pfm_equals_jax(tmp_path, header, endian):
    rs = np.random.RandomState(7)
    shape = (5, 7, 3) if header == b"PF" else (5, 7)
    data = rs.randn(*shape).astype(np.float32)
    path = str(tmp_path / "img.pfm")
    with open(path, "wb") as f:
        f.write(header + b"\n7 5\n" + (b"-2.5\n" if endian == "<" else b"2.5\n"))
        np.flipud(data).astype(endian + "f").tofile(f)
    got, scale = read_pfm(path)
    want, want_scale = jax_read_pfm(path)
    assert scale == want_scale == 2.5
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, data)


def test_read_pfm_refuses_other_files(tmp_path):
    path = tmp_path / "bad.pfm"
    path.write_bytes(b"P6\n1 1\n255\n" + struct.pack("BBB", 1, 2, 3))
    with pytest.raises(ValueError, match="not a PFM"):
        read_pfm(str(path))
    path.write_bytes(b"Pf\n7\n-1.0\n")
    with pytest.raises(ValueError, match="malformed"):
        read_pfm(str(path))
