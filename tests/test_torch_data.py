"""Port parity: dvmvs_tpu_torch.data (crawler, preprocessing, dataset and
input pipeline) against dvmvs_tpu.data on a synthetic corpus written with
scripts/make_synth_scenes.py. The port is a NumPy copy, so samples and
batches must be bit-identical for the same seeds.
"""

import os
import sys

import numpy as np
import pytest
import torch

from dvmvs_tpu.config import TrainConfig
from dvmvs_tpu.data import crawler as jcrawler
from dvmvs_tpu.data import dataset as jdataset
from dvmvs_tpu.data.preprocess import PreprocessImage as JPreprocessImage
from dvmvs_tpu_torch.data import crawler as tcrawler
from dvmvs_tpu_torch.data import dataset as tdataset
from dvmvs_tpu_torch.data.preprocess import PreprocessImage

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
from make_synth_scenes import render_scene, write_train_scene  # noqa: E402

SIZE = 64


def write_corpus(root, n_frames=30, size=SIZE, train=(100, 101), val=(102,)):
    """Training layout: scene_<seed> directories plus train.txt and
    validation.txt."""
    names = {}
    for split, seeds in (("train", train), ("validation", val)):
        names[split] = []
        for seed in seeds:
            K, poses, frames = render_scene(seed, n_frames, size, size)
            write_train_scene(os.path.join(root, f"scene_{seed}"), K, poses, frames)
            names[split].append(f"scene_{seed}")
        with open(os.path.join(root, f"{split}.txt"), "w") as f:
            f.write("\n".join(names[split]) + "\n")
    return str(root)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp("corpus"))


def _cfg(**kw):
    return TrainConfig(image_width=SIZE, image_height=SIZE, data_pipeline_workers=1, **kw)


@pytest.mark.parametrize("length", [2, 3])
def test_crawler_matches_jax(corpus, length):
    scenes = ["scene_100", "scene_101"]
    want = jcrawler.crawl(corpus, scenes, length, seed=3)
    got = tcrawler.crawl(corpus, scenes, length, seed=3)
    assert len(want) > 0 and got == want


def test_crawler_worker_pool_keeps_the_order(corpus):
    scenes = ["scene_100", "scene_101"]
    assert tcrawler.crawl(corpus, scenes, 3, seed=1, num_workers=2) == \
        jcrawler.crawl(corpus, scenes, 3, seed=1)


def _assert_batches_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("split,augment,compact", [
    ("TRAINING", True, False),     # reversal, geometric scale, colour augmentation
    ("VALIDATION", False, False),
    ("TRAINING", True, True),      # uint8 images + float16 depths
])
def test_dataset_and_batches_match_jax(corpus, split, augment, compact):
    kw = dict(geometric_scale_augmentation=augment, seed=7, wire_compact=compact)
    want = jdataset.MVSSequenceDataset(corpus, split, 3, _cfg(), **kw)
    got = tdataset.MVSSequenceDataset(corpus, split, 3, _cfg(), **kw)
    assert len(got) == len(want) > 2
    assert got.samples == want.samples
    for i in range(3):
        _assert_batches_equal(got[i], want[i])
    for g, w in zip(tdataset.batch_iterator(got, 2, shuffle=True, seed=5),
                    jdataset.batch_iterator(want, 2, shuffle=True, seed=5)):
        _assert_batches_equal(g, w)
    if compact:
        assert got[0]["images"].dtype == np.uint8 and got[0]["depths"].dtype == np.float16


def test_identity_size_preprocessing_equals_cv2():
    rs = np.random.RandomState(0)
    K = np.array([[50.0, 0, 31.5], [0, 50.0, 31.5], [0, 0, 1]])
    image = rs.randint(0, 256, (SIZE, SIZE, 3)).astype(np.uint8)
    depth = rs.uniform(0.5, 5.0, (SIZE, SIZE)).astype(np.float32)
    port = PreprocessImage(K, SIZE, SIZE, SIZE, SIZE)
    ref = JPreprocessImage(K, SIZE, SIZE, SIZE, SIZE)
    for got, want in ((port.apply_rgb(image, 1.0, [0.0] * 3, [1.0] * 3, normalize_colors=False),
                       ref.apply_rgb(image, 1.0, [0.0] * 3, [1.0] * 3, normalize_colors=False)),
                      (port.apply_rgb(image, 255.0, [0.4] * 3, [0.2] * 3),
                       ref.apply_rgb(image, 255.0, [0.4] * 3, [0.2] * 3)),
                      (port.apply_depth(depth), ref.apply_depth(depth))):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port.get_updated_intrinsics(), ref.get_updated_intrinsics())


def test_resize_needs_cv2(monkeypatch):
    """Whether the resize needs cv2: it does not. With cv2 unimportable (as
    on a machine without OpenCV) the port gives the JAX package's frames."""
    K = np.array([[50.0, 0, 32.0], [0, 50.0, 32.0], [0, 0, 1]])
    rs = np.random.RandomState(1)
    port = PreprocessImage(K, 2 * SIZE + 6, 2 * SIZE, SIZE, SIZE)
    ref = JPreprocessImage(K, 2 * SIZE + 6, 2 * SIZE, SIZE, SIZE)
    depth = rs.uniform(0.5, 5.0, (2 * SIZE, 2 * SIZE + 6)).astype(np.float32)
    image = rs.randint(0, 256, (2 * SIZE, 2 * SIZE + 6, 3)).astype(np.float32)
    want = (ref.apply_depth(depth), ref.apply_rgb(image, 255.0, [0.4] * 3, [0.2] * 3))
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = (port.apply_depth(depth), port.apply_rgb(image, 255.0, [0.4] * 3, [0.2] * 3))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_device_prefetch_on_cpu_and_early_close(corpus):
    ds = tdataset.MVSSequenceDataset(corpus, "VALIDATION", 3, _cfg(), seed=0)
    host = list(tdataset.batch_iterator(ds, 2, shuffle=False))
    got = list(tdataset.device_prefetch(tdataset.batch_iterator(ds, 2, shuffle=False), "cpu"))
    assert len(got) == len(host) > 1
    for g, h in zip(got, host):
        for k in h:
            assert isinstance(g[k], torch.Tensor)
            np.testing.assert_array_equal(g[k].numpy(), h[k])
    it = tdataset.device_prefetch(tdataset.batch_iterator(ds, 2, shuffle=False), "cpu")
    next(it)
    it.close()  # stops the host thread; must not hang

    def failing():
        yield host[0]
        raise RuntimeError("decode failed")

    with pytest.raises(RuntimeError, match="decode failed"):
        list(tdataset.host_prefetch(failing()))


# --- the synthetic scene and the PNG reader (no OpenCV in the port) ---


@pytest.mark.parametrize("seed", [0, 11])
def test_synthetic_scene_matches_jax(seed):
    """The port's NumPy copy renders bit-identical frames and walks."""
    from dvmvs_tpu.data import synthetic as jsynth
    from dvmvs_tpu_torch.data import synthetic as tsynth

    want_scene, got_scene = jsynth.SynthScene(seed), tsynth.SynthScene(seed)
    want_poses, got_poses = want_scene.trajectory(6), got_scene.trajectory(6)
    np.testing.assert_array_equal(got_poses, want_poses)
    K = tsynth.default_K(SIZE, SIZE)
    np.testing.assert_array_equal(K, jsynth.default_K(SIZE, SIZE))
    for i in (0, 5):
        for got, want in zip(got_scene.render(got_poses[i], K, SIZE, SIZE),
                             want_scene.render(want_poses[i], K, SIZE, SIZE)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def _chunk(kind: bytes, body: bytes) -> bytes:
    import struct
    import zlib

    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode_png(image: np.ndarray, filters, interlace: int = 0) -> bytes:
    """A PNG of ``image`` ((H, W) gray or (H, W, 3|4); uint8, or uint16 gray)
    whose row r uses scanline filter filters[r % len(filters)]."""
    import struct
    import zlib

    h, w = image.shape[:2]
    channels = 1 if image.ndim == 2 else image.shape[2]
    depth = 16 if image.dtype == np.uint16 else 8
    data = image.astype(">u2") if depth == 16 else image
    pixels = np.frombuffer(data.tobytes(), np.uint8).reshape(h, w, -1).astype(np.int32)
    prior = np.zeros_like(pixels[0])
    rows = []
    for r in range(h):
        kind = filters[r % len(filters)]
        cur = pixels[r]
        a = np.concatenate([np.zeros_like(cur[:1]), cur[:-1]])
        c = np.concatenate([np.zeros_like(prior[:1]), prior[:-1]])
        b = prior
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = [0 * a, a, b, (a + b) // 2, paeth][kind]
        rows.append(bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
        prior = cur
    header = struct.pack(">IIBBBBB", w, h, depth, {1: 0, 3: 2, 4: 6}[channels], 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header) + _chunk(b"tEXt", b"note\x00x")
            + _chunk(b"IDAT", zlib.compress(b"".join(rows))) + _chunk(b"IEND", b""))


PNG_IMAGES = {
    "rgb8": lambda rs: rs.randint(0, 256, (9, 13, 3)).astype(np.uint8),
    "rgba8": lambda rs: rs.randint(0, 256, (9, 13, 4)).astype(np.uint8),
    "gray8": lambda rs: rs.randint(0, 256, (9, 13)).astype(np.uint8),
    "gray16": lambda rs: rs.randint(0, 65536, (9, 13)).astype(np.uint16),
}


@pytest.mark.parametrize("kind", list(PNG_IMAGES))
@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [4, 0, 3, 1, 2]],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
def test_png_reader_undoes_each_filter(tmp_path, kind, filters):
    import cv2

    from dvmvs_tpu_torch.data import io as tio

    image = PNG_IMAGES[kind](np.random.RandomState(len(filters) * 7 + filters[0]))
    path = tmp_path / f"{kind}.png"
    path.write_bytes(encode_png(image, filters))
    got = tio.read_png(str(path))
    assert got.dtype == image.dtype
    np.testing.assert_array_equal(got, image)
    # cv2 reads the same file to the same array (BGR order aside)
    want = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if want.ndim == 3:
        want = want[:, :, [2, 1, 0, 3][:want.shape[2]]]
    np.testing.assert_array_equal(got, want)


def test_png_reader_matches_cv2_written_frames(tmp_path):
    """8-bit RGB frames and 16-bit depth maps as cv2 writes them (the scene
    layout's images/ and depth/), read by the port and by the JAX package."""
    import cv2

    from dvmvs_tpu.data import io as jio
    from dvmvs_tpu_torch.data import io as tio

    rs = np.random.RandomState(4)
    smooth = cv2.GaussianBlur(rs.randint(0, 256, (48, 80, 3)).astype(np.uint8), (7, 7), 2)
    for i, rgb in enumerate((rs.randint(0, 256, (48, 80, 3)).astype(np.uint8), smooth)):
        path = str(tmp_path / f"rgb{i}.png")
        cv2.imwrite(path, cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
        got = tio.load_image(path)
        assert got.dtype == np.float32 and got.shape == (48, 80, 3)
        np.testing.assert_array_equal(got, jio.load_image(path))
        np.testing.assert_array_equal(tio.read_png(path), rgb)
    depth_mm = rs.uniform(300, 12000, (48, 80)).astype(np.uint16)
    path = str(tmp_path / "depth.png")
    cv2.imwrite(path, depth_mm)
    np.testing.assert_array_equal(tio.load_depth_png(path), jio.load_depth_png(path))
    np.testing.assert_array_equal(tio.read_png(path), depth_mm)


def test_png_reader_refuses_what_it_cannot_read(tmp_path):
    from dvmvs_tpu_torch.data import io as tio

    image = PNG_IMAGES["rgb8"](np.random.RandomState(0))
    interlaced = tmp_path / "interlaced.png"
    interlaced.write_bytes(encode_png(image, [0], interlace=1))
    with pytest.raises(ValueError, match="interlaced.png: interlaced"):
        tio.read_png(str(interlaced))
    corrupt = bytearray(encode_png(image, [0]))
    corrupt[40] ^= 0xFF  # a byte inside the tEXt chunk
    (tmp_path / "corrupt.png").write_bytes(bytes(corrupt))
    with pytest.raises(ValueError, match="corrupt.png: corrupt"):
        tio.read_png(str(tmp_path / "corrupt.png"))
    (tmp_path / "text.png").write_bytes(b"not a png")
    with pytest.raises(ValueError, match="text.png: not a PNG"):
        tio.read_png(str(tmp_path / "text.png"))


def test_load_scene_matches_jax(tmp_path):
    from dvmvs_tpu.data import io as jio
    from dvmvs_tpu_torch.data import io as tio

    (tmp_path / "images").mkdir()
    for i in (2, 0, 1):
        (tmp_path / "images" / f"{i:05d}.png").write_bytes(b"")
    poses = np.stack([np.eye(4) + 0.01 * i for i in range(3)])
    np.savetxt(tmp_path / "poses.txt", poses.reshape(3, 16))
    np.savetxt(tmp_path / "K.txt", np.array([[50.0, 0, 32], [0, 50.0, 24], [0, 0, 1]]))
    got, want = tio.load_scene(str(tmp_path)), jio.load_scene(str(tmp_path))
    assert got.image_filenames == want.image_filenames and got.depth_filenames is None
    assert want.depth_filenames is None and got.name == want.name
    np.testing.assert_array_equal(got.K, want.K)
    np.testing.assert_array_equal(got.poses, want.poses)


def test_write_png_reads_back_with_cv2_and_read_png(tmp_path):
    """write_png's RGB frames and 16-bit millimetre depth maps (the scene
    layout, written without cv2) read back unchanged by cv2 and by read_png;
    bad input raises."""
    import cv2

    from dvmvs_tpu_torch.data.io import load_depth_png, read_png, write_png

    rs = np.random.RandomState(11)
    rgb = rs.randint(0, 256, (37, 53, 3)).astype(np.uint8)
    depth_mm = rs.randint(0, 65536, (37, 53)).astype(np.uint16)
    gray = rs.randint(0, 256, (5, 7)).astype(np.uint8)
    for name, image in (("rgb.png", rgb), ("depth.png", depth_mm), ("gray.png", gray)):
        path = str(tmp_path / name)
        write_png(path, image, level=1 if name == "gray.png" else 6)
        np.testing.assert_array_equal(read_png(path), image)
        back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if image.ndim == 3:
            back = cv2.cvtColor(back, cv2.COLOR_BGR2RGB)
        assert back.dtype == image.dtype
        np.testing.assert_array_equal(back, image)
    np.testing.assert_array_equal(load_depth_png(str(tmp_path / "depth.png")),
                                  depth_mm.astype(np.float32) / 1000.0)
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "bad.png"), rgb.astype(np.float32))
