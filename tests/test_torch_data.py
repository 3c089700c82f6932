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
    K = np.array([[50.0, 0, 32.0], [0, 50.0, 32.0], [0, 0, 1]])
    port = PreprocessImage(K, 2 * SIZE, 2 * SIZE, SIZE, SIZE)
    depth = np.ones((2 * SIZE, 2 * SIZE), np.float32)
    np.testing.assert_array_equal(port.apply_depth(depth),
                                  JPreprocessImage(K, 2 * SIZE, 2 * SIZE, SIZE, SIZE)
                                  .apply_depth(depth))
    monkeypatch.setitem(sys.modules, "cv2", None)  # as on a machine without OpenCV
    with pytest.raises(ImportError, match="needs OpenCV"):
        port.apply_depth(depth)


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
