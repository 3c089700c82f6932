"""Headless visualization, the online driver's frame prefetcher and the
profiling helpers of the port, against the JAX package.

  - save_visualization writes the same four PNGs, pixel for pixel, as the
    JAX function (which writes with cv2), and the committed turbo table is
    cv2's COLORMAP_TURBO.
  - --visualize in the online driver writes the JAX driver's panels for the
    same scene and weights: reference and measurement panels equal, depth
    panels within one level (the engines' depths differ by up to rtol 1e-5,
    tests/test_torch_engine.py, which moves depth * 5000 across an integer
    or a colour level at a few pixels); the bulk driver's sequential mode
    writes save_visualization's panels of its own frames and depths.
  - predict_scene through the prefetcher is bit-equal to the stream of the
    same frames read in the loop; an error in the worker reaches the caller
    (within a timeout) and the worker has ended, as it has after an early
    stop.
  - device_trace writes a Chrome trace on the CPU, with the port's own
    spans (utils/profiling.py::span) beside the operators.
"""

import concurrent.futures
import json
import os
import threading

import cv2
import numpy as np
import pytest

from dvmvs_tpu.apps.engine import InferenceEngine as JEngine
from dvmvs_tpu.apps.run_testing_online import predict_scene as jax_predict_scene
from dvmvs_tpu.utils import visualization as jviz
from dvmvs_tpu_torch.apps import run_testing as rt
from dvmvs_tpu_torch.apps import run_testing_online as rto
from dvmvs_tpu_torch.apps.engine import InferenceEngine
from dvmvs_tpu_torch.config import MEAN_RGB, SCALE_RGB, STD_RGB
from dvmvs_tpu_torch.data.io import load_image, load_scene
from dvmvs_tpu_torch.data.preprocess import PreprocessImage
from dvmvs_tpu_torch.utils import profiling, visualization
from tests.test_drivers_e2e import png_scene, tiny_cfg  # noqa: F401 (fixtures)
from tests.test_torch_engine import numpy_variables, one_torch_thread  # noqa: F401

TIMEOUT = 120  # seconds any driver call may take here before the test fails
# an index over the PNG scene's frames that have poses (frames 10-15 have none)
INDEX = ["00002.png 00001.png 00000.png", "00004.png 00003.png 00002.png",
         "00005.png 00004.png", "TRACKING LOST", "00018.png 00017.png 00016.png",
         "00019.png 00018.png 00017.png"]


def panels(directory):
    return {f: cv2.imread(os.path.join(directory, f), cv2.IMREAD_UNCHANGED)
            for f in sorted(os.listdir(directory))}


def test_turbo_table_is_cv2s():
    want = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None], cv2.COLORMAP_TURBO)
    np.testing.assert_array_equal(visualization.turbo_rgb(), want[:, 0, ::-1])


@pytest.mark.parametrize("seed", [0, 1])
def test_save_visualization_equals_jax(tmp_path, seed):
    rs = np.random.RandomState(seed)
    ref, meas = rs.randn(2, 12, 20, 3).astype(np.float32)
    depth = rs.uniform(0.0, 7.0, (12, 20)).astype(np.float32)  # past colorize's 5 m too
    depth[0, 0] = 0.0
    visualization.save_visualization(str(tmp_path / "port"), 7, ref, meas, depth, MEAN_RGB,
                                     STD_RGB, SCALE_RGB)
    jviz.save_visualization(str(tmp_path / "jax"), 7, ref, meas, depth, MEAN_RGB, STD_RGB,
                            SCALE_RGB)
    got, want = panels(tmp_path / "port"), panels(tmp_path / "jax")
    assert sorted(got) == sorted(want) == [f"00007_{k}.png" for k in (
        "depth", "depth_color", "measurement", "reference")]
    for name in want:
        assert got[name].dtype == want[name].dtype and np.array_equal(got[name], want[name])


def test_online_visualize_writes_the_jax_drivers_panels(png_scene, tiny_cfg, tmp_path,
                                                         monkeypatch):
    scene = os.path.join(png_scene, "tinyset", "000")
    cfg = type(tiny_cfg)(**{**tiny_cfg.__dict__, "visualize": True})
    jengine = JEngine("fusionnet", cfg)
    monkeypatch.delenv("DISPLAY", raising=False)  # the JAX driver writes PNGs when headless
    monkeypatch.chdir(tmp_path / "jax" if (tmp_path / "jax").mkdir() is None else None)
    want_depths, _ = jax_predict_scene(jengine, scene, cfg, evaluate=False, max_frames=3)
    engine = InferenceEngine("fusionnet", cfg, device="cpu", variables=numpy_variables(jengine))
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "port")
    got_depths, _ = rto.predict_scene(engine, scene, cfg, evaluate=False, max_frames=3)
    assert len(got_depths) == len(want_depths) == 3
    got = panels(tmp_path / "port" / visualization.VIS_DIR)
    want = panels(tmp_path / "jax" / "visualizations")
    assert sorted(got) == sorted(want) and len(got) == 12
    for name in want:
        if name.endswith(("reference.png", "measurement.png")):
            assert np.array_equal(got[name], want[name]), name
        else:
            assert np.abs(got[name].astype(int) - want[name]).max() <= 1, name


def test_bulk_visualize_writes_its_frames_and_depths(png_scene, tiny_cfg, tmp_path, monkeypatch):
    """run_testing's sequential mode with --visualize's config: one set of
    panels a keyframe, made of the frames and depths it used."""
    scene = os.path.join(png_scene, "tinyset", "000")
    index = tmp_path / "index"
    index.write_text("\n".join(INDEX) + "\n")
    cfg = type(tiny_cfg)(**{**tiny_cfg.__dict__, "visualize": True})
    monkeypatch.chdir(tmp_path)
    engine = InferenceEngine("pairnet", cfg, device="cpu", seed=1)
    depths, _ = rt.evaluate_scene(engine, scene, str(index), cfg, evaluate=False)
    got = panels(tmp_path / visualization.VIS_DIR)
    assert len(got) == 4 * len(depths) == 4 * 5
    assets = rt.SceneAssets(scene, cfg, evaluate=False)
    lines = [line for line in INDEX if line != "TRACKING LOST"]
    for i, (line, depth) in enumerate(zip(lines, depths)):
        ref, meas = line.split(" ")[:2]
        visualization.save_visualization(str(tmp_path / "want"), i, assets.image(ref),
                                         assets.image(meas), depth, MEAN_RGB, STD_RGB, SCALE_RGB)
    want = panels(tmp_path / "want")
    assert sorted(got) == sorted(want)
    for name in want:
        assert np.array_equal(got[name], want[name]), name


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "frame-prefetch" and t.is_alive()]


def test_prefetched_scene_equals_the_stream_read_in_the_loop(png_scene, tiny_cfg):
    scene_dir = os.path.join(png_scene, "tinyset", "000")
    engine = InferenceEngine("fusionnet", tiny_cfg, device="cpu", seed=2)
    got, _ = rto.predict_scene(engine, scene_dir, tiny_cfg, evaluate=False)
    scene = load_scene(scene_dir)
    first = load_image(scene.image_filenames[0])
    pre = PreprocessImage(K=scene.K, old_width=first.shape[1], old_height=first.shape[0],
                          new_width=tiny_cfg.image_width, new_height=tiny_cfg.image_height,
                          distortion_crop=tiny_cfg.distortion_crop,
                          perform_crop=tiny_cfg.perform_crop)
    want, _ = rto.predict_stream(
        engine, (load_image(f) for f in scene.image_filenames), scene.poses,
        pre.get_updated_intrinsics().astype(np.float32), tiny_cfg,
        preprocess=lambda image: pre.apply_rgb(image, SCALE_RGB, MEAN_RGB, STD_RGB))
    assert len(got) == len(want) > 3
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert not _prefetch_threads()


def test_a_decode_error_reaches_the_caller_and_ends_the_worker(png_scene, tiny_cfg,
                                                               monkeypatch):
    """The fifth frame fails to decode: predict_scene raises that error
    (the JAX driver's worker dies and its loop waits for ever), and no
    prefetch thread is left; an early stop (max_frames) ends it too."""
    scene = os.path.join(png_scene, "tinyset", "000")
    engine = InferenceEngine("pairnet", tiny_cfg, device="cpu", seed=3)
    calls = []

    def failing(path):
        calls.append(path)
        if len(calls) == 5:
            raise OSError(f"planted: cannot decode {path}")
        return load_image(path)

    monkeypatch.setattr(rto, "load_image", failing)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        future = pool.submit(rto.predict_scene, engine, scene, tiny_cfg, False)
        with pytest.raises(OSError, match="planted: cannot decode .*00004.png"):
            future.result(timeout=TIMEOUT)
    assert len(calls) == 5 and not _prefetch_threads()

    monkeypatch.setattr(rto, "load_image", load_image)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        depths, _ = pool.submit(rto.predict_scene, engine, scene, tiny_cfg, False,
                                1).result(timeout=TIMEOUT)
    assert len(depths) == 1 and not _prefetch_threads()


def test_prefetcher_reads_ahead_at_most_its_depth():
    started = threading.Event()
    loaded = []

    def load(name):
        loaded.append(name)
        started.set()
        return name

    prefetcher = rto._FramePrefetcher([str(i) for i in range(20)], load, depth=4)
    try:
        assert started.wait(TIMEOUT)
        assert next(prefetcher) == "0"
        for _ in range(50):  # let the worker fill the queue
            if len(loaded) >= 6:
                break
            threading.Event().wait(0.02)
        assert len(loaded) <= 1 + 4 + 1  # the one taken, the queue, the one in hand
    finally:
        prefetcher.close()
    assert not _prefetch_threads()


def test_device_trace_writes_a_chrome_trace_on_the_cpu(tmp_path, png_scene, tiny_cfg):
    engine = InferenceEngine("pairnet", tiny_cfg, device="cpu", seed=4)
    image = np.zeros((tiny_cfg.image_height, tiny_cfg.image_width, 3), np.float32)
    with profiling.device_trace(str(tmp_path / "trace")) as log_dir:
        engine.encode(image)
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("conv" in n for n in names), sorted(names)[:20]
    assert "dvmvs.graph.run" in names  # the port's own span, beside the operators


def test_fusionnet_validation_writes_the_depth_panels(tmp_path):
    """run_training's validation with a panels directory (as the JAX driver
    writes them): the first batch's first sample at its last step, full
    resolution, beside its ground truth, through the turbo map."""
    import torch

    from dvmvs_tpu_torch.apps import run_training
    from dvmvs_tpu_torch.config import TrainConfig
    from dvmvs_tpu_torch.data.dataset import MVSSequenceDataset, batch_iterator
    from dvmvs_tpu_torch.models.training_heads import fusionnet_train_sequence
    from tests.test_torch_data import write_corpus

    corpus = write_corpus(tmp_path / "corpus", n_frames=12, train=(100,), val=(101,))
    cfg = TrainConfig(image_width=64, image_height=64, batch_size=2, subsequence_length=3)
    data = MVSSequenceDataset(corpus, "VALIDATION", 3, cfg, seed=0)
    model = run_training.make_model("fusionnet", cfg, "cpu", seed=5).train()
    run_training.validate(model, data, cfg, "cpu", "fusionnet", panels=str(tmp_path / "panels"),
                          epoch=3)
    assert model.training  # the training mode is restored
    got = panels(tmp_path / "panels")
    assert sorted(got) == ["epoch0003_gt.png", "epoch0003_pred.png"]
    batch = {k: torch.from_numpy(v) for k, v in next(batch_iterator(data, 2, False)).items()}
    model.eval()
    with torch.no_grad():
        full = fusionnet_train_sequence(model, batch["images"], batch["depths"], batch["poses"],
                                        batch["K"])[0]
    for name, depth in (("pred", full[-1, 0]), ("gt", batch["depths"][0, -1])):
        want = visualization.colorize_depth(depth.numpy())
        assert np.array_equal(got[f"epoch0003_{name}.png"][:, :, ::-1], want)
