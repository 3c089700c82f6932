"""The online slice end to end: the port's predict_scene -> keyframe buffer ->
InferenceEngine against the JAX package's, on the PNG scene of
tests/test_drivers_e2e.py (64x96 frames, 64 planes, a NaN-pose segment that
triggers the tracking-lost reset) with the same weights.

Tolerance: depths within rtol 1e-5. The JAX path samples the cost volume
through its own gather and the port through F.grid_sample, and convolutions
sum in another order; the fusionnet recurrence carries both forward. The
measured gap is below 5e-7. Random weights leave the depth head's sigmoid
near 0.5, so the depths span a narrow band and a looser limit would let an
upstream fault through; the test prints the depths' spread beside the gap.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

import dvmvs_tpu.utils.keyframe_buffer as jkb
import dvmvs_tpu_torch.utils.keyframe_buffer as tkb
from dvmvs_tpu.apps.engine import InferenceEngine as JEngine
from dvmvs_tpu.apps.run_testing_online import predict_scene as jax_predict_scene
from dvmvs_tpu_torch.apps.engine import InferenceEngine
from dvmvs_tpu_torch.apps.run_testing_online import (
    predict_scene,
    predict_stream,
)
from dvmvs_tpu_torch.ops import plane_sweep
from dvmvs_tpu_torch.utils.profiling import counters
from tests.test_drivers_e2e import (  # noqa: F401 (fixtures)
    LOST_END,
    LOST_START,
    N_FRAMES,
    png_scene,
    tiny_cfg,
)

RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the test run shares the host's cores among its
    workers, and torch's default of a thread a core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_variables(engine):
    return jax.tree.map(np.asarray, engine.variables)


@pytest.mark.parametrize("kind", ["fusionnet", "pairnet"])
def test_online_slice_matches_jax(png_scene, tiny_cfg, monkeypatch, kind):
    monkeypatch.setattr(jkb, "TRACKING_LOST_LIMIT", 3)
    monkeypatch.setattr(tkb, "TRACKING_LOST_LIMIT", 3)
    scene = os.path.join(png_scene, "tinyset", "000")

    jengine = JEngine(kind, tiny_cfg)
    want, want_gts = jax_predict_scene(jengine, scene, tiny_cfg, evaluate=True)

    engine = InferenceEngine(kind, tiny_cfg, device="cpu", variables=numpy_variables(jengine))
    before = counters[plane_sweep.FORWARD_LAUNCHES]
    got, gts = predict_scene(engine, scene, tiny_cfg, evaluate=True)
    assert counters[plane_sweep.FORWARD_LAUNCHES] == before  # the CPU takes the plain version

    # keyframes before and after the tracking-lost reset
    assert len(got) == len(want) >= (LOST_START - 1) + (N_FRAMES - LOST_END - 1)
    assert len(gts) == len(want_gts) == len(got)
    worst = 0.0
    for g, w, gt, wgt in zip(got, want, gts, want_gts):
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_array_equal(gt, wgt)
        worst = max(worst, float(np.max(np.abs(g - w) / np.abs(w))))
    spread = (min(float(w.min()) for w in want), max(float(w.max()) for w in want))
    print(f"{kind}: {len(got)} keyframes, max relative depth difference {worst:.3e}, "
          f"depths {spread[0]:.4f}..{spread[1]:.4f} m")
    assert worst <= RTOL
    if kind == "fusionnet":
        assert float(engine.has_prev) == 1.0


def test_stream_from_memory_matches_scene_and_predict(png_scene, tiny_cfg):
    """predict_stream on frames held in memory gives predict_scene's depths;
    the engine's two-call path (encode + predict) gives encode_and_predict's."""
    import cv2

    from dvmvs_tpu_torch.apps.run_testing_online import normalize_rgb

    scene = os.path.join(png_scene, "tinyset", "000")
    engine = InferenceEngine("fusionnet", tiny_cfg, device="cpu", seed=3)
    want, _ = predict_scene(engine, scene, tiny_cfg, evaluate=False, max_frames=4)
    assert len(want) == 4

    names = sorted(os.listdir(os.path.join(scene, "images")))
    frames = [normalize_rgb(cv2.cvtColor(cv2.imread(os.path.join(scene, "images", n)),
                                         cv2.COLOR_BGR2RGB)) for n in names]
    poses = np.loadtxt(os.path.join(scene, "poses.txt")).reshape(-1, 4, 4)
    K = np.loadtxt(os.path.join(scene, "K.txt")).astype(np.float32)
    got, indices = predict_stream(engine, frames, poses, K, tiny_cfg, max_frames=4)
    assert indices == [1, 2, 3, 4]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6)

    engine.reset()
    f0 = engine.encode(frames[0])
    d1, f1 = engine.encode_and_predict(frames[1], [f0[0]], poses[1], [poses[0]], K)
    engine.reset()
    d1b = engine.predict(frames[1], engine.encode(frames[1]), [f0[0]], poses[1], [poses[0]], K)
    np.testing.assert_allclose(d1b, d1, rtol=1e-6)
    assert tuple(f1.shape) == (1, 32, tiny_cfg.image_height // 2, tiny_cfg.image_width // 2)


def test_engine_rejects_bad_configuration(tiny_cfg):
    with pytest.raises(ValueError):
        InferenceEngine("fusionnet", dataclasses.replace(tiny_cfg, image_width=100), device="cpu")
    with pytest.raises(ValueError):
        InferenceEngine("mvsnet", tiny_cfg, device="cpu")
    engine = InferenceEngine("pairnet", tiny_cfg, device="cpu")
    image = np.zeros((tiny_cfg.image_height, tiny_cfg.image_width, 3), np.float32)
    f = engine.encode(image)[0]
    with pytest.raises(ValueError):
        engine.encode_and_predict(image, [f, f, f], np.eye(4), [np.eye(4)] * 3, np.eye(3))


def test_engine_runs_on_the_card_unless_asked_for_the_cpu(tiny_cfg, monkeypatch):
    """The engine defaults to the card; without one it raises and names
    device="cpu" instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            InferenceEngine("pairnet", tiny_cfg, **device)
    assert InferenceEngine("pairnet", tiny_cfg, device="cpu").device.type == "cpu"
