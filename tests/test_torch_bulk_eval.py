"""Bulk evaluation of the port (apps/run_testing.py, the batched steps of
apps/engine.py, apps/simulate_keyframe_buffer.py) against the JAX package's
on the PNG scene of tests/test_drivers_e2e.py (64x96 frames, 64 planes, a
NaN-pose segment), with the JAX engine's weights carried across.

Tolerances: depths within rtol 1e-5 of the JAX drivers with float32 feature
banks (the online slice's limit). With bfloat16 banks the port and the JAX
package each round their own float32 features, which differ by float32
reordering, so a feature can land on the neighbouring bfloat16 value on one
side only: BF16_ATOL, from the measured gap. Seeded weights keep the depth
in a band a few centimetres wide in which a wrong feature row moves it by
about 1e-6 m, so the depth cannot show such a fault; the cost volume can
(it moves by a tenth of its range): test_bulk_limits_catch_planted_faults
holds the batched paths' cost volumes against the sequential ones within
CV_RTOL (float32 banks) and CV_BF16_RTOL (bfloat16), and shows planted
faults break both. The chunked paths against a readback every step: rtol
1e-6 (the same arithmetic). Index files: equal line for line. Duplicate
jobs of one lockstep batch: atol 1e-6, the JAX test's limit (the CPU's
convolutions may sum two batch elements in different orders).
"""

import os

import numpy as np
import pytest
import torch

import jax

import dvmvs_tpu.utils.keyframe_buffer as jkb
import dvmvs_tpu_torch.utils.keyframe_buffer as tkb
from dvmvs_tpu.apps import run_testing as jrt
from dvmvs_tpu.apps import simulate_keyframe_buffer as jsim
from dvmvs_tpu.apps.engine import InferenceEngine as JEngine
from dvmvs_tpu.utils.results import save_results as jax_save_results
from dvmvs_tpu_torch.apps import run_testing as rt
from dvmvs_tpu_torch.apps import simulate_keyframe_buffer as sim
from dvmvs_tpu_torch.apps.engine import InferenceEngine
from dvmvs_tpu_torch.data import synthetic
from dvmvs_tpu_torch.ops import plane_sweep
from dvmvs_tpu_torch.apps import bench_bulk
from dvmvs_tpu_torch.utils.checkpoint import save_checkpoint
from dvmvs_tpu_torch.utils.profiling import counters
from tests.test_drivers_e2e import png_scene, tiny_cfg  # noqa: F401 (fixtures)
from tests.test_torch_engine import one_torch_thread  # noqa: F401 (autouse fixture)

RTOL, SCAN_RTOL = 1e-5, 1e-6
# bfloat16 banks, port against JAX: max |depth difference| in m, measured
# 5.5e-6 to 7.0e-6
BF16_ATOL = 5e-5
# cost volumes of the batched paths against the sequential one, max |diff|
# over max |sequential| a keyframe: measured 3.4e-7 (float32 banks) and
# 1.8e-3 (bfloat16) against 0.46-0.85 with a planted fault
CV_RTOL, CV_BF16_RTOL = 1e-4, 1e-2

# the index files of tests/test_drivers_e2e.py
INDEX = {
    "e2e": ["00002.png 00001.png 00000.png", "00004.png 00003.png 00002.png", "TRACKING LOST",
            "00008.png 00007.png 00006.png"],
    # 5 keyframes: batch 4 gives a full and a padded partial batch; one 1-view line
    "batched": ["00002.png 00001.png 00000.png", "00004.png 00003.png 00002.png",
                "00006.png 00005.png", "TRACKING LOST", "00008.png 00007.png 00006.png",
                "00009.png 00008.png 00007.png"],
    "b": ["00001.png 00000.png", "00003.png 00002.png 00001.png",
          "00005.png 00004.png 00003.png", "00007.png 00006.png 00005.png"],
    "short": ["00002.png 00001.png 00000.png", "00004.png 00003.png 00002.png"],
    "empty": ["TRACKING LOST"],
}


@pytest.fixture(scope="module")
def indices(png_scene):
    d = os.path.join(png_scene, "indices_torch_bulk")
    os.makedirs(d, exist_ok=True)
    paths = {}
    for i, (name, lines) in enumerate(INDEX.items()):
        paths[name] = os.path.join(d, f"keyframe+tinyset+{i:03d}+nmeas+2")
        with open(paths[name], "w") as f:
            f.write("\n".join(lines) + "\n")
    return paths


@pytest.fixture(scope="module")
def scene(png_scene):
    return os.path.join(png_scene, "tinyset", "000")


@pytest.fixture(scope="module")
def engines(tiny_cfg):
    """(JAX engine, port engine on the CPU with its weights) per model."""
    out = {}
    for kind in ("pairnet", "fusionnet"):
        jengine = JEngine(kind, tiny_cfg)
        variables = jax.tree.map(np.asarray, jengine.variables)
        out[kind] = (jengine, InferenceEngine(kind, tiny_cfg, device="cpu", variables=variables))
    return out


@pytest.fixture(scope="module")
def jax_runs(engines, scene, indices, tiny_cfg):
    """Every JAX driver run the tests compare with, made once."""
    jp, jf = engines["pairnet"][0], engines["fusionnet"][0]
    two = [(scene, indices["batched"]), (scene, indices["b"])]
    return {
        "seq_pairnet": jrt.evaluate_scene(jp, scene, indices["e2e"], tiny_cfg),
        "seq_fusionnet": jrt.evaluate_scene(jf, scene, indices["e2e"], tiny_cfg),
        "batched_f32": jrt.evaluate_scene_batched(jp, scene, indices["batched"], tiny_cfg,
                                                  batch_size=4, bank_dtype="f32"),
        "batched_bf16": jrt.evaluate_scene_batched(jp, scene, indices["batched"], tiny_cfg,
                                                   batch_size=4, bank_dtype="bf16"),
        "lockstep_f32": jrt.evaluate_scenes_batched_fusion(jf, two, tiny_cfg, bank_dtype="f32"),
        "lockstep_bf16": jrt.evaluate_scenes_batched_fusion(jf, two, tiny_cfg,
                                                            bank_dtype="bf16"),
        "degenerate": jrt.evaluate_scenes_batched_fusion(
            jf, [(scene, indices["short"]), (scene, indices["empty"])], tiny_cfg,
            bank_dtype="f32"),
        "duplicate": jrt.evaluate_scenes_batched_fusion(
            jf, [(scene, indices["short"]), (scene, indices["short"])], tiny_cfg,
            bank_dtype="f32"),
    }


def _assert_depths(got, want, rtol=RTOL, atol=0.0):
    assert len(got) == len(want) > 0
    worst = 0.0
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
        worst = max(worst, float(np.max(np.abs(g - w) / np.abs(w))))
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
    return worst


def _max_abs(got, want):
    assert len(got) == len(want) > 0
    return max(float(np.abs(g - w).max()) for g, w in zip(got, want))


def _assert_gts(got, want):
    assert (got is None) == (want is None)
    if want is not None:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", ["pairnet", "fusionnet"])
def test_evaluate_scene_matches_jax(engines, jax_runs, scene, indices, tiny_cfg, kind):
    """The sequential driver, with the TRACKING LOST reset of the index."""
    engine = engines[kind][1]
    before = counters[plane_sweep.FORWARD_LAUNCHES]
    got, gts = rt.evaluate_scene(engine, scene, indices["e2e"], tiny_cfg)
    assert counters[plane_sweep.FORWARD_LAUNCHES] == before  # the CPU takes the plain version
    want, want_gts = jax_runs[f"seq_{kind}"]
    assert len(got) == 3
    print(f"{kind}: max relative depth difference {_assert_depths(got, want):.3e}")
    _assert_gts(gts, want_gts)


@pytest.mark.parametrize("bank_dtype", ["f32", "bf16"])
def test_evaluate_scene_batched_matches_jax(engines, jax_runs, scene, indices, tiny_cfg,
                                            bank_dtype):
    """Batch 4 over 5 keyframes (a full batch and a padded one, a 1-view
    line) with the bank in each dtype, against JAX's run in the same dtype."""
    got, gts = rt.evaluate_scene_batched(engines["pairnet"][1], scene, indices["batched"],
                                         tiny_cfg, batch_size=4, bank_dtype=bank_dtype)
    want, want_gts = jax_runs[f"batched_{bank_dtype}"]
    assert len(got) == 5
    if bank_dtype == "f32":
        _assert_depths(got, want)
    else:
        gap = _max_abs(got, want)
        print(f"bf16 bank, port vs JAX: max |depth difference| {gap:.3e} m")
        assert gap <= BF16_ATOL
    _assert_gts(gts, want_gts)


@pytest.mark.parametrize("bank_dtype", ["f32", "bf16"])
def test_lockstep_fusion_matches_jax(engines, jax_runs, scene, indices, tiny_cfg, bank_dtype):
    """Two schedules of different lengths, one with a TRACKING LOST reset,
    advanced in lockstep."""
    jobs = [(scene, indices["batched"]), (scene, indices["b"])]
    got = rt.evaluate_scenes_batched_fusion(engines["fusionnet"][1], jobs, tiny_cfg,
                                            bank_dtype=bank_dtype)
    want = jax_runs[f"lockstep_{bank_dtype}"]
    assert [len(p) for p, _ in got] == [len(p) for p, _ in want] == [5, 4]
    for (g, g_gts), (w, w_gts) in zip(got, want):
        if bank_dtype == "f32":
            _assert_depths(g, w)
        else:
            gap = _max_abs(g, w)
            print(f"bf16 bank, port vs JAX: max |depth difference| {gap:.3e} m")
            assert gap <= BF16_ATOL
        _assert_gts(g_gts, w_gts)


def _cv_gap(got, want):
    """Largest max |got - want| / max |want| over two lists of cost volumes."""
    assert len(got) == len(want) > 0
    return max(float(np.abs(g - w).max() / np.abs(w).max()) for g, w in zip(got, want))


@pytest.fixture(scope="module")
def cost_volume_runs(engines, scene, indices, tiny_cfg):
    """The port's cost volumes a keyframe over the "batched" index:
    sequential, and a function giving the batched (pairnet, batch 4, the
    padding dropped) or lockstep (fusionnet, beside the "b" schedule) ones
    for a bank dtype."""
    pair, fusion = engines["pairnet"][1], engines["fusionnet"][1]
    jobs = [(scene, indices["batched"]), (scene, indices["b"])]

    def rows(engine, fn):
        with engine.recording_cost_volumes() as calls:
            fn()
        return [r for c in calls for r in c]

    def pair_run(dtype):
        return rows(pair, lambda: rt.evaluate_scene_batched(
            pair, scene, indices["batched"], tiny_cfg, batch_size=4, evaluate=False,
            bank_dtype=dtype))[:5]

    def lockstep_run(dtype):
        return rows(fusion, lambda: rt.evaluate_scenes_batched_fusion(
            fusion, jobs, tiny_cfg, evaluate=False, bank_dtype=dtype))[0::2][:5]

    out = {}
    for kind, engine, run in (("pairnet", pair, pair_run), ("fusionnet", fusion, lockstep_run)):
        seq = rows(engine, lambda engine=engine: rt.evaluate_scene(
            engine, scene, indices["batched"], tiny_cfg, evaluate=False))
        out[kind] = {"run": run, "seq": seq, "f32": run("f32"), "bf16": run("bf16")}
    return out


FAULTS = {"meas_rows_shifted": lambda bank, r, m: (bank, r, (m + 1) % bank[0].shape[0]),
          "views_swapped": lambda bank, r, m: (bank, r, m.flip(1)),
          "ref_rows_shifted": lambda bank, r, m: (bank, (r + 1) % bank[0].shape[0], m)}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("kind", ["pairnet", "fusionnet"])
def test_bulk_limits_catch_planted_faults(cost_volume_runs, monkeypatch, kind, fault):
    """The batched path's cost volumes stay within CV_RTOL of the
    sequential ones with a float32 bank and within CV_BF16_RTOL with a
    bfloat16 one, while a fault planted in the bank's read breaks both."""
    runs = cost_volume_runs[kind]
    sound, bf16 = _cv_gap(runs["f32"], runs["seq"]), _cv_gap(runs["bf16"], runs["seq"])
    real = InferenceEngine.gather_features
    monkeypatch.setattr(InferenceEngine, "gather_features", staticmethod(
        lambda bank, r, m: real(*FAULTS[fault](bank, r, m))))
    faulted = _cv_gap(runs["run"]("f32"), runs["seq"])
    print(f"{kind}: cost volume gap to sequential: f32 {sound:.3e}, bf16 {bf16:.3e}, "
          f"{fault} {faulted:.3e}")
    assert sound <= CV_RTOL and bf16 <= CV_BF16_RTOL < faulted


def test_lockstep_fusion_empty_and_duplicate_jobs(engines, jax_runs, scene, indices, tiny_cfg):
    """A job with only TRACKING LOST gives empty results without stopping the
    batch; duplicate jobs alias one parsed scene and give equal results; an
    all-empty batch returns at once."""
    engine = engines["fusionnet"][1]
    degenerate = rt.evaluate_scenes_batched_fusion(
        engine, [(scene, indices["short"]), (scene, indices["empty"])], tiny_cfg,
        bank_dtype="f32")
    assert degenerate[1][0] == [] and len(degenerate[1][1] or []) == 0
    assert jax_runs["degenerate"][1][0] == []
    _assert_depths(degenerate[0][0], jax_runs["degenerate"][0][0])

    duplicate = rt.evaluate_scenes_batched_fusion(
        engine, [(scene, indices["short"]), (scene, indices["short"])], tiny_cfg,
        bank_dtype="f32")
    for a, b in zip(duplicate[0][0], duplicate[1][0]):
        np.testing.assert_allclose(a, b, atol=1e-6)  # the JAX test's limit
    _assert_depths(duplicate[0][0], jax_runs["duplicate"][0][0])
    assert rt.evaluate_scenes_batched_fusion(
        engine, [(scene, indices["empty"])], tiny_cfg) == [([], [])]


def test_scanned_paths_match_per_step_paths(engines, scene, indices, tiny_cfg):
    """scan_chunk 2 splits the steps into chunks (the recurrent state carried
    across), 8 pads past the scenes' ends; both equal a readback every step
    (scan_chunk 0)."""
    pair, fusion = engines["pairnet"][1], engines["fusionnet"][1]
    base, base_gts = rt.evaluate_scene_batched(pair, scene, indices["batched"], tiny_cfg,
                                               batch_size=2, bank_dtype="f32")
    jobs = [(scene, indices["batched"]), (scene, indices["b"])]
    base_f = rt.evaluate_scenes_batched_fusion(fusion, jobs, tiny_cfg, bank_dtype="f32")
    for chunk in (2, 8):
        got, gts = rt.evaluate_scene_batched(pair, scene, indices["batched"], tiny_cfg,
                                             batch_size=2, scan_chunk=chunk, bank_dtype="f32")
        _assert_depths(got, base, SCAN_RTOL)
        _assert_gts(gts, base_gts)
        got_f = rt.evaluate_scenes_batched_fusion(fusion, jobs, tiny_cfg, scan_chunk=chunk,
                                                  bank_dtype="f32")
        for (g, g_gts), (w, w_gts) in zip(got_f, base_f):
            _assert_depths(g, w, SCAN_RTOL)
            _assert_gts(g_gts, w_gts)


def test_scan_schedule_matches_jax():
    for T in range(1, 41):
        for chunk in (1, 2, 4, 8):
            assert rt._scan_schedule(T, chunk) == jrt._scan_schedule(T, chunk)


def test_caches_are_bounded(engines, scene, tiny_cfg, png_scene):
    """SceneAssets keeps at most cache_frames frames (first in, first out);
    evaluate_scene's feature cache re-encodes evicted frames and gives the
    same depths with a cap of 2 as with 64."""
    assets = rt.SceneAssets(scene, tiny_cfg, cache_frames=3)
    names = [f"{i:05d}.png" for i in range(6)]
    first = [np.array(assets.image(n)) for n in names]
    assert len(assets._cache) <= 3 and assets._order == names[-3:]
    for n, want in zip(names, first):
        np.testing.assert_array_equal(assets.image(n), want)
    assert assets.image(names[-1]) is assets.image(names[-1])

    idx = os.path.join(png_scene, "idx_torch_longscene")
    with open(idx, "w") as f:
        for j in range(2, 10, 2):
            f.write(f"{j:05d}.png {j - 1:05d}.png 00000.png\n")
    engine = engines["pairnet"][1]
    calls = []
    real_encode = engine.encode
    engine.encode = lambda img: calls.append(1) or real_encode(img)
    try:
        wide, _ = rt.evaluate_scene(engine, scene, idx, tiny_cfg, evaluate=False,
                                    cache_features=64)
        n_wide = len(calls)
        calls.clear()
        capped, _ = rt.evaluate_scene(engine, scene, idx, tiny_cfg, evaluate=False,
                                      cache_features=2)
    finally:
        del engine.encode
    assert len(calls) > n_wide and len(capped) == len(wide) == 4
    for a, b in zip(wide, capped):
        np.testing.assert_array_equal(a, b)


def _synthetic_scene_folder(root, seed, n, lost=()):
    """A scene folder of a SynthScene walk for the index generator, which
    reads poses and file names only (the frames are empty files)."""
    folder = os.path.join(root, f"synth{seed}")
    os.makedirs(os.path.join(folder, "images"))
    poses = synthetic.SynthScene(seed).trajectory(n, step=0.06)
    poses[list(lost)] = np.nan
    np.savetxt(os.path.join(folder, "poses.txt"), poses.reshape(n, 16))
    for i in range(n):
        open(os.path.join(folder, "images", f"{i:05d}.png"), "w").close()
    return folder


def test_index_files_match_jax(png_scene, tmp_path, monkeypatch):
    """Both modes, line for line, on the PNG scene (its NaN segment becomes a
    TRACKING LOST line under a limit of 3) and on synthetic walks; then
    simulate_dataset's file names and contents."""
    monkeypatch.setattr(jkb, "TRACKING_LOST_LIMIT", 3)
    monkeypatch.setattr(tkb, "TRACKING_LOST_LIMIT", 3)
    folders = [os.path.join(png_scene, "tinyset", "000"),
               _synthetic_scene_folder(str(tmp_path / "synth"), 4, 60, lost=range(30, 36)),
               _synthetic_scene_folder(str(tmp_path / "synth"), 9, 45)]
    for folder in folders:
        for n in (1, 2, 3):
            got = sim.simulate_keyframe_buffer_for_scene(folder, n)
            assert got == jsim.simulate_keyframe_buffer_for_scene(folder, n) and got
            for skip in (1, 3):
                got = sim.simulate_simple_buffer_for_scene(folder, skip, n)
                assert got == jsim.simulate_simple_buffer_for_scene(folder, skip, n) and got
    assert any("TRACKING LOST" in sim.simulate_keyframe_buffer_for_scene(f, 2)
               for f in folders)

    sim.main(["--dataset", str(tmp_path / "synth"), "--output", str(tmp_path / "port"),
              "--nmeas", "2"])
    jsim.simulate_dataset(str(tmp_path / "synth"), str(tmp_path / "jax"), 2)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == [
        "keyframe+synth+synth4+nmeas+2", "keyframe+synth+synth9+nmeas+2"]
    for name in names:
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()


def test_main_end_to_end_matches_jax_results(engines, jax_runs, png_scene, indices, tmp_path):
    """run_testing.main on a data folder, reading the port's own checkpoint
    of the JAX weights: its npz files hold the JAX driver's predictions and
    errors (save_results of the same sequential pairnet run)."""
    data = tmp_path / "data"
    (data / "indices").mkdir(parents=True)
    os.symlink(os.path.join(png_scene, "tinyset"), data / "tinyset")
    with open(indices["e2e"]) as f, open(data / "indices" / "keyframe+tinyset+000+nmeas+2",
                                         "w") as g:
        g.write(f.read())
    checkpoint = str(tmp_path / "pairnet.pt")
    save_checkpoint(checkpoint, engines["pairnet"][1].model)

    rt.main(["--model", "pairnet", "--data", str(data), "--checkpoint", checkpoint,
             "--output", str(tmp_path / "port"), "--device", "cpu", "--width", "96",
             "--height", "64"])
    predictions, gts = jax_runs["seq_pairnet"]
    jax_save_results(predictions, gts, "jax", "000", str(tmp_path / "jax"))
    system = "keyframe_tinyset_96_64_2_dvmvs_tpu_torch_pairnet"
    for kind, rtol in (("predictions", RTOL), ("errors", 1e-4)):
        got = np.load(tmp_path / "port" / f"{system}_{kind}_000.npz")["arr_0"]
        want = np.load(tmp_path / "jax" / f"jax_{kind}_000.npz")["arr_0"]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6)


def test_bulk_entry_points_run_on_the_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    """main defaults to the card and raises without one, naming device="cpu";
    the batched evaluators refuse the other model kind."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "indices").mkdir()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        rt.main(["--model", "pairnet", "--data", str(tmp_path)])
    with pytest.raises(SystemExit):
        rt.main(["--model", "fusionnet", "--data", str(tmp_path), "--batch-size", "4",
                 "--device", "cpu"])


def test_bench_bulk_runs_every_mode_on_the_cpu(monkeypatch, tmp_path):
    """apps/bench_bulk.py at a tiny size on the CPU: every mode times its
    runs, gives every keyframe, launches no kernel off the card, agrees with
    the sequential run, and the report is written."""
    monkeypatch.setattr(bench_bulk, "FRAME", (128, 96))
    report = bench_bulk.main(
        ["--device", "cpu", "--scenes", "2", "--frames", "6", "--reps", "1", "--workers", "2",
         "--width", "96", "--height", "64", "--warmup-frames", "1", "--batch", "4", "--chunk",
         "2", "--json", str(tmp_path / "bench.json")])
    assert len(report) == 10 and (tmp_path / "bench.json").is_file()  # 8 eager, 2 graphed
    for name, r in report.items():
        assert r["median"] > 0 and r["launches"] == 0, name
        assert r["max_rel_gap"] <= RTOL, name
