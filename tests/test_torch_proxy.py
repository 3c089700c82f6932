"""The port's accuracy proxy (apps/make_synth_scenes.py,
apps/corpus_fingerprint.py, apps/accuracy_proxy.py) on the CPU.

  - ``make_synth_scenes`` writes the corpus of the JAX script
    scripts/make_synth_scenes.py (run here, where cv2 is) on 2+1+1 scenes of
    4 frames at 64x48: the same files, npz archives with equal keys and
    array bytes, equal text files, PNGs with equal decoded pixels.
  - The fingerprint check passes on that corpus and fails when one pixel of
    an evaluation frame, or one depth of a training frame, changes.
  - ``select_best``, ``eval_metrics`` and ``report`` on planted run
    directories and error files.
  - The driver end to end at the smallest size, ``--device cpu`` passed
    through to the training and test drivers.
"""

import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from dvmvs_tpu_torch.apps import accuracy_proxy as ap
from dvmvs_tpu_torch.apps import corpus_fingerprint as cf
from dvmvs_tpu_torch.apps import make_synth_scenes as ms
from dvmvs_tpu_torch.data.io import read_png, write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(train_scenes=2, val_scenes=1, eval_scenes=1, frames=4, width=64, height=48,
             seed_base=100)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The small corpus written by the JAX script and by the port."""
    import cv2  # noqa: F401 (the JAX script's writer)

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import make_synth_scenes as jax_script
    finally:
        sys.path.pop(0)
    jax_root = str(tmp_path_factory.mktemp("jax_corpus"))
    argv = sys.argv
    sys.argv = ["make_synth_scenes.py", "--output", jax_root] + [
        f"--{k.replace('_', '-')}={v}" for k, v in SMALL.items()]
    try:
        jax_script.main()
    finally:
        sys.argv = argv
    port_root = str(tmp_path_factory.mktemp("port_corpus"))
    ms.make_corpus(port_root, workers=2, **SMALL)
    return jax_root, port_root


def test_make_synth_scenes_writes_the_jax_corpus(corpora):
    import cv2

    jax_root, port_root = corpora
    files = _files(jax_root)
    assert files == _files(port_root)
    assert len([f for f in files if f.endswith(".npz")]) == 12
    assert len([f for f in files if f.endswith(".png")]) == 8
    for f in files:
        a, b = os.path.join(jax_root, f), os.path.join(port_root, f)
        if f.endswith(".npz"):
            with np.load(a) as za, np.load(b) as zb:
                assert sorted(za.files) == sorted(zb.files) == ["depth", "image"]
                for key in za.files:
                    assert za[key].dtype == zb[key].dtype and za[key].shape == zb[key].shape
                    assert za[key].tobytes() == zb[key].tobytes(), (f, key)
        elif f.endswith(".png"):
            want = cv2.imread(a, cv2.IMREAD_UNCHANGED)
            if want.ndim == 3:
                want = cv2.cvtColor(want, cv2.COLOR_BGR2RGB)
            got = read_png(b)
            assert got.dtype == want.dtype and np.array_equal(got, want), f
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), f


def _check(root, record):
    try:
        cf.main(["--root", root, "--expect", record, "--expect-pixels", record])
    except SystemExit as e:
        return e.code
    return 0


def test_fingerprint_passes_and_fails_on_one_changed_value(corpora, tmp_path):
    import shutil

    _, port_root = corpora
    root = str(tmp_path / "corpus")
    shutil.copytree(port_root, root)
    record = str(tmp_path / "record.json")
    cf.main(["--root", root, "--write", record])
    with open(record) as f:
        scenes = json.load(f)["scenes"]
    assert sorted(scenes) == ["eval/synth-eval/000", "train/scene_100", "train/scene_101",
                              "train/val_102"]
    assert _check(root, record) == 0

    png = os.path.join(root, "eval", "synth-eval", "000", "images", "00002.png")
    pixels = read_png(png)
    pixels[10, 20, 1] ^= 1
    write_png(png, pixels)
    assert _check(root, record) == 1
    assert cf.compare(cf.hash_corpus(root), {"scenes": scenes}, "train") == []
    assert cf.compare(cf.hash_corpus(root), {"scenes": scenes}, "eval") == [
        "eval/synth-eval/000: differs"]

    shutil.rmtree(root)
    shutil.copytree(port_root, root)
    npz = os.path.join(root, "train", "scene_101", "00003.npz")
    with np.load(npz) as z:
        image, depth = z["image"], z["depth"].copy()
    depth[5, 5] += 1
    np.savez(npz, image=image, depth=depth)
    assert _check(root, record) == 1
    assert cf.compare(cf.hash_corpus(root), {"scenes": scenes}, "train") == [
        "train/scene_101: differs"]


def test_recorded_pixel_digests_cover_the_nine_evaluation_scenes():
    with open(cf.EVAL_PIXELS) as f:
        pixels = json.load(f)
    with open(ap.FINGERPRINT) as f:
        recorded = json.load(f)
    want = sorted(s for s in recorded["scenes"] if s.startswith("eval/"))
    assert sorted(pixels["scenes"]) == want and len(want) == 9
    assert pixels["total"] == cf.total_digest(pixels["scenes"])


def _planted_run(rd, kind, val_l1, l1_inv):
    os.makedirs(rd)
    with open(os.path.join(rd, "metrics.jsonl"), "w") as f:
        f.write(json.dumps({"step": 3, "tag": "train", "loss": 1.0}) + "\n")
        for e, (v, w) in enumerate(zip(val_l1, l1_inv)):
            f.write(json.dumps({"step": e, "tag": "validation", "l1": v, "l1_inv": w,
                                "epoch": float(e)}) + "\n")
    for e in range(len(val_l1)):
        open(os.path.join(rd, f"{kind}_epoch{e}.pt"), "w").close()


def test_select_best_and_eval_metrics_on_planted_runs(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _planted_run(a, "pairnet", [0.5, 0.3, 0.4], [0.2, 0.1, 0.15])
    _planted_run(b, "pairnet", [0.35, 0.25], [0.1, 0.09])
    os.remove(os.path.join(b, "pairnet_epoch1.pt"))  # no checkpoint: not a candidate
    assert ap.select_best([a, b]) == os.path.join(a, "pairnet_epoch1.pt")
    assert ap.select_best([str(tmp_path / "none")]) is None
    assert sorted(ap.validation_log([a])) == [0, 1, 2]

    res = tmp_path / "res"
    os.makedirs(res)
    np.savez_compressed(res / "x_errors_000.npz", np.array([[1.0] * 8, [3.0] * 8]))
    np.savez_compressed(res / "x_errors_001.npz", np.array([[np.nan] * 8, [5.0] * 8]))
    np.savez_compressed(res / "x_predictions_000.npz", np.zeros((2, 4, 4)))
    np.testing.assert_allclose(ap.eval_metrics(str(res)), [3.0] * 8)
    with pytest.raises(FileNotFoundError):
        ap.eval_metrics(str(tmp_path))


def test_report_against_the_jax_seeds(tmp_path):
    jax_seeds = {str(s): {"pairnet": [1.0 + s] * 5 + [0.5] * 3,
                          "fusionnet": [1.0 + s] * 5 + [0.6] * 3} for s in range(3, 9)}
    jax_report = tmp_path / "jax.json"
    jax_report.write_text(json.dumps({"metrics": ap.METRIC_NAMES, "seeds": jax_seeds}))
    for seed, pair, fusion in ((3, 4.0, 3.0), (4, 5.0, 6.0)):
        os.makedirs(tmp_path / "results" / f"seed{seed}")
        summary = {"pairnet": [pair] * 5 + [0.5] * 3, "fusionnet": [fusion] * 5 + [0.7] * 3,
                   "validation": {k: {"first": 1.0, "best": 0.5, "last": 0.6}
                                  for k in ap.MODELS}}
        (tmp_path / "results" / f"seed{seed}" / "summary.json").write_text(json.dumps(summary))
    out = ap.report(str(tmp_path / "results"), [3, 4], str(tmp_path / "report.json"),
                    str(jax_report))
    assert json.loads((tmp_path / "report.json").read_text()) == out
    jax_abs = [4.0, 5.0, 6.0, 7.0, 8.0, 9.0]
    np.testing.assert_allclose(out["models"]["pairnet"]["jax"][0],
                               [np.mean(jax_abs), np.std(jax_abs)])
    np.testing.assert_allclose(out["models"]["pairnet"]["port"][0], [4.5, 0.5])
    # port mean 4.5 against 6.5 +- 2 * 1.708: inside; d<1.25 0.7 against 0.6 +- 0: outside
    assert out["models"]["pairnet"]["outside_2std"] == []
    assert out["models"]["fusionnet"]["outside_2std"] == ["d<1.25", "d<1.25^2", "d<1.25^3"]
    # seed 3: fusionnet's errors lower; seed 4: higher; its ratios higher on both
    assert out["fusionnet_better_seeds"] == {**{k: 1 for k in ap.METRIC_NAMES[:5]},
                                             **{k: 2 for k in ap.METRIC_NAMES[5:]}}


def test_driver_end_to_end_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = ap.main(["--out", str(tmp_path / "proxy"), "--seeds", "3", "--device", "cpu",
                   "--train-scenes", "2", "--val-scenes", "1", "--eval-scenes", "1",
                   "--frames", "16", "--width", "64", "--height", "64", "--res", "64",
                   "--pair-batch", "2", "--fusion-batch", "2", "--subseq", "3",
                   "--epochs", "2", "--fusion-epochs", "3", "--finetune-epochs", "1",
                   "--max-steps", "1", "--eval-size", "64", "64",
                   "--workers", "2"])
    summary = out["seeds"]["3"]
    for kind in ap.MODELS:
        assert len(summary[kind]) == 8 and np.isfinite(summary[kind][:5]).all()
        assert os.path.exists(summary["checkpoint"][kind])
        epochs = 2 if kind == "pairnet" else 3
        assert len(summary["validation"][kind]["l1_inv"]) == epochs
    assert "pairnet_epoch" in summary["checkpoint"]["pairnet"]
    assert os.path.exists(tmp_path / "proxy" / "report.json")
    with pytest.raises(FileExistsError):  # a seed is trained once
        ap.train_and_eval_seed(SimpleNamespace(out=str(tmp_path / "proxy")), None, 3)
