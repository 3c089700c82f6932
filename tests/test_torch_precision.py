"""The port's precision contract (``utils/precision.py``) on the CPU: every
convolution that an entry point issues runs with cuDNN's convolution flag
and cuBLAS's matmul flag at ``"ieee"``, while the caller's process mode is
TF32 (torch's default on the card for convolutions, and here for matmuls
too), and the caller's mode is as it was afterwards.

The flags do nothing on the CPU, but they are readable, so a recorder
reads them at every convolution: a forward pre-hook on every ``nn.Conv*``
and ``nn.ConvTranspose*`` module (a global module hook, so it sees the
modules a driver builds), a gradient hook on each such module's output
(read when autograd reaches the convolution's backward), and a wrapper on
``torch.nn.functional.conv*`` for functional calls. Entry points, one case
each, at tiny sizes:

  - ``InferenceEngine`` (pairnet, fusionnet; ``graphs=True``, whose steps
    run on ``StepGraph``'s CPU branch, and ``graphs=False``): every public
    step, online and bulk;
  - each baseline's ``predict``, through ``GraphedEstimator``'s static
    buffers and eagerly;
  - ``train_step``, ``eval_step`` and ``GraphedTrainStep.train`` / ``.eval``,
    backward included;
  - each driver's ``main`` on a ``make_synth_scenes`` corpus with ``--device
    cpu`` (``accuracy_proxy`` with its child processes run in this process,
    so the recorder sees them); each driver's header must name the mode.

Planted fault: with the pin a no-op (``precision.unpinned``), the recorder
sees the caller's TF32 at the convolutions and the check fails.
"""

import importlib
import os

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from dvmvs_tpu_torch.apps import accuracy_proxy, dryrun_multichip, make_synth_scenes
from dvmvs_tpu_torch.apps import run_testing, run_testing_baseline, run_testing_online
from dvmvs_tpu_torch.apps import run_training, simulate_keyframe_buffer
from dvmvs_tpu_torch.apps.engine import InferenceEngine
from dvmvs_tpu_torch.baselines import deltas, dpsnet, gpmvs, mvdepthnet
from dvmvs_tpu_torch.baselines.registry import BASELINE_REGISTRY
from dvmvs_tpu_torch.config import TestConfig as InferenceConfig
from dvmvs_tpu_torch.models.layers import seeded_model
from dvmvs_tpu_torch.ops.sweep_measure import pose
from dvmvs_tpu_torch.parallel import train as tt
from dvmvs_tpu_torch.utils import precision
from tests.test_torch_engine import one_torch_thread  # noqa: F401 (autouse fixture)
from tests.test_torch_train_graphs import STAGES, _batch, _model

# the caller's mode: TF32 for every flag the port pins
TF32 = {"cudnn.conv": "tf32", "cudnn.rnn": "tf32", "cuda.matmul": "tf32"}
CONVS = (nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.ConvTranspose1d, nn.ConvTranspose2d,
         nn.ConvTranspose3d)
FUNCTIONAL = ("conv1d", "conv2d", "conv3d", "conv_transpose1d", "conv_transpose2d",
              "conv_transpose3d")
HEADER = "arithmetic: IEEE float32 convolutions and matmuls"
SIZE = 64
BASELINE_SIZES = {"mvdepthnet": (96, 64), "gpmvs": (96, 64), "dpsnet": (128, 128),
                  "deltas": (64, 48)}
BASELINES = {"mvdepthnet": mvdepthnet.MVDepthNet, "gpmvs": gpmvs.GPMVS,
             "dpsnet": dpsnet.DPSNet, "deltas": deltas.Deltas}


def _flags():
    b = torch.backends
    return {"cudnn.conv": b.cudnn.conv.fp32_precision, "cudnn.rnn": b.cudnn.rnn.fp32_precision,
            "cuda.matmul": b.cuda.matmul.fp32_precision}


def _set_flags(values):
    b = torch.backends
    b.cudnn.conv.fp32_precision = values["cudnn.conv"]
    b.cudnn.rnn.fp32_precision = values["cudnn.rnn"]
    b.cuda.matmul.fp32_precision = values["cuda.matmul"]


@pytest.fixture
def tf32_caller():
    """The process in TF32, as torch leaves it on the card; restored after."""
    saved = _flags()
    _set_flags(TF32)
    yield
    _set_flags(saved)


class ConvRecorder:
    """Within the block, ``calls`` gets (where, conv flag, matmul flag) at
    every convolution: forward (module or functional) and backward."""

    def __init__(self):
        self.calls = []

    def _record(self, where):
        flags = _flags()
        self.calls.append((where, flags["cudnn.conv"], flags["cuda.matmul"]))

    def __enter__(self):
        def pre(module, _):
            if isinstance(module, CONVS):
                self._record(f"forward {type(module).__name__}")

        def post(module, _, out):
            if isinstance(module, CONVS) and isinstance(out, torch.Tensor) and out.requires_grad:
                out.register_hook(lambda grad, name=type(module).__name__:
                                  self._record(f"backward {name}"))

        self.handles = [nn.modules.module.register_module_forward_pre_hook(pre),
                        nn.modules.module.register_module_forward_hook(post)]
        self.real = {name: getattr(F, name) for name in FUNCTIONAL}
        for name, fn in self.real.items():
            def wrapped(*args, _fn=fn, _name=name, **kwargs):
                self._record(f"F.{_name}")
                return _fn(*args, **kwargs)
            setattr(F, name, wrapped)
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()
        for name, fn in self.real.items():
            setattr(F, name, fn)


def _geometry(n, rs):
    poses = [pose(*rs.uniform(-2, 2, 3), [0.1 * i, rs.uniform(-0.02, 0.02), 0.0])
             for i in range(n)]
    K = np.array([[0.8 * SIZE, 0, SIZE / 2], [0, 0.8 * SIZE, SIZE / 2], [0, 0, 1]], np.float32)
    return poses, K


# ----------------------------------------------------------------- engine
def drive_engine(kind, graphs):
    """Every public step of the engine: online (``encode``,
    ``encode_and_predict``, ``predict``) and bulk (``encode_batch``, the
    batched step, the chunk of T steps)."""
    cfg = InferenceConfig(image_width=SIZE, image_height=SIZE)
    engine = InferenceEngine(kind, cfg, device="cpu", seed=0, graphs=graphs)
    rs = np.random.RandomState(0)
    frames = (rs.randn(4, SIZE, SIZE, 3) * 0.5).astype(np.float32)
    poses, K = _geometry(4, rs)
    half0 = engine.encode(frames[0])[0]
    _, half1 = engine.encode_and_predict(frames[1], [half0], poses[1], [poses[0]], K)
    engine.predict(frames[2], engine.encode(frames[2]), [half1, half0], poses[2],
                   [poses[1], poses[0]], K)

    images = engine.images(frames)
    bank = engine.encode_batch(images)
    T, B, V = 2, 2, cfg.n_measurement_frames
    ref_idx = torch.tensor([[2, 3], [3, 2]])
    meas_idx = torch.tensor([[[1, 0], [2, 1]], [[2, 1], [1, 0]]])
    p = torch.from_numpy(np.stack(poses))
    xs = {"ref_idx": ref_idx, "meas_idx": meas_idx, "ref_pose": p[ref_idx],
          "meas_pose": p[meas_idx], "view_mask": torch.ones((T, B, V))}
    Kb = torch.from_numpy(np.stack([K] * B))
    ref_images, ref_feats, meas_half = engine.gather_step_inputs(bank, images, ref_idx[0],
                                                                 meas_idx[0])
    step = (ref_images, ref_feats, meas_half, xs["ref_pose"][0], xs["meas_pose"][0], Kb,
            xs["view_mask"][0])
    if kind == "pairnet":
        engine.predict_batch(*step)
        engine.predict_pair_steps(bank, images, Kb, xs)
    else:
        state = engine.init_batch_state(B)
        _, state = engine.fusion_step_batch(*step, state, torch.tensor([1.0, 0.0]))
        engine.fusion_steps(bank, images, Kb, state, {**xs, "keep": torch.ones((T, B))})


# -------------------------------------------------------------- baselines
def small_estimator(name, graphs=True, device="cpu", **kwargs):
    """The seeded estimator at its test size on the CPU (DPSNet with 8
    labels)."""
    w, h = BASELINE_SIZES[name]
    cls = type(f"Small{BASELINES[name].__name__}", (BASELINES[name],),
               {"image_width": w, "image_height": h})
    est = cls(device=device, seed=3, graphs=graphs, **kwargs)
    if name == "dpsnet":
        est.model = seeded_model(dpsnet.DPSNetModel(8), 3, "cpu")
    return est


def drive_baseline(name, graphs):
    """Two keyframes (GP-MVS's second runs its Kalman step on a state)."""
    est = small_estimator(name, graphs)
    w, h = BASELINE_SIZES[name]
    rs = np.random.RandomState(1)
    images = [rs.randn(h, w, 3).astype(np.float32) for _ in range(4)]
    poses, _ = _geometry(4, rs)
    K = np.array([[0.8 * w, 0, w / 2], [0, 0.8 * w, h / 2], [0, 0, 1]], np.float32)
    for i in (2, 3):
        est.predict(images[i], [images[i - 1], images[i - 2]], poses[i],
                    [poses[i - 1], poses[i - 2]], K)


# --------------------------------------------------------------- training
def drive_train_step(kind):
    model = _model(kind)
    optimizer = tt.make_optimizer(model, STAGES[kind][-1])
    tt.train_step(model, optimizer, _batch(0, kind), kind, two_way=kind == "pairnet",
                  flip_mask=[True, False])
    tt.eval_step(model.eval(), _batch(1, kind), kind)


def drive_graphed_train_step(kind):
    model = _model(kind)
    steps = tt.GraphedTrainStep(model, kind, two_way=kind == "pairnet")
    optimizer = tt.make_optimizer(model, STAGES[kind][-1])
    for i in range(2):
        steps.train(optimizer, _batch(i, kind), torch.tensor([i == 0, True]))
    model.eval()
    steps.eval(_batch(2, kind))


# ---------------------------------------------------------------- drivers
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A ``make_synth_scenes`` corpus (2 train, 1 validation and 1
    evaluation scene of 16 frames at 64x64) and the evaluation scene's
    index files."""
    root = str(tmp_path_factory.mktemp("precision_corpus") / "data_synth")
    make_synth_scenes.make_corpus(root, train_scenes=2, val_scenes=1, eval_scenes=1,
                                  frames=16, width=SIZE, height=SIZE, workers=2)
    simulate_keyframe_buffer.main(["--dataset", os.path.join(root, "eval", "synth-eval"),
                                   "--output", os.path.join(root, "eval", "indices"),
                                   "--nmeas", "2"])
    return root


def _in_process(args):
    """``accuracy_proxy.run``'s child, run in this process by its ``main``."""
    importlib.import_module(args[0]).main(list(args[1:]))


def drive_driver(name, root, out, monkeypatch):
    """One driver's ``main`` at the smallest size, on the CPU."""
    size = ["--width", str(SIZE), "--height", str(SIZE)]
    eval_root = os.path.join(root, "eval")
    if name == "run_testing":
        run_testing.main(["--model", "pairnet", "--data", eval_root, "--batch-size", "2",
                          "--scan-chunk", "2", "--output", out, "--device", "cpu", *size])
    elif name == "run_testing_online":
        scene = os.path.join(eval_root, "synth-eval")
        scene = os.path.join(scene, sorted(os.listdir(scene))[0])
        run_testing_online.main(["--scene", scene, "--output", out, "--device", "cpu", *size])
    elif name == "run_testing_baseline":
        monkeypatch.setitem(BASELINE_REGISTRY, "mvdepthnet",
                            lambda **kw: small_estimator("mvdepthnet", **kw))
        run_testing_baseline.main(["--baseline", "mvdepthnet", "--data", eval_root,
                                   "--output", out, "--device", "cpu"])
    elif name == "run_training":
        run_training.main(["--model", "fusionnet", "--dataset", os.path.join(root, "train"),
                           "--run-directory", out, "--subsequence-length", "3", "--epochs", "1",
                           "--image-size", str(SIZE), str(SIZE), "--batch-size", "2",
                           "--max-steps", "1", "--device", "cpu"])
    elif name == "dryrun_multichip":
        dryrun_multichip.main(["--n-devices", "1", "--device", "cpu"])
    elif name == "accuracy_proxy":
        os.makedirs(out)
        os.symlink(root, os.path.join(out, "data_synth"))
        monkeypatch.setattr(accuracy_proxy, "run", _in_process)
        accuracy_proxy.main([
            "--out", out, "--seeds", "3", "--device", "cpu", "--train-scenes", "2",
            "--val-scenes", "1", "--eval-scenes", "1", "--frames", "16", "--width", str(SIZE),
            "--height", str(SIZE), "--res", str(SIZE), "--pair-batch", "2",
            "--fusion-batch", "2", "--subseq", "3", "--epochs", "2", "--fusion-epochs", "3",
            "--finetune-epochs", "1", "--max-steps", "1", "--eval-size", str(SIZE), str(SIZE)])


DRIVERS = ["run_testing", "run_testing_online", "run_testing_baseline", "run_training",
           "dryrun_multichip", "accuracy_proxy"]
CASES = ([f"engine-{k}-{'graphs' if g else 'eager'}" for k in ("pairnet", "fusionnet")
          for g in (True, False)]
         + [f"baseline-{n}-{'graphs' if g else 'eager'}" for n in BASELINES for g in (True, False)]
         + [f"train_step-{k}" for k in ("fusionnet", "pairnet")]
         + [f"graphed_train_step-{k}" for k in ("fusionnet", "pairnet")]
         + [f"driver-{d}" for d in DRIVERS])


def drive(case, request, tmp_path, monkeypatch):
    group, _, rest = case.partition("-")
    if group == "engine":
        kind, mode = rest.split("-")
        drive_engine(kind, mode == "graphs")
    elif group == "baseline":
        name, mode = rest.split("-")
        drive_baseline(name, mode == "graphs")
    elif group == "train_step":
        drive_train_step(rest)
    elif group == "graphed_train_step":
        drive_graphed_train_step(rest)
    else:
        drive_driver(rest, request.getfixturevalue("corpus"), str(tmp_path / "out"),
                     monkeypatch)


def recorded(case, request, tmp_path, monkeypatch):
    with ConvRecorder() as rec:
        drive(case, request, tmp_path, monkeypatch)
    return rec.calls


def assert_pinned(calls):
    """Every convolution saw IEEE convolutions and matmuls."""
    assert calls, "no convolution was recorded"
    wrong = [c for c in calls if c[1:] != ("ieee", "ieee")]
    assert not wrong, f"{len(wrong)} of {len(calls)} convolutions not pinned, e.g. {wrong[:3]}"


@pytest.mark.parametrize("case", CASES)
def test_every_convolution_runs_in_ieee_float32(case, tf32_caller, request, tmp_path,
                                                monkeypatch, capsys):
    calls = recorded(case, request, tmp_path, monkeypatch)
    assert_pinned(calls)
    if "train_step" in case:
        assert any(where.startswith("backward") for where, *_ in calls)
    assert _flags() == TF32, "the caller's mode was not restored"
    if case.startswith("driver-"):
        out = capsys.readouterr().out
        assert HEADER in out and "cudnn.conv tf32" in out, out[-2000:]


@pytest.mark.parametrize("case", ["engine-fusionnet-graphs", "engine-pairnet-eager",
                                  "baseline-mvdepthnet-graphs", "baseline-deltas-eager",
                                  "graphed_train_step-fusionnet", "train_step-pairnet",
                                  "driver-dryrun_multichip"])
def test_planted_fault_the_pin_bypassed_shows_tf32(case, tf32_caller, request, tmp_path,
                                                   monkeypatch):
    """With the pin a no-op the recorder sees the caller's TF32, and the
    check above fails."""
    with precision.unpinned():
        calls = recorded(case, request, tmp_path, monkeypatch)
    assert calls and all(c[1:] == ("tf32", "tf32") for c in calls)
    with pytest.raises(AssertionError, match="not pinned"):
        assert_pinned(calls)


def test_the_context_restores_the_callers_mode_on_an_error_and_nests(tf32_caller):
    with pytest.raises(KeyError):
        with precision.ieee_float32():
            assert precision.current() == dict.fromkeys(TF32, "ieee")
            with precision.ieee_float32():
                pass
            assert precision.current() == dict.fromkeys(TF32, "ieee")
            raise KeyError("inside the step")
    assert _flags() == TF32
    assert "cudnn.conv tf32" in precision.describe()
