"""The port's training driver (dvmvs_tpu_torch/apps/run_training.py) end to
end on the CPU: a synthetic 64x64 corpus, one optimizer step per epoch,
every unfreeze stage, validation, checkpoints and the resume pair; resuming
from it; pairnet with the compact wire format and a warm start of fusionnet
from pairnet. The epoch schedule is held to the JAX driver's function.
"""

import json
import os

import pytest
import torch

from dvmvs_tpu.apps.run_training import stage_epoch_budget as jax_budget
from dvmvs_tpu_torch.apps import run_training as rt
from dvmvs_tpu_torch.models.fusionnet import FusionNet
from dvmvs_tpu_torch.utils import checkpoint
from tests.test_torch_data import write_corpus
from tests.test_torch_engine import one_torch_thread  # noqa: F401 (autouse fixture)

SMALL = ["--image-size", "64", "64", "--batch-size", "2", "--max-steps", "1",
         "--print-frequency", "1", "--device", "cpu"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp("corpus"), n_frames=24, train=(100,),
                        val=(101,))


def _state(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


def test_fusionnet_runs_every_stage_then_resumes(corpus, tmp_path, capsys):
    runs = str(tmp_path / "runs")
    run_dir = rt.main(["--model", "fusionnet", "--dataset", corpus, "--run-directory", runs,
                       "--subsequence-length", "3", "--epochs", "3", *SMALL])
    out = capsys.readouterr().out
    for stage in range(3):
        assert f"EPOCH {stage} (stage {stage}:" in out
    assert out.count("validation l1/l1-inv/l1-rel/huber") == 3
    for epoch in range(3):
        assert os.path.isfile(os.path.join(run_dir, f"fusionnet_epoch{epoch}.pt"))
    state = checkpoint.resume_path(run_dir, "fusionnet")
    meta = checkpoint.read_resume_meta(state)
    assert meta["epoch"] == 3 and meta["stage"] == 2 and len(meta["best_loss"]) == 4
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    losses = [line["loss"] for line in lines if line["tag"] == "train"]
    assert len(losses) == 3 and all(torch.isfinite(torch.tensor(losses)))

    # the last epoch's checkpoint is the model the resume state holds
    saved = torch.load(state, weights_only=True)
    last = torch.load(os.path.join(run_dir, "fusionnet_epoch2.pt"), weights_only=True)
    for name, sd in last.items():
        for key, value in sd.items():
            assert torch.equal(value, saved["model"][name][key]), f"{name}.{key}"

    resumed = rt.main(["--model", "fusionnet", "--dataset", corpus, "--run-directory", runs,
                       "--subsequence-length", "3", "--epochs", "4", "--resume", state, *SMALL])
    out = capsys.readouterr().out
    assert "resuming from" in out and "EPOCH 3 (stage 2:" in out and "EPOCH 2" not in out
    assert resumed != run_dir
    assert checkpoint.read_resume_meta(checkpoint.resume_path(resumed, "fusionnet"))["epoch"] == 4


def test_pairnet_compact_wire_then_warm_start_fusionnet(corpus, tmp_path, capsys):
    runs = str(tmp_path / "runs")
    run_dir = rt.main(["--model", "pairnet", "--dataset", corpus, "--run-directory", runs,
                       "--epochs", "2", "--finetune-epochs", "1", "--wire-compact",
                       "--no-validate", *SMALL])
    out = capsys.readouterr().out
    assert "EPOCH 1 (stage 1:" in out and "validation" not in out
    ckpt = os.path.join(run_dir, "pairnet_epoch1.pt")
    pair = torch.load(ckpt, weights_only=True)
    assert sorted(pair) == ["cost_volume_decoder", "cost_volume_encoder",
                            "feature_extractor", "feature_shrinker"]

    model = FusionNet()
    lstm_before = _state(model.lstm_fusion)
    fresh = checkpoint.load_checkpoint(ckpt, model, partial=True)
    assert fresh == ["lstm_fusion"]
    for key, value in model.lstm_fusion.state_dict().items():
        assert torch.equal(value, lstm_before[key])
    for key, value in model.cost_volume_encoder.state_dict().items():
        assert torch.equal(value, pair["cost_volume_encoder"][key])
    with pytest.raises(KeyError, match="lstm_fusion"):
        checkpoint.load_checkpoint(ckpt, FusionNet())


@pytest.mark.parametrize("n_stages,stage,epoch,finetune,total", [
    (2, 0, 0, 2, 6), (2, 1, 2, 2, 6),                    # pairnet fresh run: [2, 4]
    (3, 0, 0, 1, 6), (3, 1, 1, 1, 6), (3, 2, 2, 1, 6),   # fusionnet fresh run: [1, 1, 4]
    (2, 1, 3, 2, 6),                                     # resume mid last stage
    (2, 0, 1, 2, 6),                                     # resume mid a non-last stage
])
def test_stage_epoch_budget_matches_jax(n_stages, stage, epoch, finetune, total):
    assert rt.stage_epoch_budget(n_stages, stage, epoch, finetune, total) == \
        jax_budget(n_stages, stage, epoch, finetune, total)


def test_driver_trains_on_the_card_unless_asked_for_the_cpu(corpus, tmp_path, monkeypatch):
    """--device defaults to cuda; without a card the driver raises and names
    --device cpu instead of training on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--model", "pairnet", "--dataset", corpus, "--run-directory", str(tmp_path),
            "--epochs", "1"]
    for device in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="--device cpu"):
            rt.main(argv + device)
    assert os.listdir(tmp_path) == []  # it raised before making a run directory
