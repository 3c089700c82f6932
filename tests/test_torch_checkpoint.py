"""The JAX package's checkpoints in the port: utils/msgpack.py against
flax.serialization, and utils/checkpoint.py's JAX route against the JAX
package's save_checkpoint / load_checkpoint / load_checkpoint_partial.

Tolerances: the packer is held byte for byte to flax.serialization.to_bytes
and the decoder bit for bit to the arrays flax packed. Depths of a JAX
checkpoint run through the port's online driver are held to the JAX
engine's on the same file at rtol 1e-5 (PERF.md section 2's limit, as
tests/test_torch_engine.py holds the engines), and a baseline's predictions
to the JAX loop's at tests/test_torch_baselines.py's rtol 1e-5.
"""

import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvmvs_tpu.apps import run_testing_baseline as jrtb
from dvmvs_tpu.apps.engine import InferenceEngine as JEngine
from dvmvs_tpu.apps.run_testing_online import predict_scene as jax_predict_scene
from dvmvs_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from dvmvs_tpu.utils.checkpoint import load_checkpoint_partial as jax_load_partial
from dvmvs_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from dvmvs_tpu_torch.apps import run_testing_baseline as rtb
from dvmvs_tpu_torch.apps import run_testing_online
from dvmvs_tpu_torch.apps.engine import InferenceEngine
from dvmvs_tpu_torch.baselines import gpmvs
from dvmvs_tpu_torch.config import TestConfig
from dvmvs_tpu_torch.utils import checkpoint, msgpack
from dvmvs_tpu_torch.utils.weights import jax_variables
from tests.test_drivers_e2e import H_SRC, W_SRC, png_scene, tiny_cfg  # noqa: F401 (fixtures)
from tests.test_torch_baselines import INDEX, RTOL, mvdepth_variables, pair
from tests.test_torch_engine import one_torch_thread  # noqa: F401 (autouse fixture)


def _trees():
    rs = np.random.RandomState(0)
    bf16 = np.asarray(jnp.asarray(rs.randn(3, 2), jnp.bfloat16))
    return {
        "leaves": {"f32": rs.randn(2, 3, 4).astype(np.float32),
                   "f16": rs.randn(5).astype(np.float16), "bf16": bf16,
                   "i32": rs.randint(-9, 9, (4,)).astype(np.int32), "mask": rs.rand(6) > 0.5,
                   "empty": np.zeros((0, 3), np.float32)},
        "scalars": {"np_f32": np.float32(1.5), "np_i64": np.int64(-7), "np_bool": np.bool_(True),
                    "step": 12, "big": 2 ** 40, "neg": -300, "lr": 1e-3, "flag": False,
                    "none": None, "name": "x" * 40},
        "nested": {"a": {"b": {"c": rs.randn(2).astype(np.float32)}}, "empty": {},
                   "seq": [1, 2.0, np.arange(3, dtype=np.int32)]},
        "many_keys": {f"k{i}": np.float32(i) for i in range(20)},
    }


def _bit_equal(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            _bit_equal(got[k], want[k])
    elif isinstance(want, (np.ndarray, np.generic)):
        assert isinstance(got, torch.Tensor), type(got)
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape and msgpack.DTYPE_NAMES[got.dtype] == want.dtype.name
        assert got.reshape(-1).view(torch.uint8).numpy().tobytes() == want.tobytes()
    else:
        assert got == want and type(got) is type(want)


@pytest.mark.parametrize("name", sorted(_trees()))
def test_packb_writes_the_bytes_flax_writes(name):
    tree = _trees()[name]
    assert msgpack.packb(tree) == flax.serialization.to_bytes(tree)


@pytest.mark.parametrize("name", sorted(_trees()))
def test_unpackb_reads_flax_bytes_bit_for_bit(name):
    tree = _trees()[name]
    want = flax.serialization.msgpack_restore(flax.serialization.to_bytes(tree))
    _bit_equal(msgpack.unpackb(flax.serialization.to_bytes(tree)), want)


def test_chunked_arrays_round_trip_as_flax_writes_them(monkeypatch):
    """Arrays over MAX_CHUNK_SIZE bytes go as flax's chunked form (a small
    limit on both sides, as flax's own tests set one)."""
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 24)
    monkeypatch.setattr(msgpack, "MAX_CHUNK_SIZE", 24)
    rs = np.random.RandomState(1)
    tree = {"params": {"w": rs.randn(5, 7).astype(np.float32),
                       "h": rs.randn(30).astype(np.float16), "small": np.float32(2.0)}}
    data = flax.serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in data
    assert msgpack.packb(tree) == data
    back = msgpack.unpackb(data)
    for k in ("w", "h"):
        np.testing.assert_array_equal(back["params"][k].numpy(), tree["params"][k])
    # decoded tensors pack again to the same bytes (a numpy scalar decodes to
    # a 0-d tensor, which packs as an array, so it is given as it was)
    again = {"params": {"w": back["params"]["w"], "h": back["params"]["h"],
                        "small": np.float32(2.0)}}
    assert msgpack.packb(again) == data


@pytest.mark.parametrize("data, byte", [
    (b"\xc1", "0xc1"),  # never used
    (flax.serialization.to_bytes({"z": complex(1, 2)}), "ext type 2"),  # complex
    (b"\x81\xa1a\xc7\x02\x07ab", "ext type 7"),
])
def test_unsupported_types_raise_naming_them(data, byte):
    with pytest.raises(ValueError, match=byte):
        msgpack.unpackb(data)


def test_is_jax_checkpoint_decides_by_content(tmp_path):
    jax_save_checkpoint(str(tmp_path / "model.pt"), {"params": {"w": np.zeros(2, np.float32)}})
    assert checkpoint.is_jax_checkpoint(str(tmp_path / "model.pt"))  # the suffix does not decide
    torch.save({"w": torch.zeros(2)}, tmp_path / "model.msgpack")
    assert not checkpoint.is_jax_checkpoint(str(tmp_path / "model.msgpack"))
    torch.save({"w": torch.zeros(2)}, tmp_path / "legacy", _use_new_zipfile_serialization=False)
    assert not checkpoint.is_jax_checkpoint(str(tmp_path / "legacy"))  # pickle: 0x80, 0x02
    (tmp_path / "list").write_bytes(b"\x92\x01\x02")  # a msgpack array, not a map
    (tmp_path / "empty").write_bytes(b"")
    assert not checkpoint.is_jax_checkpoint(str(tmp_path / "list"))
    assert not checkpoint.is_jax_checkpoint(str(tmp_path / "empty"))


@pytest.fixture(scope="module")
def jax_engines(tiny_cfg):
    """The JAX engines' seeded variables at full channel widths, 96x64 frames."""
    return {kind: JEngine(kind, tiny_cfg) for kind in ("pairnet", "fusionnet")}


def _port_cfg():
    return TestConfig(image_width=W_SRC, image_height=H_SRC)


@pytest.mark.parametrize("kind", ["pairnet", "fusionnet"])
def test_save_jax_checkpoint_writes_what_the_jax_package_writes(jax_engines, tmp_path, kind):
    """JAX save_checkpoint -> the port's load_checkpoint -> save_jax_checkpoint
    gives the JAX file's bytes, and JAX load_checkpoint reads it back."""
    jengine = jax_engines[kind]
    src = str(tmp_path / "jax.msgpack")
    jax_save_checkpoint(src, jengine.variables)
    engine = InferenceEngine(kind, _port_cfg(), device="cpu",
                             seed=9)
    assert checkpoint.load_checkpoint(src, engine.model) == []
    out = str(tmp_path / "port.msgpack")
    checkpoint.save_jax_checkpoint(out, engine.model)
    with open(src, "rb") as a, open(out, "rb") as b:
        assert a.read() == b.read()
    back = jax_load_checkpoint(out, jengine.variables)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(jengine.variables)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_warm_start_fills_the_shared_modules_and_keeps_lstm_fresh(jax_engines, tmp_path,
                                                                  capsys):
    """A pairnet file warm-starts fusionnet (load_checkpoint_partial): the
    four shared modules equal what the JAX package restores, lstm_fusion
    stays bit-unchanged and is named as the JAX side names it; without
    ``partial`` the missing module is an error."""
    path = str(tmp_path / "pairnet.msgpack")
    jax_save_checkpoint(path, jax_engines["pairnet"].variables)
    engine = InferenceEngine("fusionnet", _port_cfg(),
                             device="cpu", seed=3)
    lstm = {k: v.clone() for k, v in engine.model.lstm_fusion.state_dict().items()}
    with pytest.raises(KeyError, match="lstm_fusion"):
        checkpoint.load_jax_checkpoint(path, engine.model)
    capsys.readouterr()
    assert checkpoint.load_checkpoint(path, engine.model, partial=True) == ["lstm_fusion"]
    port_said = capsys.readouterr().out
    for k, v in engine.model.lstm_fusion.state_dict().items():
        assert torch.equal(v, lstm[k])
    want = jax_load_partial(path, jax_engines["fusionnet"].variables)
    assert "warm-start: keeping fresh init for /params/lstm_fusion" in capsys.readouterr().out
    assert port_said.strip() == "warm-start: keeping fresh init for /params/lstm_fusion"
    got = jax_variables(engine.model)
    for module in ("feature_extractor", "feature_shrinker", "cost_volume_encoder",
                   "cost_volume_decoder"):
        for collection in ("params", "batch_stats"):
            if module not in want[collection]:
                continue
            for (path_w, w), (path_g, g) in zip(
                    jax.tree_util.tree_leaves_with_path(want[collection][module]),
                    jax.tree_util.tree_leaves_with_path(got[collection][module])):
                assert path_w == path_g
                np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("kind", ["pairnet", "fusionnet"])
def test_jax_checkpoint_runs_in_the_online_driver(jax_engines, png_scene, tiny_cfg, tmp_path,
                                                  kind):
    """run_testing_online --checkpoint <JAX file> --device cpu against the
    JAX engine whose variables the file holds: the first keyframes' depths
    within rtol 1e-5."""
    scene = os.path.join(png_scene, "tinyset", "000")
    jengine = jax_engines[kind]
    path = str(tmp_path / f"{kind}.msgpack")
    jax_save_checkpoint(path, jengine.variables)
    want, _ = jax_predict_scene(jengine, scene, tiny_cfg, evaluate=True, max_frames=3)

    run_testing_online.main(["--model", kind, "--scene", scene, "--checkpoint", path,
                             "--device", "cpu", "--output", str(tmp_path / "out"),
                             "--max-frames", "3", "--width", str(W_SRC),
                             "--height", str(H_SRC)])
    system = f"keyframe_tinyset_{W_SRC}_{H_SRC}_2_dvmvs_tpu_torch_{kind}_online"
    got = np.load(tmp_path / "out" / f"{system}_predictions_000.npz")["arr_0"]
    assert got.shape == (3, H_SRC, W_SRC) and len(want) == 3
    np.testing.assert_allclose(got, np.stack(want), rtol=1e-5)
    # the file, not the engine's own seed, set the weights
    seeded = InferenceEngine(kind, TestConfig(image_width=W_SRC, image_height=H_SRC),
                             device="cpu")
    fresh, _ = run_testing_online.predict_scene(seeded, scene, tiny_cfg, max_frames=1)
    assert not np.allclose(fresh[0], got[0], rtol=1e-3)


def test_baseline_driver_takes_a_jax_checkpoint(png_scene, tmp_path, monkeypatch):
    """run_testing_baseline --checkpoint <the raw-dict msgpack the JAX
    driver reads> for GP-MVS (its GP hyper-parameters are scalars in the
    file) against the JAX loop on the same variables."""
    monkeypatch.setattr(gpmvs.GPMVS, "image_width", W_SRC)
    monkeypatch.setattr(gpmvs.GPMVS, "image_height", H_SRC)
    port, jest = pair("gpmvs", seed=4)
    data = tmp_path / "data"
    (data / "indices").mkdir(parents=True)
    os.symlink(os.path.join(png_scene, "tinyset"), data / "tinyset")
    index = data / "indices" / "keyframe+tinyset+000+nmeas+2"
    index.write_text("\n".join(INDEX) + "\n")
    path = str(tmp_path / "gpmvs.msgpack")
    jax_save_checkpoint(path, mvdepth_variables(port.model))
    raw = jax_load_checkpoint(path, None)
    monkeypatch.setattr(type(jest), "image_width", W_SRC)
    monkeypatch.setattr(type(jest), "image_height", H_SRC)
    want, _ = jrtb.evaluate_scene_baseline(
        type(jest)(n_measurement_frames=2, variables=raw),
        os.path.join(png_scene, "tinyset", "000"), str(index))
    rtb.main(["--baseline", "gpmvs", "--data", str(data), "--checkpoint", path,
              "--output", str(tmp_path / "port"), "--device", "cpu", "--no-evaluate"])
    got = np.load(tmp_path / "port" / f"keyframe_tinyset_{W_SRC}_{H_SRC}_2_gpmvs_predictions_000"
                  ".npz")["arr_0"]
    assert got.shape == (len(want), H_SRC, W_SRC)
    np.testing.assert_allclose(got, np.stack(want), rtol=RTOL)


@pytest.mark.parametrize("kind", ["pairnet", "fusionnet"])
def test_jax_variables_round_trip_is_bit_equal(kind):
    """model -> jax_variables -> load_jax_variables -> model keeps every
    tensor bit for bit (the kernels' transposes are exact)."""
    from dvmvs_tpu_torch.utils.weights import load_jax_variables

    cfg = _port_cfg()
    src = InferenceEngine(kind, cfg, device="cpu", seed=11).model
    dst = InferenceEngine(kind, cfg, device="cpu", seed=12).model
    load_jax_variables(dst, jax_variables(src))
    want, got = src.state_dict(), dst.state_dict()
    assert sorted(want) == sorted(got)
    assert any(not torch.equal(v, InferenceEngine(kind, cfg, device="cpu", seed=12)
                               .model.state_dict()[k]) for k, v in want.items())
    for k, v in want.items():
        assert torch.equal(got[k], v), k
