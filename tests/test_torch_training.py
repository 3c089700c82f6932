"""Port parity of the training slice: dvmvs_tpu_torch's training heads, loss
functions and staged Adam step against the JAX package's, with the Flax
variables carried across by utils/weights.py.

Size: 64x64 images, S=3, B=2, P=16 planes (the model's n_depth_levels), the
full 512-channel ConvLSTM. BatchNorm affine parameters and statistics are
randomised (tests/test_torch_models.py's helper), so train-mode BatchNorm is
not the identity. Each JAX program is compiled once per module, at XLA
backend optimisation level 1 (identical numerics).

Tolerances, relative to a tensor's largest magnitude, each measured on
this test's inputs:

  - Losses 1e-4 (measured 1.6e-6), BatchNorm running statistics 1e-4
    (3.8e-5).
  - Predictions 2e-3 (measured 5.4e-4). Train-mode BatchNorm over 8-24
    values per channel amplifies float32 rounding through the network: at
    the 1/32 MnasNet tap the JAX package is 1.3e-4 from a float64 run of the
    port, the port 2.9e-5.
  - Gradients with BatchNorm in eval mode (the ``--freeze-bn`` path) 2e-3 of
    the tensor's largest |grad|, floored at 1e-3 of its module's (measured
    5.4e-4 at most, the port's own float32 noise: its float64 run differs
    from its float32 one by as much there; median 2e-6).
  - Gradients with train-mode BatchNorm (the default) are ill-conditioned
    in float32 at this size: the port's float32 gradients differ from its
    float64 ones by 1.5% in the median tensor, and so do the JAX package's.
    They are held per module, as the relative L2 distance of all the
    module's gradients, to 0.1 (measured 0.017-0.029).
  - Adam's first step moves each parameter by lr * g / (|g| + eps), about
    lr * sign(g), so a gradient element near zero may flip its step. Steps
    are compared where the sign is settled (the JAX gradient at least half
    its tensor's largest, in a tensor whose largest is at least 1e-2 of its
    module's: some BatchNorm biases have a gradient that is zero but for
    rounding), within 1e-2 * lr; every step is at most lr; parameters of
    frozen modules must not change at all.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvmvs_tpu.models.fusionnet import FusionNet as JFusionNet
from dvmvs_tpu.models.pairnet import PairNet as JPairNet
from dvmvs_tpu.models.training_heads import fusionnet_train_sequence as j_sequence
from dvmvs_tpu.parallel import train as jt
from dvmvs_tpu_torch.models.fusionnet import FusionNet
from dvmvs_tpu_torch.models.pairnet import PairNet
from dvmvs_tpu_torch.models.training_heads import fusionnet_train_sequence
from dvmvs_tpu_torch.parallel import train as tt
from dvmvs_tpu_torch.utils import weights as tw
from tests.conftest import random_pose
from tests.test_torch_models import _randomize_bn
from tests.test_torch_engine import one_torch_thread  # noqa: F401 (autouse fixture)

H = W = 64
S, B, P = 3, 2, 16
MIN_D, MAX_D = 0.25, 20.0
TOL = 1e-4
PRED_TOL = 2e-3
FROZEN_BN_GRAD_TOL = 2e-3
TRAIN_BN_GRAD_L2 = 0.1
LR = 1e-4
XLA = {"xla_backend_optimization_level": "1"}


def _batch(seed, s):
    rs = np.random.RandomState(seed)
    poses = np.stack([[random_pose(rs, 0.05) for _ in range(s)] for _ in range(B)])
    K = np.array([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]], np.float32)
    depths = rs.uniform(0.5, 8.0, (B, s, H, W)).astype(np.float32)
    depths[:, :, :3, :5] = 0.0  # invalid ground truth
    return {"images": (rs.randn(B, s, H, W, 3) * 0.5).astype(np.float32), "depths": depths,
            "poses": poses.astype(np.float32), "K": np.stack([K] * B)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _close(got, want, tol=TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _grad(p):
    """A parameter's gradient; one the loss does not reach (the FPN's 1/32
    output, which no head reads) is None, where JAX gives zeros."""
    return p.grad if p.grad is not None else torch.zeros_like(p)


def _module_state(variables, name):
    """The port's state dict of top-level module ``name`` from a Flax
    {"params", "batch_stats"} tree (gradients go in as "params")."""
    return tw.entries_state_dict(tw.MODULE_ENTRIES[name](), variables["params"][name],
                                 variables.get("batch_stats", {}).get(name, {}))


def _port(net, variables):
    model = net(MIN_D, MAX_D, P)
    tw.load_jax_variables(model, variables)
    return model.train()


def _assert_stats_match(model, variables):
    """The port's running statistics against a Flax tree's batch_stats."""
    for name in tw.MODULE_ENTRIES:
        if name == "lstm_fusion":  # no BatchNorm
            continue
        want = _module_state(variables, name)
        for key, value in getattr(model, name).state_dict().items():
            if key.endswith(("running_mean", "running_var")):
                _close(value, want[key], what=f"{name}.{key}")


@pytest.fixture(scope="module")
def fusion():
    """Flax FusionNet variables, a batch, and the JAX results: predictions,
    mutated batch_stats, loss, metrics and gradients, and one train step in
    stage 0 and in stage 2."""
    batch = _batch(0, S)
    jmodel = JFusionNet(MIN_D, MAX_D, P)
    jb = _jax(batch)
    variables = jax.jit(lambda: jmodel.init(
        jax.random.PRNGKey(0), jb["images"], jb["depths"], jb["poses"], jb["K"],
        method=j_sequence), compiler_options=XLA)()
    variables = _randomize_bn(variables, np.random.RandomState(1))

    def forward_and_grad(params, stats):
        preds, mutated = jmodel.apply({"params": params, "batch_stats": stats}, jb["images"],
                                      jb["depths"], jb["poses"], jb["K"], method=j_sequence,
                                      mutable=["batch_stats"])
        vg = jax.value_and_grad(jt.fusionnet_loss_fn, has_aux=True)
        return (preds, mutated["batch_stats"], vg(params, stats, jmodel, jb),
                vg(params, stats, jmodel, jb, bn_train=False))

    preds, stats, ((loss, (_, metrics)), grads), ((frozen_loss, _), frozen_grads) = jax.jit(
        forward_and_grad, compiler_options=XLA)(variables["params"], variables["batch_stats"])
    steps = {}
    for stage in (0, 2):
        tx = jt.make_optimizer(variables["params"], jt.FUSIONNET_STAGES[stage], LR)
        step = jt.make_train_step(jmodel, tx, kind="fusionnet", donate=False,
                                  compiler_options=XLA)
        state, _ = step(jt.create_train_state(variables, tx), jb, jax.random.PRNGKey(0))
        steps[stage] = jax.tree.map(np.asarray, {"params": state.params,
                                                 "batch_stats": state.batch_stats})
    return {"batch": batch, "variables": variables, "preds": preds, "stats": stats,
            "loss": loss, "metrics": metrics, "grads": grads, "steps": steps,
            "frozen_bn": (frozen_loss, frozen_grads)}


def test_fusionnet_train_sequence_matches_jax(fusion):
    model = _port(FusionNet, fusion["variables"])
    tb = _torch(fusion["batch"])
    preds = fusionnet_train_sequence(model, tb["images"], tb["depths"], tb["poses"], tb["K"])
    assert len(preds) == 5 and preds[0].shape == (S - 1, B, H, W)
    assert preds[4].shape == (S - 1, B, H // 16, W // 16)
    for got, want in zip(preds, fusion["preds"]):
        _close(got, want, PRED_TOL)
    _assert_stats_match(model, {"params": fusion["variables"]["params"],
                                "batch_stats": fusion["stats"]})


def _assert_grads_match(model, modules, grads, stats, train_bn: bool):
    """Every parameter's gradient against the Flax gradient tree (see the
    module docstring for the two tolerances); ``stats`` only completes the
    state dicts."""
    n = 0
    for name in modules:
        want = _module_state({"params": grads, "batch_stats": stats}, name)
        params = dict(getattr(model, name).named_parameters())
        got = {k: _grad(p).detach().numpy() for k, p in params.items()}
        n += len(params)
        if train_bn:
            diff = np.sqrt(sum(np.sum((got[k] - want[k].numpy()) ** 2) for k in got))
            norm = np.sqrt(sum(np.sum(want[k].numpy() ** 2) for k in got))
            assert diff <= TRAIN_BN_GRAD_L2 * norm, (name, diff / norm)
            continue
        floor = 1e-3 * max(np.abs(w.numpy()).max() for k, w in want.items() if k in got)
        for key in got:
            w = want[key].numpy()
            np.testing.assert_allclose(got[key], w, rtol=0, err_msg=f"grad {name}.{key}",
                                       atol=FROZEN_BN_GRAD_TOL * max(np.abs(w).max(), floor))
    return n


def test_fusionnet_loss_and_every_gradient_match_jax(fusion):
    model = _port(FusionNet, fusion["variables"])
    loss, metrics = tt.fusionnet_loss_fn(model, _torch(fusion["batch"]))
    loss.backward()
    _close(loss, fusion["loss"])
    for key in ("l1", "l1_inv", "l1_rel", "huber", "valid_count"):
        _close(metrics[key], fusion["metrics"][key], what=key)  # the 1/16 scale's
    n = _assert_grads_match(model, tw.MODULE_ENTRIES, fusion["grads"], fusion["stats"],
                            train_bn=True)
    assert n == len(list(model.parameters()))


def test_fusionnet_gradients_with_frozen_batchnorm_match_jax(fusion):
    """BatchNorm in eval mode (``--freeze-bn``): the whole backward, cost
    volume, hidden-state warp and LSTM included, at float32 precision."""
    model = _port(FusionNet, fusion["variables"]).eval()
    loss, _ = tt.fusionnet_loss_fn(model, _torch(fusion["batch"]))
    loss.backward()
    want_loss, want_grads = fusion["frozen_bn"]
    _close(loss, want_loss)
    n = _assert_grads_match(model, tw.MODULE_ENTRIES, want_grads, fusion["stats"],
                            train_bn=False)
    assert n == len(list(model.parameters()))


@pytest.mark.parametrize("stage", [0, 2])
def test_staged_adam_step_matches_jax(fusion, stage):
    model = _port(FusionNet, fusion["variables"])
    before = copy.deepcopy(model.state_dict())
    optimizer = tt.make_optimizer(model, tt.FUSIONNET_STAGES[stage], LR)
    metrics = tt.train_step(model, optimizer, _torch(fusion["batch"]), "fusionnet")
    _close(metrics["loss"], fusion["loss"])
    want_state = fusion["steps"][stage]
    trainable = set(tt.FUSIONNET_STAGES[stage])
    for name in tw.MODULE_ENTRIES:
        want = _module_state(want_state, name)
        grads = _module_state({"params": fusion["grads"], "batch_stats": fusion["stats"]}, name)
        module_max = max(float(np.abs(g.numpy()).max()) for g in grads.values())
        for key, value in getattr(model, name).state_dict().items():
            full = f"{name}.{key}"
            if key.endswith(("running_mean", "running_var")):
                _close(value, want[key], what=full)  # every module updates its statistics
            elif key.endswith("num_batches_tracked"):
                continue
            elif name not in trainable:
                assert torch.equal(value, before[full]), f"frozen {full} changed"
            else:  # trainable: every settled element moved by about lr
                got_step = (value - before[full]).numpy().astype(np.float64)
                want_step = want[key].numpy().astype(np.float64) - before[full].numpy()
                g = np.abs(grads[key].numpy())
                settled = (g >= 0.5 * g.max()) & (g.max() >= 1e-2 * module_max)
                np.testing.assert_allclose(got_step[settled], want_step[settled], rtol=0,
                                           atol=1e-2 * LR, err_msg=full)
                assert np.abs(got_step).max() <= LR * (1 + 1e-3), full
                assert not settled.any() or np.abs(got_step[settled]).min() > 0.5 * LR, full


def test_pairnet_two_way_flip_loss_and_gradients_match_jax(fusion):
    """PairNet (FusionNet's variables without the LSTM) in both directions,
    the first flipped: loss, metrics, statistics and every gradient, with
    train-mode BatchNorm and with it frozen."""
    batch = _batch(3, 2)
    variables = {"params": {k: v for k, v in fusion["variables"]["params"].items()
                            if k != "lstm_fusion"},
                 "batch_stats": fusion["variables"]["batch_stats"]}
    jmodel = JPairNet(MIN_D, MAX_D, P)
    jb = _jax(batch)
    flips = [True, False]

    def both(params, stats):
        vg = jax.value_and_grad(jt.pairnet_loss_fn, has_aux=True)
        return [vg(params, stats, jmodel, jb, jnp.asarray(flips), two_way=True, bn_train=bn)
                for bn in (True, False)]

    results = jax.jit(both, compiler_options=XLA)(variables["params"], variables["batch_stats"])
    modules = [m for m in tw.MODULE_ENTRIES if m != "lstm_fusion"]
    for train_bn, ((loss, (stats, metrics)), grads) in zip((True, False), results):
        model = _port(PairNet, variables).train(train_bn)
        got_loss, got_metrics = tt.pairnet_loss_fn(model, _torch(batch), flips, two_way=True)
        got_loss.backward()
        _close(got_loss, loss)
        for key in ("l1", "l1_inv", "valid_count"):
            _close(got_metrics[key], metrics[key], what=key)
        _assert_grads_match(model, modules, grads, stats, train_bn)
        if train_bn:
            _assert_stats_match(model, {"params": variables["params"], "batch_stats": stats})
