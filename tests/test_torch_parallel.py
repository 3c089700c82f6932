"""Data parallelism of the port (parallel/mesh.py, the group path of
parallel/train.py, models/layers.py::SyncBatchNorm2d, and the --n-devices
paths of apps/run_training.py and apps/run_testing.py) on the CPU, with gloo
processes launched as torchrun launches them (RANK, WORLD_SIZE,
MASTER_ADDR, MASTER_PORT in the environment; one torch thread each).

Size: 64x64 frames, B=2 a rank (4 in all), S=3, 16 planes; BatchNorm
affine parameters and statistics randomised as in test_torch_training.py.

  (a) The 2-rank fusionnet and pairnet (two-way, the JAX step's flips)
      steps against the JAX step on the concatenated batch
      (``make_train_step(mesh=None)``): loss and BatchNorm running
      statistics within test_torch_training.py's 1e-4, gradients (BatchNorm
      frozen, the well-conditioned case) within its 2e-3 frozen-BatchNorm
      limit.
  (b) The same steps against the port's single-process step on the same
      global batch: loss and statistics rtol 1e-5, every parameter's
      gradient within 1e-4 relative L2 (GRAD_L2), with BatchNorm frozen and
      in train mode, and on a batch whose ranks hold very unequal valid
      counts. Measured: loss 2e-7, statistics 4e-7, gradients 3e-6 (frozen)
      and 6e-6 (train mode) relative at most.
  (c) Planted faults that must break (b): per-rank loss means averaged as
      plain DDP does, on the unequal batch, and BatchNorm without sync.
  (d) World size 1 equals the plain path bit for bit.
  (e) ``run_testing --n-devices 2`` in both batched modes (each rank's
      engine graphed, the default) writes the files of the single-process
      run, with equal depths and errors.
  (f) ``dryrun_multichip(2)``.
  (g) The graphed group step (``GraphedTrainStep(group=...)``, on the CPU
      its bodies on static buffers) equals the eager group step bit for
      bit on every rank (losses, metrics, parameters, BatchNorm buffers,
      gradients), float32 and float64, and so meets (b) in float64;
      ``broadcast_state`` writes every tensor in place, so a graph captured
      before a resume reads it; every rank draws batches of one shape.
  And ``run_training --n-devices 2``, graphed (the default) and with
  ``--no-graphs``, logs the single process's losses.

Run as a script, the file is the rank worker of (a)-(c) (``DIR``), or the
single process of (b) (``DIR single``).
"""

import contextlib
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = W = 64
S, B_RANK, WORLD, P = 3, 2, 2, 16
MIN_D, MAX_D = 0.25, 20.0
LR = 1e-4
TOL = 1e-4              # test_torch_training.py: losses, statistics
FROZEN_BN_GRAD_TOL = 2e-3  # test_torch_training.py: gradients, BatchNorm frozen
SINGLE_RTOL = 1e-5      # against the port's single process: loss, statistics
GRAD_L2 = 1e-4          # against the port's single process: gradients, a tensor
DRIVER_RTOL = 1e-3      # the training driver's losses after an Adam step
CASES = [
    # name, kind, batch, BatchNorm, dtype, planted fault: (a) in float32
    ("fusion_train", "fusionnet", "normal", "train", "float32", None),
    ("fusion_frozen", "fusionnet", "normal", "frozen", "float32", None),
    ("pair_train", "pairnet", "normal", "train", "float32", None),
    ("pair_frozen", "pairnet", "normal", "frozen", "float32", None),
    # (b) and (c) in float64
    ("fusion_f64", "fusionnet", "normal", "train", "float64", None),
    ("pair_f64", "pairnet", "normal", "train", "float64", None),
    ("fusion_unequal_f64", "fusionnet", "unequal", "train", "float64", None),
    ("fusion_unequal_mean_f64", "fusionnet", "unequal", "train", "float64", "mean"),
    ("fusion_nosync_f64", "fusionnet", "normal", "train", "float64", "nosync"),
]
# (g): cases the ranks also run through GraphedTrainStep, each rank comparing
# the two paths itself; rank 0 saves the float64 ones as <name>_graphed
GRAPHED = ["fusion_train", "pair_train", "fusion_f64", "pair_f64"]

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(args, world=WORLD):
    """Start ``python args`` as ``world`` ranks of a gloo group (``world``
    0: one process outside any group)."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    group = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()), WORLD_SIZE=str(world))
    return [subprocess.Popen([sys.executable] + list(args), cwd=REPO, text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             env=dict(env, **group, RANK=str(r), LOCAL_RANK=str(r))
                             if world else env)
            for r in range(max(world, 1))]


def finish(procs, timeout=600):
    """Their outputs; fails the test if one fails."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {r} failed:\n{out}"
    return outs


def launch(args, world=WORLD):
    return finish(start(args, world))


def random_pose(rs, t_scale):
    """tests/conftest.py's random pose (rotation by QR, det +1), without its
    jax import: the rank workers import no jax."""
    Q, R = np.linalg.qr(rs.randn(3, 3))
    Q = Q * np.sign(np.diag(R))
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    pose = np.eye(4)
    pose[:3, :3] = Q
    pose[:3, 3] = rs.randn(3) * t_scale
    return pose


def make_batch(seed, kind_of_batch="normal", s=S):
    """A global batch of WORLD * B_RANK rows of ``s`` frames; "unequal"
    leaves the second rank 5% of its valid depths."""
    rs = np.random.RandomState(seed)
    B = WORLD * B_RANK
    poses = np.stack([[random_pose(rs, 0.05) for _ in range(s)] for _ in range(B)])
    K = np.array([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]], np.float32)
    depths = rs.uniform(0.5, 8.0, (B, s, H, W)).astype(np.float32)
    depths[:, :, :3, :5] = 0.0
    if kind_of_batch == "unequal":
        depths[B_RANK:] *= rs.rand(B_RANK, s, H, W) < 0.05
    return {"images": (rs.randn(B, s, H, W, 3) * 0.5).astype(np.float32), "depths": depths,
            "poses": poses.astype(np.float32), "K": np.stack([K] * B)}


def case_batch(kind, which="normal"):
    """Fusionnet's subsequences of S frames, pairnet's pairs."""
    return make_batch(0, which) if kind == "fusionnet" else make_batch(3, which, 2)


def net(kind):
    from dvmvs_tpu_torch.models.fusionnet import FusionNet
    from dvmvs_tpu_torch.models.pairnet import PairNet

    return (FusionNet if kind == "fusionnet" else PairNet)(MIN_D, MAX_D, P)


def step_result(model, metrics) -> dict:
    """What the comparisons read after a step."""
    return {"loss": metrics["loss"].detach().clone(),
            "metrics": {k: v.detach().clone() for k, v in metrics.items()},
            "state": {k: v.detach().clone() for k, v in model.state_dict().items()},
            "grads": {k: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().clone()
                      for k, p in model.named_parameters()}}


@contextlib.contextmanager
def at_dtype(dtype):
    """The training step at ``dtype``: float32 is the port's own (the plain
    sweep and its VJP on the CPU); float64 runs autograd through the plain
    sweep, which the float32-only kernel wrapper refuses, and starts the
    LSTM carry in float64."""
    from dvmvs_tpu_torch.models import training_heads
    from dvmvs_tpu_torch.ops.cost_volume import inverse_depth_planes
    from dvmvs_tpu_torch.ops.plane_sweep import build_plane_matrices, plane_sweep_multiview_plain

    def sweep(ref_feat, meas_feat, ref_pose, meas_pose, K, min_depth, max_depth, n_levels):
        inv = inverse_depth_planes(min_depth, max_depth, n_levels, ref_feat.device)
        mats = build_plane_matrices(ref_pose, meas_pose, K, inv.to(dtype))
        ref, meas = (f.permute(0, 2, 3, 1) for f in (ref_feat, meas_feat))
        ones = torch.ones((len(ref), 1), dtype=dtype)
        return plane_sweep_multiview_plain(ref, meas[:, None], mats[:, None], ones)

    def carry(*args):
        return tuple(t.to(dtype) for t in real_carry(*args))

    real_sweep = training_heads.plane_sweep_cost_volume_train
    real_carry = training_heads.init_lstm_carry
    if dtype == torch.float64:
        training_heads.plane_sweep_cost_volume_train = sweep
        training_heads.init_lstm_carry = carry
    try:
        yield
    finally:
        training_heads.plane_sweep_cost_volume_train = real_sweep
        training_heads.init_lstm_carry = real_carry


def run_case(case, weights, batch, flips, group=None, fault=None, graphed=False):
    """One step of ``case`` on ``batch`` (this rank's rows under a group),
    through ``GraphedTrainStep`` when ``graphed``."""
    _, _, _, _, dtype, _ = case
    with at_dtype(getattr(torch, dtype)):
        return _run_case(case, weights, batch, flips, group, fault, graphed)


def _run_case(case, weights, batch, flips, group, fault, graphed=False):
    from dvmvs_tpu_torch.parallel import train as tt

    _, kind, _, bn, dtype, _ = case
    dtype = getattr(torch, dtype)
    model = net(kind)
    model.load_state_dict(weights[kind])
    model.to(dtype).train(bn == "train")
    if group is not None:
        if fault == "nosync":
            tt.broadcast_state(model, group)
        else:
            tt.make_data_parallel(model, group)
    stages = tt.FUSIONNET_STAGES if kind == "fusionnet" else tt.PAIRNET_STAGES
    optimizer = tt.make_optimizer(model, stages[-1], LR)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dtype) for k, v in batch.items()}
    two_way = kind == "pairnet"
    if fault == "mean":  # plain DDP: each rank's own mean, gradients averaged
        import torch.distributed as dist

        model.zero_grad(set_to_none=True)
        loss, metrics = tt.fusionnet_loss_fn(model, batch)
        loss.backward()
        tt.all_reduce_gradients(model, group)
        for p in model.parameters():
            p.grad /= dist.get_world_size(group)
        optimizer.step()
        metrics = {"loss": loss.detach() * 1.0}
        dist.all_reduce(metrics["loss"], group=group)
        metrics["loss"] /= dist.get_world_size(group)
    elif graphed:
        steps = tt.GraphedTrainStep(model, kind, two_way=two_way, group=group)
        metrics = steps.train(optimizer, batch, flips if two_way else None)
    else:
        metrics = tt.train_step(model, optimizer, batch, kind, two_way=two_way, flip_mask=flips,
                                group=group)
    return step_result(model, metrics)


def single_worker(work_dir):
    """The single-process float64 steps (b) compares with."""
    torch.set_num_threads(1)
    weights = torch.load(os.path.join(work_dir, "weights.pt"))
    with open(os.path.join(work_dir, "flips.json")) as f:
        flips = json.load(f)
    for case in CASES:
        name, kind, which, _, dtype, fault = case
        if fault is None and dtype == "float64":
            out = run_case(case, weights, case_batch(kind, which), flips)
            torch.save(out, os.path.join(work_dir, f"single_{name}.pt"))


def worker(work_dir):
    """Rank worker: every case of CASES through the group path."""
    from dvmvs_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    group, _ = mesh.init_data_parallel(WORLD, device="cpu")
    rank = mesh.rank(group)
    weights = torch.load(os.path.join(work_dir, "weights.pt"))
    with open(os.path.join(work_dir, "flips.json")) as f:
        flips = json.load(f)
    try:
        differ = {}
        for case in CASES:
            name, kind, which, _, dtype, fault = case
            rows = mesh.shard_rows(case_batch(kind, which), rank, WORLD)
            out = run_case(case, weights, rows, flips, group, fault)
            if rank == 0:
                torch.save(out, os.path.join(work_dir, f"{name}.pt"))
            if name in GRAPHED:
                graphed = run_case(case, weights, rows, flips, group, fault, graphed=True)
                differ[name] = unequal(graphed, out)
                if rank == 0 and dtype == "float64":  # what (b) reads, statistics alone
                    graphed["state"] = {k: v for k, v in graphed["state"].items()
                                        if k.endswith(("running_mean", "running_var"))}
                    torch.save(graphed, os.path.join(work_dir, f"{name}_graphed.pt"))
        with open(os.path.join(work_dir, f"rank_{rank}.json"), "w") as f:
            json.dump({"graphed_differ": differ, "broadcast": broadcast_in_place(group, rank)}, f)
    finally:
        mesh.destroy()


def unequal(got, want) -> list:
    """The entries of two ``step_result``s that differ (loss, metrics,
    state, gradients; torch.equal)."""
    keys = [] if torch.equal(got["loss"], want["loss"]) else ["loss"]
    for part in ("metrics", "state", "grads"):
        if got[part].keys() != want[part].keys():
            keys.append(part)
            continue
        keys += [f"{part}.{k}" for k, v in want[part].items() if not torch.equal(got[part][k], v)]
    return keys


def broadcast_in_place(group, rank) -> dict:
    """Every tensor of a model and its Adam state set to rank + 1, then
    ``broadcast_state``: whether each kept its storage and holds rank 0's
    value."""
    from dvmvs_tpu_torch.parallel import train as tt

    model = net("pairnet")
    optimizer = tt.make_optimizer(model, tt.PAIRNET_STAGES[-1])
    state = [*model.state_dict().values(), *tt.init_optimizer_state(optimizer)]
    with torch.no_grad():
        for t in state:
            t.fill_(rank + 1)
    storage = [t.data_ptr() for t in state]
    tt.broadcast_state(model, group, optimizer)
    return {"in_place": storage == [t.data_ptr() for t in state],
            "rank0_values": all(bool((t == 1).all()) for t in state), "tensors": len(state)}


# ----------------------------------------------------------------- the tests


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """The JAX results on the concatenated batch, the port's single-process
    results, and the 2-rank workers' results for every case."""
    import jax
    import jax.numpy as jnp

    from dvmvs_tpu.models.fusionnet import FusionNet as JFusionNet
    from dvmvs_tpu.models.pairnet import PairNet as JPairNet
    from dvmvs_tpu.models.training_heads import fusionnet_train_sequence as j_sequence
    from dvmvs_tpu.parallel import train as jt
    from dvmvs_tpu_torch.utils import weights as tw
    from tests.test_torch_models import _randomize_bn

    work = str(tmp_path_factory.mktemp("parallel"))
    xla = {"xla_backend_optimization_level": "1"}
    fb, pb = case_batch("fusionnet"), case_batch("pairnet")
    jf, jp = JFusionNet(MIN_D, MAX_D, P), JPairNet(MIN_D, MAX_D, P)
    j = {k: jnp.asarray(v) for k, v in fb.items()}
    variables = jax.jit(lambda: jf.init(jax.random.PRNGKey(0), j["images"], j["depths"],
                                        j["poses"], j["K"], method=j_sequence),
                        compiler_options=xla)()
    variables = _randomize_bn(variables, np.random.RandomState(1))
    pair_vars = {"params": {k: v for k, v in variables["params"].items() if k != "lstm_fusion"},
                 "batch_stats": variables["batch_stats"]}
    weights = {}
    for kind, v in (("fusionnet", variables), ("pairnet", pair_vars)):
        model = net(kind)
        tw.load_jax_variables(model, v)
        weights[kind] = model.state_dict()
    rng = jax.random.PRNGKey(0)
    flips = [bool(f) for f in np.asarray(jax.random.uniform(rng, (2,)) > 0.5)]
    torch.save(weights, os.path.join(work, "weights.pt"))
    with open(os.path.join(work, "flips.json"), "w") as f:
        json.dump(flips, f)

    # the ranks and the single-process steps run while the JAX steps compile
    procs = start([os.path.abspath(__file__), work]) + start(
        [os.path.abspath(__file__), work, "single"], world=0)
    try:
        # meanwhile: the JAX step (train-mode BatchNorm) and frozen gradients
        jax_out = {}
        for kind, jm, v, b in (("fusionnet", jf, variables, fb), ("pairnet", jp, pair_vars, pb)):
            jb = {k: jnp.asarray(x) for k, x in b.items()}
            stages = jt.FUSIONNET_STAGES if kind == "fusionnet" else jt.PAIRNET_STAGES
            tx = jt.make_optimizer(v["params"], stages[-1], LR)
            step = jt.make_train_step(jm, tx, kind=kind, two_way=kind == "pairnet",
                                      donate=False, compiler_options=xla)
            state, metrics = step(jt.create_train_state(v, tx), jb, rng)
            if kind == "fusionnet":
                lf = lambda p: jt.fusionnet_loss_fn(p, v["batch_stats"], jm, jb,  # noqa: E731
                                                    bn_train=False)
            else:
                lf = lambda p: jt.pairnet_loss_fn(p, v["batch_stats"], jm, jb,  # noqa: E731
                                                  jnp.asarray(flips), two_way=True,
                                                  bn_train=False)
            (frozen_loss, _), grads = jax.jit(jax.value_and_grad(lf, has_aux=True),
                                              compiler_options=xla)(v["params"])
            jax_out[kind] = {
                "loss": float(metrics["loss"]), "frozen_loss": float(frozen_loss),
                "stats": jax.tree.map(np.asarray, state.batch_stats),
                "params": jax.tree.map(np.asarray, state.params),
                "grads": jax.tree.map(np.asarray, grads)}
    except BaseException:
        for p in procs:
            p.kill()
        raise
    finish(procs)
    names = [name for name, *_ in CASES] + [f"{n}_graphed" for n in GRAPHED if "f64" in n]
    ranks = {name: torch.load(os.path.join(work, f"{name}.pt")) for name in names}
    single = {name: torch.load(os.path.join(work, f"single_{name}.pt"))
              for name, _, _, _, dtype, fault in CASES if fault is None and dtype == "float64"}
    by_rank = []
    for r in range(WORLD):
        with open(os.path.join(work, f"rank_{r}.json")) as f:
            by_rank.append(json.load(f))
    return {"jax": jax_out, "single": single, "ranks": ranks, "by_rank": by_rank}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _rel_l2(got, want, floor: float) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), floor))


def _stats(state):
    return {k: v.numpy() for k, v in state.items() if k.endswith(("running_mean", "running_var"))}


def _single_vs_ranks(single, ranks):
    """Relative differences of the 2-rank step from the single process:
    (loss, statistics, the worst gradient's relative L2)."""
    loss = _rel(ranks["loss"], single["loss"])
    stats_s, stats_r = _stats(single["state"]), _stats(ranks["state"])
    stats = max(_rel(stats_r[k], stats_s[k]) for k in stats_s)
    # some BatchNorm biases have a gradient that is zero but for rounding
    # (1e-16 in float64): their norm is floored at 1e-9 of the largest
    floor = 1e-9 * max(np.linalg.norm(g.numpy()) for g in single["grads"].values())
    grads = max(_rel_l2(ranks["grads"][k], g, floor) for k, g in single["grads"].items())
    return loss, stats, grads


@pytest.mark.parametrize("name", ["fusion_f64", "pair_f64", "fusion_unequal_f64",
                                  "fusion_f64_graphed", "pair_f64_graphed"])
def test_two_rank_step_matches_single_process(parity, name):
    """(b), in float64: loss and statistics rtol 1e-5, gradients 1e-4
    relative L2 a tensor; the graphed group step too (g)."""
    single = parity["single"][name.removesuffix("_graphed")]
    loss, stats, grads = _single_vs_ranks(single, parity["ranks"][name])
    print(f"{name}: loss {loss:.2e}, statistics {stats:.2e}, gradients {grads:.2e}")
    assert loss <= SINGLE_RTOL, loss
    assert stats <= SINGLE_RTOL, stats
    assert grads <= GRAD_L2, grads


@pytest.mark.parametrize("kind", ["fusionnet", "pairnet"])
def test_two_rank_step_matches_jax(parity, kind):
    """(a): against the JAX step on the concatenated batch."""
    from dvmvs_tpu_torch.utils import weights as tw

    j = parity["jax"][kind]
    prefix = "fusion" if kind == "fusionnet" else "pair"
    train, frozen = parity["ranks"][f"{prefix}_train"], parity["ranks"][f"{prefix}_frozen"]
    assert _rel(train["loss"], j["loss"]) <= TOL
    assert _rel(frozen["loss"], j["frozen_loss"]) <= TOL
    got_stats = _stats(train["state"])
    n = 0
    for name in tw.MODULE_ENTRIES:
        if kind == "pairnet" and name == "lstm_fusion":
            continue
        want_stats = tw.entries_state_dict(tw.MODULE_ENTRIES[name](), j["params"][name],
                                           j["stats"].get(name, {}))
        want_grads = tw.entries_state_dict(tw.MODULE_ENTRIES[name](), j["grads"][name],
                                           j["stats"].get(name, {}))
        floor = 1e-3 * max(float(np.abs(g.numpy()).max()) for k, g in want_grads.items()
                           if not k.endswith(("running_mean", "running_var")))
        for key, want in want_stats.items():
            full = f"{name}.{key}"
            if key.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(got_stats[full], want.numpy(), rtol=TOL,
                                           atol=TOL * np.abs(want.numpy()).max(), err_msg=full)
                n += 1
            elif full in frozen["grads"]:
                w = want_grads[key].numpy()
                np.testing.assert_allclose(
                    frozen["grads"][full].numpy(), w, rtol=0, err_msg=f"grad {full}",
                    atol=FROZEN_BN_GRAD_TOL * max(np.abs(w).max(), floor))
    assert n > 0


def test_planted_faults_break_the_single_process_check(parity):
    """(c): plain DDP's average of per-rank means on ranks with unequal
    valid counts, and BatchNorm without sync, each fail (b)."""
    single = parity["single"]
    loss, _, grads = _single_vs_ranks(single["fusion_unequal_f64"],
                                      parity["ranks"]["fusion_unequal_mean_f64"])
    assert loss > 100 * SINGLE_RTOL and grads > 100 * GRAD_L2, (loss, grads)
    _, stats, _ = _single_vs_ranks(single["fusion_f64"], parity["ranks"]["fusion_nosync_f64"])
    assert stats > 100 * SINGLE_RTOL, stats


@pytest.mark.parametrize("kind", ["fusionnet", "pairnet"])
def test_world_size_one_is_the_plain_step_bit_for_bit(parity, kind):
    """(d): the data-parallel path in a group of one, in this process."""
    from dvmvs_tpu_torch.parallel import mesh

    case = next(c for c in CASES if c[1] == kind and c[3] == "train" and c[4] == "float32")
    weights = {kind: parity["ranks"][case[0]]["state"]}  # any weights will do
    batch = {k: v[:B_RANK] for k, v in case_batch(kind).items()}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    plain = run_case(case, weights, batch, [True, False])
    group, _ = mesh.init_data_parallel(1, device="cpu")
    try:
        dp = run_case(case, weights, batch, [True, False], group)
    finally:
        mesh.destroy()
        torch.set_num_threads(n)
    assert torch.equal(dp["loss"], plain["loss"])
    for part in ("metrics", "state", "grads"):
        for k, v in plain[part].items():
            assert torch.equal(dp[part][k], v), (part, k)


@pytest.mark.parametrize("name", GRAPHED)
def test_graphed_group_step_equals_the_eager_one_bit_for_bit(parity, name):
    """(g): on every rank, the graphed group step's loss, metrics,
    parameters, BatchNorm buffers and gradients equal the eager group
    step's bit for bit (each rank compares them, ``unequal``)."""
    for rank, result in enumerate(parity["by_rank"]):
        assert result["graphed_differ"][name] == [], (rank, result["graphed_differ"][name][:5])


def test_broadcast_state_writes_in_place(parity):
    """(g): after ``broadcast_state`` every parameter, buffer and Adam state
    tensor of every rank keeps its storage and holds rank 0's values."""
    for rank, result in enumerate(parity["by_rank"]):
        b = result["broadcast"]
        assert b["in_place"] and b["rank0_values"] and b["tensors"] > 100, (rank, b)


def test_every_rank_draws_batches_of_one_shape(monkeypatch):
    """(g): a graph is captured at a batch shape, so every rank must see
    every shape: ``run_training``'s batches drop the last partial global
    batch (7 samples in batches of 4) and cut equal rows, shuffled or not."""
    from dvmvs_tpu_torch.apps import run_training
    from dvmvs_tpu_torch.parallel import mesh

    dataset = [{"x": np.full((3,), i, np.float32)} for i in range(7)]
    monkeypatch.setattr(mesh, "world_size", lambda group=None: WORLD)
    for shuffle in (True, False):
        seen = []
        for rank in range(WORLD):
            monkeypatch.setattr(mesh, "rank", lambda group=None, r=rank: r)
            seen.append([b["x"].shape for b in run_training.rank_batches(
                dataset, 4, shuffle, seed=0, group=object())])
        assert seen[0] == seen[1] == [(2, 3)], (shuffle, seen)


# the index files of the bulk scenes: 5 keyframes (a full and a padded
# batch of 4), a reset, a one-view line; two short scenes (three scenes
# make a full and a padded lockstep group of 2)
BULK_INDEX = {
    "000": ["00002.png 00001.png 00000.png", "00004.png 00003.png 00002.png",
            "00006.png 00005.png", "TRACKING LOST", "00008.png 00007.png 00006.png",
            "00009.png 00008.png 00007.png"],
    "001": ["00001.png 00000.png", "00003.png 00002.png 00001.png",
            "00005.png 00004.png 00003.png"],
    "002": ["00002.png 00001.png 00000.png", "TRACKING LOST", "00005.png 00004.png"],
}


@pytest.fixture(scope="module")
def bulk_data(tmp_path_factory):
    """Three PNG scenes of 10 random 96x64 frames and their index files."""
    from dvmvs_tpu_torch.data.io import write_png

    root = tmp_path_factory.mktemp("bulk")
    os.makedirs(root / "indices")
    rs = np.random.RandomState(11)
    for scene, lines in BULK_INDEX.items():
        folder = root / "tinyset" / scene
        os.makedirs(folder / "images")
        os.makedirs(folder / "depth")
        poses = np.tile(np.eye(4), (10, 1, 1))
        poses[:, 0, 3] = 0.12 * np.arange(10)
        poses[:, 1, 3] = 0.01 * rs.randn(10)
        for i in range(10):
            write_png(str(folder / "images" / f"{i:05d}.png"),
                      rs.randint(0, 255, (64, 96, 3)).astype(np.uint8))
            write_png(str(folder / "depth" / f"{i:05d}.png"),
                      rs.uniform(1500, 3500, (64, 96)).astype(np.uint16))
        np.savetxt(folder / "poses.txt", poses.reshape(10, 16))
        np.savetxt(folder / "K.txt", np.array([[70.0, 0, 48], [0, 70.0, 32], [0, 0, 1]]))
        with open(root / "indices" / f"keyframe+tinyset+{scene}+nmeas+2", "w") as f:
            f.write("\n".join(lines) + "\n")
    return str(root)


@pytest.mark.parametrize("mode", [["--model", "pairnet", "--batch-size", "4"],
                                  ["--model", "fusionnet", "--scene-batch", "2"]],
                         ids=["pairnet", "fusionnet"])
def test_run_testing_on_two_ranks_writes_the_single_process_files(bulk_data, tmp_path, mode):
    """(e): the same files, with equal depths and errors: bit for bit for
    pairnet; within rtol 1e-6 for fusionnet, whose ranks step one scene in
    lockstep where one process steps two, and the CPU's convolutions sum a
    batch of one and of two in different orders (measured 2.3e-7)."""
    from dvmvs_tpu_torch.apps import run_testing

    args = ["--data", bulk_data, "--device", "cpu", "--width", "96", "--height", "64"] + mode
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        run_testing.main(args + ["--output", str(tmp_path / "one")])
    finally:
        torch.set_num_threads(n)
    launch(["-m", "dvmvs_tpu_torch.apps.run_testing", "--n-devices", "2", "--output",
            str(tmp_path / "two")] + args)
    files = sorted(os.listdir(tmp_path / "one"))
    assert files == sorted(os.listdir(tmp_path / "two"))
    assert any("errors" in f for f in files) and any("predictions" in f for f in files)
    for f in files:
        with np.load(tmp_path / "one" / f) as one, np.load(tmp_path / "two" / f) as two:
            if "pairnet" in mode:
                np.testing.assert_array_equal(two["arr_0"], one["arr_0"], err_msg=f)
            else:
                np.testing.assert_allclose(two["arr_0"], one["arr_0"], rtol=1e-6, err_msg=f)


def test_run_testing_refuses_scan_chunk_on_two_devices(bulk_data):
    from dvmvs_tpu_torch.apps import run_testing

    with pytest.raises(SystemExit, match="single-device"):
        run_testing.main(["--data", bulk_data, "--device", "cpu", "--model", "pairnet",
                          "--batch-size", "4", "--scan-chunk", "2", "--n-devices", "2"])


@pytest.fixture(scope="module")
def single_training_run(tmp_path_factory):
    """A small corpus, run_training's arguments and its single-process run
    (one torch thread)."""
    from dvmvs_tpu_torch.apps import run_training
    from dvmvs_tpu_torch.apps.make_synth_scenes import make_corpus

    root = tmp_path_factory.mktemp("training")
    make_corpus(str(root / "corpus"), 1, 1, 0, frames=12, width=64, height=64, workers=2)
    args = ["--model", "pairnet", "--dataset", str(root / "corpus" / "train"),
            "--batch-size", "4", "--epochs", "1", "--finetune-epochs", "1", "--max-steps", "2",
            "--print-frequency", "1", "--image-size", "64", "64", "--device", "cpu"]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = run_training.main(args + ["--run-directory", str(root / "one")])
    finally:
        torch.set_num_threads(n)
    return args, one


@pytest.mark.parametrize("path", [[], ["--no-graphs"]], ids=["graphs", "no_graphs"])
def test_run_training_on_two_ranks_logs_the_single_process_losses(single_training_run, tmp_path,
                                                                  path):
    """``run_training --n-devices 2``, each step a replay of the graphed
    group step (the default; its bodies on static buffers on the CPU) or
    eager (``--no-graphs``): every rank draws the global batch and takes its
    rows, rank 0 alone writes the run directory, and the logged losses and
    validation metrics are the single process's: the first step's loss
    within rtol 1e-5 (the same weights and rows); later ones within
    DRIVER_RTOL, because Adam's first step, about lr * sign(g), turns the
    float32 rounding of train-mode BatchNorm gradients into parameter
    differences (measured 1.8e-4 on the second step's loss)."""
    args, one = single_training_run
    launch(["-m", "dvmvs_tpu_torch.apps.run_training", "--n-devices", "2",
            "--run-directory", str(tmp_path / "two")] + args + path)
    two, = [os.path.join(tmp_path / "two", d) for d in os.listdir(tmp_path / "two")]
    logs = []
    for run in (one, two):
        with open(os.path.join(run, "metrics.jsonl")) as f:
            logs.append([json.loads(line) for line in f])
        assert os.path.exists(os.path.join(run, "pairnet_epoch0.pt"))
    assert [e["tag"] for e in logs[0]] == [e["tag"] for e in logs[1]]
    assert [e["tag"] for e in logs[0]].count("train") == 2
    np.testing.assert_allclose(logs[1][0]["loss"], logs[0][0]["loss"], rtol=SINGLE_RTOL)
    for a, b in zip(*logs):
        for key in ("loss", "l1", "l1_inv", "l1_rel", "huber"):
            if key in a:
                np.testing.assert_allclose(b[key], a[key], rtol=DRIVER_RTOL, err_msg=key)


def test_mesh_refuses_what_it_cannot_run(monkeypatch):
    from dvmvs_tpu_torch.parallel import mesh

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="torchrun"):  # two devices need two processes
        mesh.init_data_parallel(2, device="cpu")
    with pytest.raises(ValueError, match="coordinator"):
        mesh.init_data_parallel(2, multihost=True, device="cpu")
    assert (mesh.world_size(), mesh.rank()) == (1, 0)  # no group was joined
    rows = mesh.shard_rows({"x": np.arange(6), "y": np.arange(12).reshape(6, 2)}, 1, 3)
    np.testing.assert_array_equal(rows["x"], [2, 3])
    np.testing.assert_array_equal(rows["y"], [[4, 5], [6, 7]])
    with pytest.raises(ValueError, match="divide"):
        mesh.shard_rows({"x": np.arange(5)}, 0, 2)


def test_dryrun_multichip_on_two_ranks():
    """(f)."""
    outs = launch(["-m", "dvmvs_tpu_torch.apps.dryrun_multichip", "--n-devices", "2",
                   "--device", "cpu"])
    for out in outs:
        assert "one data-parallel train step OK" in out, out
        assert "one sharded serving step OK" in out, out
        assert "two sharded lockstep recurrent steps OK" in out, out


if __name__ == "__main__":
    (single_worker if sys.argv[2:] == ["single"] else worker)(sys.argv[1])
