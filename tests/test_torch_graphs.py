"""The engine's steps on static buffers (apps/graphs.py, apps/engine.py with
graphs=True) against the eager bodies, the JAX engine's programs and
planted faults, at tests/test_torch_engine.py's tiny size (96x64 frames, 64
planes, V=2).

On the CPU the static-buffer body runs without capture, with the card's
semantics: inputs copied into fixed buffers, state kept only by in-place
writes, outputs in buffers that the next step overwrites. Tolerances:
against the eager path bit for bit (the same operations on the same
values); against the JAX engine's ``_encode_predict``, ``_predict_pair_scan``
and ``_fusion_scan`` rtol 1e-5, the online slice's limit (float32
reordering; measured below 5e-7). Planted faults: a kept feature that
aliases the output buffer must break CV_BF16_RTOL (1e-2) on the cost
volumes, as the bulk tests' faults do; a state reassigned instead of
written in place leaves the cost volume alone (it does not read the state)
and, with seeded weights, moves the depth by only about 2e-7 relative, so
it is held on the recurrent state itself: the LSTM carry after the stream,
max |diff| over max |eager|, must break CV_BF16_RTOL too.

The tests marked ``cuda`` capture and replay on the card and skip here;
they import no jax and run there with ``python -m pytest --noconftest -q
tests/test_torch_graphs.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from dvmvs_tpu_torch.apps import graphs
from dvmvs_tpu_torch.apps import run_testing as rt
from dvmvs_tpu_torch.apps.engine import BANK_ROWS, InferenceEngine
from dvmvs_tpu_torch.apps.graphs import StepGraph
from dvmvs_tpu_torch.config import DepthConfig, TestConfig
from dvmvs_tpu_torch.ops import plane_sweep
from dvmvs_tpu_torch.ops.geometry import inverse_pose
from dvmvs_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from dvmvs_tpu_torch.utils.profiling import counters

H, W, V = 64, 96, 2
RTOL = 1e-5
CV_RTOL, CV_BF16_RTOL = 1e-4, 1e-2
N_FRAMES, RESET_AT = 9, 5  # the stream resets before frame 5
T, B, N_IMAGES, CHUNK = 5, 2, 6, 2  # bulk: 5 steps of 2 in chunks of 2 and a tail


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cfg():
    return TestConfig(image_width=W, image_height=H, depth=DepthConfig(0.25, 20.0, 64),
                      n_measurement_frames=V)


def _pose(i, rs):
    a = 0.02 * rs.randn(3)
    Rz = np.array([[np.cos(a[2]), -np.sin(a[2]), 0], [np.sin(a[2]), np.cos(a[2]), 0], [0, 0, 1]])
    Ry = np.array([[np.cos(a[1]), 0, np.sin(a[1])], [0, 1, 0], [-np.sin(a[1]), 0, np.cos(a[1])]])
    pose = np.eye(4)
    pose[:3, :3] = Rz @ Ry
    pose[:3, 3] = (0.12 * i, 0.01 * rs.randn(), 0.02 * rs.randn())
    return pose


def stream_inputs(seed=3):
    rs = np.random.RandomState(seed)
    frames = [rs.randn(H, W, 3).astype(np.float32) for _ in range(N_FRAMES)]
    poses = [_pose(i, rs) for i in range(N_FRAMES)]
    K = np.array([[70.0, 0, W / 2], [0, 70.0, H / 2], [0, 0, 1]], np.float32)
    return frames, poses, K


def drive(engine, frames, poses, K, reset_at=RESET_AT):
    """The online loop's use of the engine (either package): the first frame
    after a reset is encoded, each later one encoded and predicted against
    the last V cached features, its own kept in the cache. Returns (depths,
    kept features)."""
    cache, depths, kept = [], [], []
    for i, (frame, pose) in enumerate(zip(frames, poses)):
        if i == reset_at:
            engine.reset()
            cache = []
        if not cache:
            cache.append((pose, engine.encode(frame)[0]))
            continue
        meas = cache[-V:][::-1]
        depth, half = engine.encode_and_predict(frame, [m[1] for m in meas], pose,
                                                [m[0] for m in meas], K)
        cache.append((pose, half))
        depths.append(depth)
        kept.append(half)
    return depths, kept


def run_stream(engine, inputs, graphed_cost_volumes=None):
    """(depths, kept features as arrays, final state, cost volumes or None)."""
    engine.reset()
    if graphed_cost_volumes is None:
        depths, kept = drive(engine, *inputs)
        cvs = None
    else:
        with engine.recording_cost_volumes(graphed=graphed_cost_volumes) as cvs:
            depths, kept = drive(engine, *inputs)
    state = [t.cpu().numpy().copy() for t in (engine.carry.h, engine.carry.c, engine.prev_pose,
                                               engine.prev_depth, engine.has_prev)]
    return depths, [k.cpu().numpy() for k in kept], state, cvs


def cv_gap(got, want):
    assert len(got) == len(want) > 0
    return max(float(np.abs(g - w).max() / np.abs(w).max()) for g, w in zip(got, want))


def depth_gap(got, want):
    return max(float(np.max(np.abs(g - w) / np.abs(w))) for g, w in zip(got, want))


@pytest.fixture(scope="module")
def eager_runs():
    """The eager engines' streams with cost volumes, per model kind."""
    inputs = stream_inputs()
    return {kind: run_stream(InferenceEngine(kind, tiny_cfg(), device="cpu", seed=2,
                                             graphs=False), inputs, graphed_cost_volumes=False)
            for kind in ("fusionnet", "pairnet")}


@pytest.mark.parametrize("kind", ["fusionnet", "pairnet"])
def test_static_body_equals_the_eager_body(eager_runs, kind):
    """Depths, kept features, the state after a mid-stream reset and the
    cost volumes of the graph path (run twice, recorded the second time)
    equal the eager path's bit for bit; the two-call path (encode, predict)
    equals the one-step path."""
    inputs = stream_inputs()
    engine = InferenceEngine(kind, tiny_cfg(), device="cpu", seed=2)
    assert engine.graphs
    want = eager_runs[kind]
    got = run_stream(engine, inputs)
    for a, b in zip(got[0] + got[1] + got[2], want[0] + want[1] + want[2]):
        np.testing.assert_array_equal(a, b)
    cvs = run_stream(engine, inputs, graphed_cost_volumes=True)[3]
    assert len(cvs) == len(want[3]) == N_FRAMES - 2
    for a, b in zip(cvs, want[3]):
        np.testing.assert_array_equal(a, b)

    frames, poses, K = inputs
    engine.reset()
    f0 = engine.encode(frames[0])
    d1, f1 = engine.encode_and_predict(frames[1], [f0[0]], poses[1], [poses[0]], K)
    engine.reset()
    d1b = engine.predict(frames[1], engine.encode(frames[1]), [f0[0]], poses[1], [poses[0]], K)
    np.testing.assert_array_equal(d1b, d1)
    np.testing.assert_array_equal(f1.numpy(), engine.encode(frames[1])[0].numpy())
    # one static-buffer step per entry point, reused by every later call
    assert sorted(k[0] for k in engine.step_graphs) == sorted(
        ["encode", "encode_and_predict", "encode_and_predict", "predict"])


def test_planted_faults_break_the_limits(eager_runs, monkeypatch):
    """A kept feature that aliases the output buffer (the cache then holds
    the last frame's features in every entry) breaks the cost-volume limit;
    a recurrent state reassigned instead of written in place (the next step
    then reads the reset state) breaks the limit on the carry. The sound
    graph path stays within both at 0."""
    inputs = stream_inputs()
    depths, kept, state, cvs = eager_runs["fusionnet"]

    def faulted(fault, method):
        with monkeypatch.context() as m:
            m.setattr(InferenceEngine, method, fault)
            engine = InferenceEngine("fusionnet", tiny_cfg(), device="cpu", seed=2)
            return run_stream(engine, inputs, graphed_cost_volumes=True)

    aliased = faulted(lambda self, t: t, "_copy_out")
    alias_gap = cv_gap(aliased[3], cvs)
    kept_same = all(np.array_equal(k, aliased[1][-1]) for k in aliased[1])

    def reassign(self, state, new):
        self.carry, self.prev_pose, self.prev_depth, self.has_prev = new

    stale = faulted(reassign, "_write_state")
    stale_depth, stale_cv = depth_gap(stale[0], depths), cv_gap(stale[3], cvs)
    stale_carry = cv_gap(stale[2][:2], state[:2])
    sound = run_stream(InferenceEngine("fusionnet", tiny_cfg(), device="cpu", seed=2), inputs,
                       graphed_cost_volumes=True)
    sound_cv, sound_depth = cv_gap(sound[3], cvs), depth_gap(sound[0], depths)
    sound_carry = cv_gap(sound[2][:2], state[:2])
    print(f"sound: cost volume gap {sound_cv:.3e}, depth {sound_depth:.3e}, carry "
          f"{sound_carry:.3e}; aliased cache: cost volume gap {alias_gap:.3e}; stale state: "
          f"carry gap {stale_carry:.3e}, depth {stale_depth:.3e}, cost volume {stale_cv:.3e}")
    assert sound_cv == sound_depth == sound_carry == 0.0
    assert kept_same and alias_gap > CV_BF16_RTOL
    assert stale_carry > CV_BF16_RTOL and stale_cv == 0.0


def _jax():
    jax = pytest.importorskip("jax")
    from dvmvs_tpu import config as jconfig
    from dvmvs_tpu.apps.engine import InferenceEngine as JEngine
    return jax, jconfig, JEngine


@pytest.fixture(scope="module")
def jax_engines():
    """(JAX engine, graphed port engine with its weights) per model kind."""
    jax, jconfig, JEngine = _jax()
    jcfg = jconfig.TestConfig(image_width=W, image_height=H,
                              depth=jconfig.DepthConfig(0.25, 20.0, 64), n_measurement_frames=V)
    out = {}
    for kind in ("fusionnet", "pairnet"):
        jengine = JEngine(kind, jcfg)
        variables = jax.tree.map(np.asarray, jengine.variables)
        out[kind] = (jengine, InferenceEngine(kind, tiny_cfg(), device="cpu",
                                              variables=variables))
    return out


@pytest.mark.parametrize("kind", ["fusionnet", "pairnet"])
def test_online_step_matches_jax_encode_predict(jax_engines, kind):
    """The graphed online step against the JAX engine's single-dispatch
    ``_encode_predict`` over the stream with its mid-stream reset."""
    jengine, engine = jax_engines[kind]
    inputs = stream_inputs()
    want, _ = drive(jengine, *inputs)
    jengine.reset()
    got = run_stream(engine, inputs)[0]
    assert len(got) == len(want) == N_FRAMES - 2
    gap = depth_gap(got, [np.asarray(w) for w in want])
    print(f"{kind}: max relative depth gap to JAX _encode_predict {gap:.3e}")
    assert gap <= RTOL


def bulk_inputs(seed=5):
    """Frames (N, H, W, 3), K (B, 3, 3) and T steps of indices, poses, masks
    and keep flags (step 3 resets scene 1), as numpy."""
    rs = np.random.RandomState(seed)
    images = rs.randn(N_IMAGES, H, W, 3).astype(np.float32)
    poses = np.stack([_pose(i, rs) for i in range(N_IMAGES)]).astype(np.float32)
    ref_idx = rs.randint(0, N_IMAGES, (T, B))
    meas_idx = rs.randint(0, N_IMAGES, (T, B, V))
    mask = np.ones((T, B, V), np.float32)
    mask[1, 0, 1] = 0.0
    keep = np.ones((T, B), np.float32)
    keep[3, 1] = 0.0
    K = np.tile(np.array([[70.0, 0, W / 2], [0, 70.0, H / 2], [0, 0, 1]], np.float32), (B, 1, 1))
    xs = {"ref_idx": ref_idx, "meas_idx": meas_idx, "ref_pose": poses[ref_idx],
          "meas_pose": poses[meas_idx], "view_mask": mask, "keep": keep}
    return images, K, xs


def run_chunks(engine, bank, images, K, xs, schedule, final_state=None):
    """The port's bulk chunks over ``xs`` (device tensors) -> (T, B, H, W);
    the final state's carry (h, c) as arrays is appended to ``final_state``."""
    out, state, c = [], engine.init_batch_state(B), 0
    for step in schedule:
        chunk = {k: v[c:c + step] for k, v in xs.items()}
        if engine.kind == "pairnet":
            chunk.pop("keep", None)
            out.append(engine.predict_pair_steps(bank, images, K, chunk))
        else:
            state, depth = engine.fusion_steps(bank, images, K, state, chunk)
            out.append(depth)
        c += step
    if final_state is not None:
        final_state.extend(t.cpu().numpy().copy() for t in state[0])
    return torch.cat(out).cpu().numpy()


def port_bulk(engine, images, K, xs, bank_nhwc):
    to = {k: engine.upload_index(v) if k.endswith("_idx") else engine.upload(v)
          for k, v in xs.items()}
    bank = tuple(torch.from_numpy(np.ascontiguousarray(b.transpose(0, 3, 1, 2)))
                 for b in bank_nhwc)
    return bank, engine.images(images), engine.upload(K), to


@pytest.mark.parametrize("kind", ["pairnet", "fusionnet"])
def test_scanned_chunks_match_jax_scan(jax_engines, kind):
    """On the JAX engine's bank (its ``_extract`` of the frames) and the same
    ``xs``, the port's chunks of 2 and a tail (the scan schedule) against
    one ``_predict_pair_scan`` / ``_fusion_scan`` over all T steps; the
    chunks also equal the eager bodies bit for bit, and each distinct chunk
    length is one static-buffer step."""
    import jax.numpy as jnp

    jengine, engine = jax_engines[kind]
    images, K, xs = bulk_inputs()
    bank_nhwc = tuple(np.asarray(b) for b in jengine._extract(jengine.variables,
                                                             jnp.asarray(images)))
    jxs = {k: jnp.asarray(v.astype(np.int32) if k.endswith("_idx") else v)
           for k, v in xs.items()}
    jbank = tuple(jnp.asarray(b) for b in bank_nhwc)
    if kind == "pairnet":
        jxs.pop("keep")
        want = jengine._predict_pair_scan(jengine.variables, jbank, jnp.asarray(images),
                                          jnp.asarray(K), jxs)
    else:
        _, want = jengine._fusion_scan(jengine.variables, jbank, jnp.asarray(images),
                                       jnp.asarray(K), jengine.init_batch_state(B), jxs)
    want = np.asarray(want)

    schedule = rt._scan_schedule(T, CHUNK)
    assert schedule == [2, 2, 1]
    engine.step_graphs.clear()
    bank, dev_images, dev_K, dev_xs = port_bulk(engine, images, K, xs, bank_nhwc)
    got = run_chunks(engine, bank, dev_images, dev_K, dev_xs, schedule)
    name = "predict_pair_steps" if kind == "pairnet" else "fusion_steps"
    assert sorted(k[0] for k in engine.step_graphs) == [name, name]  # T=2 and T=1
    assert got.shape == want.shape == (T, B, H, W)
    gap = float(np.max(np.abs(got - want) / np.abs(want)))
    print(f"{kind}: chunks {schedule} against the JAX scan over {T} steps: max relative "
          f"depth gap {gap:.3e}")
    assert gap <= RTOL

    engine.graphs = False
    try:
        eager = run_chunks(engine, bank, dev_images, dev_K, dev_xs, schedule)
    finally:
        engine.graphs = True
    np.testing.assert_array_equal(got, eager)

    # a new bank (another address) drops the graphs that read the old one
    bank2 = tuple(b.clone() for b in bank)
    run_chunks(engine, bank2, dev_images, dev_K, dev_xs, [1])
    assert [k[0] for k in engine.step_graphs] == [name]


def test_bank_storage_keeps_the_chunk_graphs_across_banks():
    """``run_testing``'s banks go into the engine's storage, a multiple of
    BANK_ROWS frames a dtype, so a second scene's bank lies at the first
    one's addresses and its chunks replay the graphs captured for the first
    (no capture a scene); a bfloat16 bank takes a new storage, and the
    graphs that read the old one go."""
    images, K, xs = bulk_inputs()
    engine = InferenceEngine("pairnet", tiny_cfg(), device="cpu", seed=1)
    dev_K = engine.upload(K)
    dev_xs = {k: engine.upload_index(v) if k.endswith("_idx") else engine.upload(v)
              for k, v in xs.items()}
    bank, frames = rt._encode_bank(engine, list(range(N_IMAGES)), images.__getitem__, B,
                                   torch.float32)
    assert bank[0].shape[0] == frames.shape[0] == BANK_ROWS
    np.testing.assert_array_equal(frames[:N_IMAGES].numpy(), engine.images(images).numpy())
    first = run_chunks(engine, bank, frames, dev_K, dev_xs, [2, 2, 1])
    captured = dict(engine.step_graphs)

    order = [5, 4, 3, 2, 1, 0]  # another scene: the frames in another order
    bank2, frames2 = rt._encode_bank(engine, order, images.__getitem__, B, torch.float32)
    assert [t.data_ptr() for t in bank2 + (frames2,)] == [t.data_ptr() for t in bank + (frames,)]
    np.testing.assert_array_equal(frames2[:N_IMAGES].numpy(), engine.images(images[order]).numpy())
    swapped = {k: (5 - v if k.endswith("_idx") else v) for k, v in dev_xs.items()}
    second = run_chunks(engine, bank2, frames2, dev_K, swapped, [2, 2, 1])
    np.testing.assert_array_equal(second, first)  # the same frames through the new rows
    assert engine.step_graphs.keys() == captured.keys()
    assert all(engine.step_graphs[k] is g for k, g in captured.items())

    bf16, bf16_frames = rt._encode_bank(engine, order, images.__getitem__, B, torch.bfloat16)
    assert bf16[0].dtype == torch.bfloat16 and bf16[0].shape[0] == BANK_ROWS
    run_chunks(engine, bf16, bf16_frames, dev_K, swapped, [1])
    steps = [k for k in engine.step_graphs if k[0] == "predict_pair_steps"]
    assert len(steps) == 1 and steps[0] not in captured


def test_lockstep_stale_state_breaks_the_bulk_limit(monkeypatch):
    """The chunked lockstep path with its state reassigned instead of written
    in place: every chunk after the first starts from the state the caller
    passed, so the state after the run (held as in the online test) breaks
    CV_BF16_RTOL while the first chunk's depths stay whole."""
    images, K, xs = bulk_inputs()
    engine = InferenceEngine("fusionnet", tiny_cfg(), device="cpu", seed=1)
    bank_t = engine.encode_batch(engine.images(images))
    _, dev_images, dev_K, dev_xs = port_bulk(engine, images, K, xs, ())
    sound_state, stale_state = [], []
    sound = run_chunks(engine, bank_t, dev_images, dev_K, dev_xs, [2, 2, 1], sound_state)

    def reassign(self, state, new):
        self.carry, self.prev_pose, self.prev_depth, self.has_prev = new

    monkeypatch.setattr(InferenceEngine, "_write_state", reassign)
    stale_engine = InferenceEngine("fusionnet", tiny_cfg(), device="cpu", seed=1)
    stale = run_chunks(stale_engine, bank_t, dev_images, dev_K, dev_xs, [2, 2, 1],
                       stale_state)
    np.testing.assert_array_equal(stale[:2], sound[:2])  # the first chunk is whole
    gap = cv_gap(stale_state, sound_state)
    print(f"stale lockstep state: carry gap {gap:.3e}, depth gap "
          f"{float(np.max(np.abs(stale - sound) / np.abs(sound))):.3e}")
    assert gap > CV_BF16_RTOL


@pytest.mark.parametrize("load_first", [True, False], ids=["load_then_step", "step_then_load"])
def test_load_checkpoint_before_and_after_the_first_step(tmp_path, load_first):
    """``load_checkpoint`` copies the weights in place (load_state_dict), so
    a load before the first step and a load after it both take effect on
    the graph path: the stream equals an eager engine built with the
    checkpoint's weights."""
    inputs = stream_inputs()
    source = InferenceEngine("fusionnet", tiny_cfg(), device="cpu", seed=7, graphs=False)
    path = str(tmp_path / "fusionnet.pt")
    save_checkpoint(path, source.model)
    want = run_stream(source, inputs)

    engine = InferenceEngine("fusionnet", tiny_cfg(), device="cpu", seed=0)
    if not load_first:
        before = run_stream(engine, inputs)
        assert depth_gap(before[0], want[0]) > RTOL  # other weights, another stream
    load_checkpoint(path, engine.model)
    got = run_stream(engine, inputs)
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        np.testing.assert_array_equal(a, b)


def test_step_graph_on_the_cpu_keeps_the_card_semantics():
    """A CPU StepGraph: outputs live in buffers the next run overwrites;
    state persists only through in-place writes; its launch counts stay 0."""
    x = torch.zeros(3)
    acc = torch.zeros(3)

    def body(x, acc):
        acc.add_(x)
        return {"sum": acc * 1.0, "twice": [x * 2.0]}

    step = StepGraph("toy", body, {"x": x, "acc": acc}, state=(acc,))
    x.fill_(1.0)
    first = step.run()
    kept = first["sum"].clone()
    x.fill_(2.0)
    second = step.run()
    assert second is first  # the same output buffers
    assert first["sum"].tolist() == [3.0] * 3 and kept.tolist() == [1.0] * 3
    assert first["twice"][0].tolist() == [4.0] * 3
    assert step.launches == (0, 0, 0) and step.graph is None
    assert list(graphs.leaves({"a": (x, [acc])})) == [x, acc]


# --- on the card: capture, replay, counts, failures -------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs capture only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fusionnet", "pairnet"])
def test_replay_equals_eager_on_the_card(cuda_device, kind):
    """Captured steps replay the eager depths, kept features, state and
    cost volumes bit for bit; after the capture each replay adds the one
    forward-kernel launch it holds."""
    inputs = stream_inputs()
    eager = run_stream(InferenceEngine(kind, tiny_cfg(), device=cuda_device, seed=2,
                                       graphs=False), inputs, graphed_cost_volumes=False)
    engine = InferenceEngine(kind, tiny_cfg(), device=cuda_device, seed=2)
    run_stream(engine, inputs)  # captures
    before = counters[plane_sweep.FORWARD_LAUNCHES]
    got = run_stream(engine, inputs)
    assert counters[plane_sweep.FORWARD_LAUNCHES] - before == N_FRAMES - 2
    assert all(s.graph is not None and s.launches[0] in (0, 1)
               for s in engine.step_graphs.values())
    for a, b in zip(got[0] + got[1] + got[2], eager[0] + eager[1] + eager[2]):
        np.testing.assert_array_equal(a, b)
    cvs = run_stream(engine, inputs, graphed_cost_volumes=True)[3]
    for a, b in zip(cvs, eager[3]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_bulk_chunks_replay_equal_eager_on_the_card(cuda_device):
    images, K, xs = bulk_inputs()
    for kind in ("pairnet", "fusionnet"):
        out = {}
        for graphed in (False, True):
            engine = InferenceEngine(kind, tiny_cfg(), device=cuda_device, seed=3,
                                     graphs=graphed)
            bank = engine.encode_batch(engine.images(images))
            _, dev_images, dev_K, dev_xs = port_bulk(engine, images, K, xs, ())
            out[graphed] = run_chunks(engine, bank, dev_images, dev_K, dev_xs, [2, 2, 1])
        np.testing.assert_array_equal(out[True], out[False])


@pytest.mark.cuda
def test_a_syncing_body_raises_instead_of_running_eagerly(cuda_device, monkeypatch):
    x = torch.ones(4, device=cuda_device)
    step = StepGraph("syncs", lambda x: x * float(x.sum().item()), {"x": x})
    with pytest.raises(RuntimeError, match="capture of the engine step 'syncs' failed"):
        step.run()
    engine = InferenceEngine("pairnet", tiny_cfg(), device=cuda_device, seed=0)
    real = InferenceEngine._predict_core

    def syncing(self, *args):
        depth = real(self, *args)
        return depth * float(depth.max().item())

    monkeypatch.setattr(InferenceEngine, "_predict_core", syncing)
    frames, poses, K = stream_inputs()
    f0 = engine.encode(frames[0])
    with pytest.raises(RuntimeError, match="encode_and_predict"):
        engine.encode_and_predict(frames[1], [f0[0]], poses[1], [poses[0]], K)
    assert torch.isfinite(engine.encode(frames[2])[0]).all()  # the context still works


@pytest.mark.cuda
def test_inverse_pose_captures_on_the_card(cuda_device):
    """torch.linalg.inv_ex on batches of 4x4 and 3x3 matrices inside a
    capture replays the eager inverse."""
    rs = np.random.RandomState(0)
    m = torch.from_numpy(np.stack([_pose(i, rs) for i in range(6)]).astype(np.float32)).to(
        cuda_device)
    k = torch.tensor([[[70.0, 0, 48], [0, 70.0, 32], [0, 0, 1]]], device=cuda_device)
    step = StepGraph("inverse", lambda m, k: (inverse_pose(m), inverse_pose(k)),
                     {"m": m, "k": k})
    got = [t.clone() for t in step.run()]
    assert step.graph is not None
    torch.testing.assert_close(got[0], inverse_pose(m), rtol=0, atol=0)
    torch.testing.assert_close(got[1], inverse_pose(k), rtol=0, atol=0)


@pytest.mark.cuda
def test_load_after_capture_takes_effect_on_the_card(cuda_device, tmp_path):
    inputs = stream_inputs()
    source = InferenceEngine("fusionnet", tiny_cfg(), device=cuda_device, seed=7, graphs=False)
    path = str(tmp_path / "fusionnet.pt")
    save_checkpoint(path, source.model)
    want = run_stream(source, inputs)
    engine = InferenceEngine("fusionnet", tiny_cfg(), device=cuda_device, seed=0)
    run_stream(engine, inputs)
    load_checkpoint(path, engine.model)
    got = run_stream(engine, inputs)
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        np.testing.assert_array_equal(a, b)
