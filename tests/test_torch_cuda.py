"""The port's CUDA kernels on the card, against their plain PyTorch versions.

These tests need an NVIDIA GPU and skip elsewhere. They import neither jax
nor the test conftest, so on a machine with the card and without jax they
run as ``python -m pytest --noconftest -q tests/test_torch_cuda.py`` from
the repo root. Forward tolerance, absolute (coordinate fold and order of
summation): 5e-4 for the dot cost, the JAX kernel tests' own; 2e-3 for the
L1 cost, which sums over the channels where the dot cost averages (measured
7.7e-4 at C=32, 7.1e-4 at the baselines' C=3 with a view masked). C <= 4
takes the kernel's small-channel variant (one thread a pixel), held at the
same limits at C = 1-4 in both modes.
Backward: tests/test_pallas_vjp.py's atol 2e-4 * max(|grad|, 1) against
autograd through the plain version.
"""

import json

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import chip_smoke as cs
from dvmvs_tpu_torch import config
from dvmvs_tpu_torch.apps.graphs import WARMUP_RUNS
from dvmvs_tpu_torch.ops import plane_sweep as tps
from dvmvs_tpu_torch.ops.cost_volume import inverse_depth_planes
from dvmvs_tpu_torch.utils.profiling import counters

pytestmark = pytest.mark.cuda

B, V, H, W, P = 1, 2, 128, 160, 64  # the online path's shape at 320x256
ATOL = {True: 5e-4, False: 2e-3}  # by dot_product


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _pose(euler_deg, t):
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = Rotation.from_euler("xyz", euler_deg, degrees=True).as_matrix()
    pose[:3, 3] = t
    return pose


def _case(seed, euler, t, c, device, h=H, w=W):
    rs = np.random.RandomState(seed)
    ref = torch.from_numpy(rs.randn(B, h, w, c).astype(np.float32)).to(device)
    meas = torch.from_numpy(rs.randn(B, V, h, w, c).astype(np.float32)).to(device)
    K = np.array([[0.75 * w, 0, w / 2], [0, 0.75 * w, h / 2], [0, 0, 1]], np.float32)
    poses = np.stack([_pose(euler, t), _pose([1, 2, 0.5], [0.1, 0.02, 0.0])])
    mats = tps.build_plane_matrices(
        torch.eye(4, device=device), torch.from_numpy(poses).to(device),
        torch.from_numpy(K).to(device), inverse_depth_planes(0.25, 20.0, P, device))
    return ref, meas, mats[None].contiguous()


@pytest.mark.parametrize("euler,t,c,weights,dot_product", [
    ([0, 0, 0], [0.12, 0.0, 0.0], 32, [0.5, 0.5], True),      # lateral
    ([2, 3, 1], [0.12, 0.03, 0.02], 32, [0.5, 0.5], True),    # typical
    ([0, 0, 4], [0.05, 0.0, 0.1], 32, [0.5, 0.5], True),      # roll + forward
    ([0, 0, 35], [0.1, 0.0, 0.0], 32, [0.5, 0.5], True),      # extreme roll
    ([0, 120, 0], [0.1, 0.0, 2.0], 32, [0.5, 0.5], True),     # behind the camera
    ([2, 3, 1], [0.12, 0.03, 0.02], 32, [1.0, 0.0], True),    # masked view
    ([2, 3, 1], [0.12, 0.03, 0.02], 30, [0.5, 0.5], True),    # C = 30
    ([2, 3, 1], [0.12, 0.03, 0.02], 64, [0.5, 0.5], True),    # C = 64: two loads a lane
    ([2, 3, 1], [0.12, 0.03, 0.02], 32, [0.5, 0.5], False),   # L1
    ([0, 120, 0], [0.1, 0.0, 2.0], 30, [1.0, 0.0], False),    # L1, C=30, masked
] + [  # the small-channel variant: C = 1-4 in both modes
    pytest.param(euler, t, c, weights, dot, id=f"c{c}_{'dot' if dot else 'l1'}_{name}")
    for c in (1, 2, 3, 4) for dot in (True, False)
    for name, euler, t, weights in (
        ("typical", [2, 3, 1], [0.12, 0.03, 0.02], [0.5, 0.5]),
        ("roll35", [0, 0, 35], [0.1, 0.0, 0.0], [0.5, 0.5]),
        ("behind_camera", [0, 120, 0], [0.1, 0.0, 2.0], [0.5, 0.5]),
        ("masked_view", [2, 3, 1], [0.12, 0.03, 0.02], [1.0, 0.0]))])
def test_kernel_matches_plain(cuda_device, euler, t, c, weights, dot_product):
    ref, meas, mats = _case(0, euler, t, c, cuda_device)
    w = torch.tensor([weights], dtype=torch.float32, device=cuda_device)
    want = tps.plane_sweep_multiview_plain(ref, meas, mats, w, dot_product)
    before = counters[tps.FORWARD_LAUNCHES]
    got = tps.plane_sweep_multiview(ref, meas, mats, w, dot_product)
    torch.cuda.synchronize()
    assert counters[tps.FORWARD_LAUNCHES] == before + 1
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= ATOL[dot_product]


@pytest.mark.parametrize("c", [32, 64])
def test_kernel_at_640x480_frames(cuda_device, c):
    """Half-resolution features of 640x480 frames: the size the TPU kernels,
    which keep whole measurement maps in VMEM, never covered."""
    ref, meas, mats = _case(2, [2, 3, 1], [0.12, 0.03, 0.02], c, cuda_device, 240, 320)
    w = torch.full((1, V), 0.5, device=cuda_device)
    want = tps.plane_sweep_multiview_plain(ref, meas, mats, w)
    got = tps.plane_sweep_multiview(ref, meas, mats, w)
    torch.cuda.synchronize()
    assert got.shape == (1, P, 240, 320)
    assert (got - want).abs().max().item() <= ATOL[True]


@pytest.mark.parametrize("shape", [(3, 1, 32, 37, 45, 11), (2, 5, 8, 16, 70, 3),
                                   (1, 1, 132, 20, 33, 9), (1, 3, 13, 9, 40, 20),
                                   (2, 120, 8, 9, 33, 10), (3, 1, 3, 37, 45, 11),
                                   (1, 2, 3, 255, 317, 64), (2, 120, 3, 9, 33, 10),
                                   (3, 1, 1, 37, 45, 11), (2, 5, 2, 16, 70, 3),
                                   (1, 3, 4, 37, 45, 20)],
                         ids=["ragged_tiles", "many_views", "c132", "c13", "views_over_launches",
                              "c3_ragged_tiles", "c3_255x317", "c3_views_over_launches",
                              "c1_ragged_tiles", "c2_many_views", "c4_ragged_tiles"])
def test_kernel_on_ragged_shapes(cuda_device, shape):
    """Tiles and plane chunks that the image and the planes do not fill, more
    views than the online path has (and more than one launch's shared memory
    holds, summed over three launches, each counted), and channel counts that
    leave a lane's last load short or take the loop over any C; the same
    for the small-channel variant (C <= 4), whose launches are counted
    alike."""
    from dvmvs_tpu_torch.ops.sweep_measure import sweep_case

    B, V_, C, H_, W_, P_ = shape
    ref, meas, mats, w = sweep_case((B, min(V_, 2), C, H_, W_, P_), device=cuda_device)
    if V_ > 2:  # more views: repeat the two with other weights, summing to 1
        meas = meas.repeat(1, V_, 1, 1, 1)[:, :V_].contiguous()
        mats = mats.repeat(1, V_, 1, 1, 1)[:, :V_].contiguous()
        w = torch.linspace(0.0, 1.0, V_, device=cuda_device)
        w = (w / w.sum()).repeat(B, 1)
    for dot in (True, False):
        want = tps.plane_sweep_multiview_plain(ref, meas, mats, w, dot)
        before = counters[tps.FORWARD_LAUNCHES]
        got = tps.plane_sweep_multiview(ref, meas, mats, w, dot)
        torch.cuda.synchronize()
        assert counters[tps.FORWARD_LAUNCHES] - before == -(-V_ // 51)  # 51 views fit one launch
        assert got.shape == (B, P_, H_, W_)
        # the L1 cost sums over the channels: its limit grows with C past 32
        assert (got - want).abs().max().item() <= ATOL[dot] * (max(C / 32, 1) if not dot else 1)


@pytest.mark.parametrize("c,dot_product", [(32, True), (3, False), (3, True)],
                         ids=["c32_dot", "c3_l1", "c3_dot"])
def test_kernel_takes_views_at_unaligned_offsets(cuda_device, c, dot_product):
    """Contiguous views that start one float into their storage cannot use
    16-byte loads; the kernel must fall back to scalar loads (C=32). The
    small-channel variant (C=3) loads scalars at any offset."""
    ref, meas, mats = _case(1, [2, 3, 1], [0.12, 0.03, 0.02], c, cuda_device)
    w = torch.full((1, V), 0.5, device=cuda_device)
    shifted = []
    for t in (ref, meas):
        buf = torch.empty(t.numel() + 1, device=cuda_device)
        buf[1:] = t.reshape(-1)
        shifted.append(buf[1:].view(t.shape))
    assert shifted[0].is_contiguous() and shifted[0].data_ptr() % 16 != 0
    want = tps.plane_sweep_multiview(ref, meas, mats, w, dot_product)
    got = tps.plane_sweep_multiview(shifted[0], shifted[1], mats, w, dot_product)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5
    plain = tps.plane_sweep_multiview_plain(shifted[0], shifted[1], mats, w, dot_product)
    assert (got - plain).abs().max().item() <= ATOL[dot_product]


def test_kernel_rejects_cpu_mix(cuda_device):
    ref, meas, mats = _case(0, [0, 0, 0], [0.1, 0, 0], 32, cuda_device)
    with pytest.raises(ValueError):
        tps.plane_sweep_multiview(ref, meas, mats, torch.full((1, V), 0.5))


@pytest.mark.parametrize("kind", ["fusionnet", "pairnet"])
def test_engine_streams_through_kernel(cuda_device, kind):
    """A short stream on the card launches the kernel once per keyframe and
    gives the CPU engine's depths (same seeded weights, TF32 off). The first
    stream also captures the step graph, whose warm-up runs launch it too;
    after that each replay counts its one launch."""
    from dvmvs_tpu_torch.apps.engine import InferenceEngine
    from dvmvs_tpu_torch.apps.run_testing_online import predict_stream

    cfg = config.TestConfig(image_width=96, image_height=64,
                            depth=config.DepthConfig(0.25, 20.0, 16))
    rs = np.random.RandomState(3)
    frames = [rs.randn(64, 96, 3).astype(np.float32) for _ in range(6)]
    poses = []
    for i in range(6):
        pose = np.eye(4)
        pose[0, 3] = 0.12 * i
        poses.append(pose)
    K = np.array([[70.0, 0, 48], [0, 70.0, 32], [0, 0, 1]], np.float32)
    engine = InferenceEngine(kind, cfg, device=cuda_device, seed=4)
    before = counters[tps.FORWARD_LAUNCHES]
    predictions, indices = predict_stream(engine, frames, poses, K, cfg)
    assert indices == [1, 2, 3, 4, 5]
    assert counters[tps.FORWARD_LAUNCHES] - before == len(predictions) + WARMUP_RUNS
    before = counters[tps.FORWARD_LAUNCHES]
    again, _ = predict_stream(engine, frames, poses, K, cfg)
    assert counters[tps.FORWARD_LAUNCHES] - before == len(predictions)
    for p, q in zip(predictions, again):
        np.testing.assert_array_equal(p, q)
    want, _ = predict_stream(InferenceEngine(kind, cfg, device="cpu", seed=4), frames, poses, K,
                             cfg)
    for p, w in zip(predictions, want):
        assert p.shape == (64, 96) and np.isfinite(p).all()
        assert (p >= 0.25 - 1e-5).all() and (p <= 20.0 + 1e-5).all()
        np.testing.assert_allclose(p, w, rtol=1e-5)


@pytest.mark.parametrize("kind", ["fusionnet", "pairnet"])
def test_engine_step_queues_without_host_sync(cuda_device, kind):
    """Everything up to the depth readback (uploads, features, splat, cost
    volume, network) is queued without a host synchronisation, on the graph
    path (captured by the first step) and on the eager path."""
    from dvmvs_tpu_torch.apps.engine import InferenceEngine

    cfg = config.TestConfig(image_width=96, image_height=64,
                            depth=config.DepthConfig(0.25, 20.0, 16))
    rs = np.random.RandomState(5)
    frames = [rs.randn(64, 96, 3).astype(np.float32) for _ in range(3)]
    poses = [np.eye(4) for _ in range(3)]
    for i, pose in enumerate(poses):
        pose[0, 3] = 0.12 * i
    K = np.array([[70.0, 0, 48], [0, 70.0, 32], [0, 0, 1]], np.float32)
    for graphs in (True, False):
        engine = InferenceEngine(kind, cfg, device=cuda_device, graphs=graphs)
        f0 = engine.encode(frames[0])[0]
        engine.encode_and_predict(frames[1], [f0], poses[1], [poses[0]], K)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.inference_mode():
                depth, half = engine._encode_predict(frames[2], [f0], poses[2], [poses[0]], K)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert depth.shape == (1, 64, 96) and torch.isfinite(depth).all()
        assert half.shape == f0.shape


# --- the backward kernel (csrc/plane_sweep_bwd.cu) and the training path ---


def _grad_close(got, want):
    """test_pallas_vjp.py's gradient limit: atol 2e-4 * max(|grad|, 1)."""
    scale = max(want.abs().max().item(), 1.0)
    err = (got - want).abs().max().item()
    assert err <= cs.GRAD_ATOL * scale, (err, scale)


@pytest.mark.parametrize("case", list(cs.BWD_CASES))
def test_backward_kernel_matches_autograd_through_plain(cuda_device, case):
    """chip_smoke.py's [bwd-compare] cases: the training shape (B=4, V=1,
    C=32, 128x128, P=64) at lateral, typical, 35-degree roll, 120-degree yaw
    behind the camera, a mixed-geometry batch, a wide diagonal motion
    (chunks whose taps outgrow the bins scatter straight to d_meas) and a
    motion 1 m back (samples beyond a full bin scatter straight to d_meas);
    C=30, C=64 and C=13 (scalar loads); meas at an unaligned
    offset; a ragged 37x45; the online shape with its second view masked;
    5 views. d_ref is bit-identical over two calls, and a masked view's
    d_meas exactly 0."""
    ref, meas, mats, w, g = cs.bwd_case(torch, tps, 0, case, cuda_device)
    want_ref, want_meas = tps.plane_sweep_backward_plain(ref, meas, mats, w, g)
    before = counters[tps.BACKWARD_LAUNCHES]
    got_ref, got_meas = tps.plane_sweep_backward(ref, meas, mats, w, g)
    torch.cuda.synchronize()
    assert counters[tps.BACKWARD_LAUNCHES] == before + 1
    assert torch.isfinite(got_ref).all() and torch.isfinite(got_meas).all()
    _grad_close(got_ref, want_ref)
    _grad_close(got_meas, want_meas)
    assert torch.equal(tps.plane_sweep_backward(ref, meas, mats, w, g)[0], got_ref)
    assert (got_meas[w == 0] == 0).all()
    # the forward kernel on the same inputs (K3/K4 where V = 1)
    fwd = tps.plane_sweep_multiview(ref, meas, mats, w)
    assert (fwd - tps.plane_sweep_multiview_plain(ref, meas, mats, w)).abs().max().item() <= \
        ATOL[True]


def test_backward_kernel_with_a_masked_view(cuda_device):
    """The online shape, V=2 with the second view masked: it gets no gradient."""
    ref, meas, mats = _case(3, [2, 3, 1], [0.12, 0.03, 0.02], 32, cuda_device)
    w = torch.tensor([[1.0, 0.0]], device=cuda_device)
    g = torch.randn(1, P, H, W, device=cuda_device, generator=torch.Generator(
        cuda_device).manual_seed(0))
    want_ref, want_meas = tps.plane_sweep_backward_plain(ref, meas, mats, w, g)
    got_ref, got_meas = tps.plane_sweep_backward(ref, meas, mats, w, g)
    torch.cuda.synchronize()
    _grad_close(got_ref, want_ref)
    _grad_close(got_meas, want_meas)
    assert got_meas[0, 1].abs().max().item() == 0.0


def test_wrapper_gradients_on_the_card(cuda_device):
    """R1 on CUDA tensors: with a gradient asked for, the fused wrapper runs
    both kernels and the result carries a grad_fn; L1 mode raises."""
    ref, meas, mats = _case(4, [2, 3, 1], [0.12, 0.03, 0.02], 32, cuda_device)
    w = torch.full((1, V), 0.5, device=cuda_device)
    r, m = ref.clone().requires_grad_(), meas.clone().requires_grad_()
    before = (counters[tps.FORWARD_LAUNCHES], counters[tps.BACKWARD_LAUNCHES])
    out = tps.plane_sweep_multiview(r, m, mats, w)
    assert out.grad_fn is not None
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert (counters[tps.FORWARD_LAUNCHES], counters[tps.BACKWARD_LAUNCHES]) == (before[0] + 1,
                                                                                  before[1] + 1)
    want_r, want_m = ref.clone().requires_grad_(), meas.clone().requires_grad_()
    tps.plane_sweep_multiview_plain(want_r, want_m, mats, w).square().sum().backward()
    _grad_close(r.grad, want_r.grad)
    _grad_close(m.grad, want_m.grad)
    with pytest.raises(NotImplementedError):
        tps.plane_sweep_multiview(r, m, mats, w, dot_product=False)


@pytest.mark.parametrize("freeze_bn", [False, True])
def test_train_step_on_the_card_matches_the_cpu(cuda_device, freeze_bn):
    """One fusionnet train step (stage 2, every module trainable) at 64x64,
    S=3, B=2, P=16 on the card and on the CPU from the same seeded weights,
    held as chip_smoke.py's [train-ref] holds it: loss and BatchNorm
    statistics 1e-4 relative; gradients per tensor 2e-3 of its largest
    |grad| with frozen BatchNorm, and per module 0.1 relative L2 with
    train-mode BatchNorm, whose float32 gradients are ill-conditioned at
    this size (tests/test_torch_training.py measures both)."""
    import copy

    from dvmvs_tpu_torch.apps.run_training import make_model
    from dvmvs_tpu_torch.parallel import train as tt

    cfg = config.TrainConfig(image_width=64, image_height=64,
                             depth=config.DepthConfig(0.25, 20.0, 16))
    cpu = make_model("fusionnet", cfg, "cpu", seed=1).train(not freeze_bn)
    card = copy.deepcopy(cpu).to(cuda_device)
    before = (counters[tps.FORWARD_LAUNCHES], counters[tps.BACKWARD_LAUNCHES])
    metrics = {}
    for model, device in ((card, cuda_device), (cpu, "cpu")):
        opt = tt.make_optimizer(model, tt.FUSIONNET_STAGES[2])
        metrics[device] = tt.train_step(model, opt, cs.small_batch(torch, device), "fusionnet")
    torch.cuda.synchronize()
    assert counters[tps.FORWARD_LAUNCHES] - before[0] == 2
    assert counters[tps.BACKWARD_LAUNCHES] - before[1] == 2
    want = metrics["cpu"]["loss"].item()
    assert abs(metrics[cuda_device]["loss"].item() - want) <= cs.STEP_RTOL * abs(want)
    grad_gap, stat_gap = cs.train_step_gaps(torch, cpu, card, freeze_bn)
    assert grad_gap <= (cs.FROZEN_GRAD_TOL if freeze_bn else cs.TRAIN_GRAD_L2)
    assert stat_gap <= cs.STEP_RTOL


# --- bulk evaluation and TSDF ---


def test_kernel_at_the_bulk_shape(cuda_device):
    """B=8, V=2 (the batched pairnet shape): a geometry per element and the
    second view masked in every other one, launched once."""
    ref, meas, mats, w = cs.bulk_case(torch, tps, 4, cuda_device)
    want = tps.plane_sweep_multiview_plain(ref, meas, mats, w)
    before = counters[tps.FORWARD_LAUNCHES]
    got = tps.plane_sweep_multiview(ref, meas, mats, w)
    torch.cuda.synchronize()
    assert counters[tps.FORWARD_LAUNCHES] == before + 1
    assert (got - want).abs().max().item() <= ATOL[True]


def _bulk_inputs(engine, rs, T, B, n_images):
    """Device-resident frames and bank, and T steps of indices and poses."""
    images = engine.images(rs.randn(n_images, 64, 96, 3).astype(np.float32))
    bank = engine.encode_batch(images)
    poses = np.tile(np.eye(4, dtype=np.float32), (T, B, 3, 1, 1))
    poses[..., 0, 3] = 0.12 * rs.randint(0, 6, (T, B, 3))
    xs = {"ref_idx": engine.upload_index(rs.randint(0, n_images, (T, B))),
          "meas_idx": engine.upload_index(rs.randint(0, n_images, (T, B, 2))),
          "ref_pose": engine.upload(poses[:, :, 0]), "meas_pose": engine.upload(poses[:, :, 1:]),
          "view_mask": engine.upload(np.stack([np.ones((T, B)), rs.randint(0, 2, (T, B))], -1)),
          "keep": engine.upload((rs.rand(T, B) > 0.3).astype(np.float32))}
    K = engine.upload(np.tile([[70.0, 0, 48], [0, 70.0, 32], [0, 0, 1]], (B, 1, 1)))
    return bank, images, K, xs


def run_bulk_steps(engine, kind, bank, images, K, xs):
    if kind == "pairnet":
        return engine.predict_pair_steps(bank, images, K, xs)
    return engine.fusion_steps(bank, images, K, engine.init_batch_state(4), xs)[1]


@pytest.mark.parametrize("kind", ["pairnet", "fusionnet"])
def test_bulk_steps_on_the_card_match_the_cpu(cuda_device, kind):
    """T=3 device-resident steps of B=4 (index_select from the bank, keep
    masks for fusionnet) on the card, queued without a host sync, against
    the same steps on the CPU (same seeded weights, TF32 off). The card
    runs the chunk as one graph replay, after a first call that captures it:
    the replay adds the three launches it holds."""
    from dvmvs_tpu_torch.apps.engine import InferenceEngine

    cfg = config.TestConfig(image_width=96, image_height=64,
                            depth=config.DepthConfig(0.25, 20.0, 16))
    out = {}
    for device in ("cpu", cuda_device):
        engine = InferenceEngine(kind, cfg, device=device, seed=6)
        bank, images, K, xs = _bulk_inputs(engine, np.random.RandomState(7), 3, 4, 6)
        if device != "cpu":  # the first call captures
            run_bulk_steps(engine, kind, bank, images, K, xs)
            torch.cuda.synchronize()
        before = counters[tps.FORWARD_LAUNCHES]
        if device != "cpu":
            torch.cuda.set_sync_debug_mode("error")
        try:
            depth = run_bulk_steps(engine, kind, bank, images, K, xs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        out[str(device)] = depth.cpu().numpy()
        if device != "cpu":
            assert counters[tps.FORWARD_LAUNCHES] - before == 3
    got, want = out[str(cuda_device)], out["cpu"]
    assert got.shape == (3, 4, 64, 96) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_tsdf_integrate_on_the_card_matches_the_cpu(cuda_device):
    """Colour and weight equal, tsdf within 1e-5: the same float32
    operations on either device."""
    from dvmvs_tpu_torch.ops.tsdf import TSDFVolume

    rs = np.random.RandomState(8)
    K = np.array([[50.0, 0, 40.3], [0, 50.0, 29.7], [0, 0, 1]], np.float32)
    vols = [TSDFVolume(np.array([[-1.013, 1.0], [-0.987, 1.0], [0.31, 3.0]]), 0.037, device=d)
            for d in ("cpu", cuda_device)]
    for i in range(4):
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = [0.03 * i, -0.02 * i, -0.5]
        depth = rs.uniform(1.0, 3.0, (60, 80)).astype(np.float32)
        color = rs.randint(0, 256, (60, 80, 3)).astype(np.uint8)
        for v in vols:
            v.integrate(color, depth, K, pose)
    (t_cpu, c_cpu), (t_card, c_card) = (v.get_volume() for v in vols)
    np.testing.assert_array_equal(c_card, c_cpu)
    np.testing.assert_array_equal(vols[1].weight.cpu().numpy(), vols[0].weight.numpy())
    np.testing.assert_allclose(t_card, t_cpu, atol=1e-5)
    assert (vols[0].weight.numpy() > 0).sum() > 1000


@pytest.mark.parametrize("weights", [(0.5, 0.5), (1.0, 0.0)], ids=["two_views", "masked"])
def test_kernel_at_the_baselines_l1_rgb_shape(cuda_device, weights):
    """MVDepthNet's and GP-MVS's sweep: normalised RGB (C=3) at 256x320 in
    L1 mode over planes at 0.5-50 m, within the L1 limit (measured up to
    7.1e-4 with a view masked: the gap does not shrink with C)."""
    from dvmvs_tpu_torch.ops.sweep_measure import sweep_case

    ref, meas, mats, w = sweep_case(cs.BASELINE_SWEEP, weights=weights, device=cuda_device,
                                    depths=cs.BASELINE_DEPTHS)
    want = tps.plane_sweep_multiview_plain(ref, meas, mats, w, False)
    before = counters[tps.FORWARD_LAUNCHES]
    got = tps.plane_sweep_multiview(ref, meas, mats, w, False)
    torch.cuda.synchronize()
    assert counters[tps.FORWARD_LAUNCHES] == before + 1
    assert got.shape == (1, 64, 256, 320) and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= ATOL[False]


@pytest.mark.parametrize("name", ["mvdepthnet", "gpmvs", "dpsnet", "deltas"])
def test_baselines_on_the_card_match_the_cpu(cuda_device, name):
    """Each baseline at a small size, same seeded weights, two keyframes
    (the second after GP-MVS's Kalman step has state): the card's depth
    within rtol 1e-5 of the CPU's; one forward launch a keyframe for the
    U-Nets (on the graphed default, the first predict's WARMUP_RUNS warm-up
    runs before the capture launch it too), none for DPSNet and DELTAS.
    DELTAS is held on the raw depth of its dense stages with the CPU's
    keypoints (a near-tie may flip one).
    The poses carry a small rotation: under a pure translation DPSNet's
    label 0 (depth 4e16) maps border pixels exactly onto the grid's edge,
    where the reference's rule (out of [-1, 1] -> 2, a zero sample) turns on
    the last bit of the projection, which the card and the CPU round
    differently (ROADMAP, Queue 3)."""
    import dvmvs_tpu_torch.apps.run_testing_baseline  # noqa: F401 (registry)
    from dvmvs_tpu_torch.baselines import BASELINE_REGISTRY
    from dvmvs_tpu_torch.baselines.dpsnet import DPSNetModel
    from dvmvs_tpu_torch.models.layers import seeded_model
    from dvmvs_tpu_torch.ops.sweep_measure import pose

    w, h = {"dpsnet": (128, 128), "deltas": (64, 48)}.get(name, (96, 64))
    cls = type("Small", (BASELINE_REGISTRY[name],), {"image_width": w, "image_height": h})
    ests = {d: cls(device=d, seed=5) for d in ("cpu", cuda_device)}
    if name == "dpsnet":  # 8 labels
        for d, est in ests.items():
            est.model = seeded_model(DPSNetModel(8), 5, d)
    rs = np.random.RandomState(9)
    images = [rs.randn(h, w, 3).astype(np.float32) for _ in range(4)]
    # no DPSNet sample within 1e-5 of the edge for these (checked on the CPU)
    poses = [pose(0.7 * i, -0.56 * i, 0.42 * i, (0.1 * i, 0.01 * i, 0.0)).astype(np.float64)
             for i in range(4)]
    K = np.array([[0.8 * w, 0, w / 2], [0, 0.8 * w, h / 2], [0, 0, 1]], np.float32)
    frames = [(images[2], [images[1], images[0]], poses[2], [poses[1], poses[0]]),
              (images[3], [images[2]], poses[3], [poses[2]])]
    if name == "deltas":
        with torch.inference_mode():
            want = ests["cpu"].model.stages(*ests["cpu"].inputs(*frames[0], K))
            got = ests[cuda_device].model.stages(*ests[cuda_device].inputs(*frames[0], K),
                                                 keypoints=want["keypoints"].to(cuda_device))
        d = want["depth"].numpy()
        assert np.abs(got["depth"].cpu().numpy() - d).max() <= 1e-5 * np.abs(d).max()
        return
    out = {}
    for d, est in ests.items():
        before = counters[tps.FORWARD_LAUNCHES]
        out[d] = [est.predict(*f[:4], K) for f in frames]
        if d != "cpu":
            want = 2 + WARMUP_RUNS if name in ("mvdepthnet", "gpmvs") else 0
            assert counters[tps.FORWARD_LAUNCHES] - before == want
    for got, want in zip(out[cuda_device], out["cpu"]):
        assert got.shape == (h, w) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_profile_baselines_reports_every_stage(cuda_device, tmp_path):
    """apps/profile_baselines.py at full size, one timed call a stage: every
    stage timed, DELTAS's largest leaf allocation named, no kernel launched
    outside a graphed predict, DELTAS's DLT-solve kernel counted and timed
    at every replay."""
    from dvmvs_tpu_torch.apps import profile_baselines

    out = tmp_path / "profile.json"
    profile_baselines.main(["--reps", "1", "--keyframes", "2", "--rounds", "1", "--out",
                            str(out)])
    result = json.loads(out.read_text())
    assert {"mvdepthnet", "dpsnet", "deltas"} <= set(result)
    for name in ("mvdepthnet", "dpsnet", "deltas"):
        assert all(v > 0 for k, v in result[name].items() if k.endswith("ms") or "ms " in k)
    assert result["deltas"]["leaf_peak_mib"]
    for name, graphs in cs.BASELINE_GRAPHS.items():
        r = result["paths"][name]
        assert r["depth_gap"] <= cs.BASELINE_RTOL and r["captured_steps"] == graphs
        assert r["graphs"]["host_launches_per_predict"]["cudaGraphLaunch"] == graphs
        assert r["eager"]["host_launches_per_predict"]["cudaLaunchKernel"] > 0
        assert r["graphs"]["host_launches_per_predict"]["cudaLaunchKernel"] == 0
        assert all(r[m]["predict_ms"]["median"] > 0 for m in ("graphs", "eager"))
    deltas_paths = result["paths"]["deltas"]
    assert deltas_paths["dlt_solve_launches_graphed_pass"] == deltas_paths["keyframes"]
    assert all(deltas_paths[m]["dlt_solve_ms"] > 0 for m in ("graphs", "eager"))


def _small_baseline(name, device, graphs):
    """The seeded estimator at a small size (DPSNet with 8 labels)."""
    import dvmvs_tpu_torch.apps.run_testing_baseline  # noqa: F401 (registry)
    from dvmvs_tpu_torch.baselines import BASELINE_REGISTRY
    from dvmvs_tpu_torch.baselines.dpsnet import DPSNetModel
    from dvmvs_tpu_torch.models.layers import seeded_model

    w, h = {"dpsnet": (128, 128), "deltas": (64, 48)}.get(name, (96, 64))
    cls = type("Small", (BASELINE_REGISTRY[name],), {"image_width": w, "image_height": h})
    est = cls(device=device, seed=5, graphs=graphs)
    if name == "dpsnet":
        est.model = seeded_model(DPSNetModel(8), 5, device)
    rs = np.random.RandomState(9)
    images = [rs.randn(h, w, 3).astype(np.float32) for _ in range(5)]
    poses = [np.eye(4) for _ in range(5)]
    for i, p in enumerate(poses):
        p[:3, 3] = (0.1 * i, 0.01 * i, 0.0)
    K = np.array([[0.8 * w, 0, w / 2], [0, 0.8 * w, h / 2], [0, 0, 1]], np.float32)
    frames = [(images[i], [images[i - 1], images[i - 2]], poses[i], [poses[i - 1], poses[i - 2]],
               K) for i in range(2, 5)]
    return est, frames


@pytest.mark.parametrize("name", ["mvdepthnet", "gpmvs", "dpsnet", "deltas"])
def test_baselines_graphed_equal_eager_on_the_card(cuda_device, name):
    """Each baseline at a small size: the graphed predict (captured at the
    first keyframe) equals the eager one bit for bit on the depth each reads
    back (DELTAS's before its clip), over three keyframes (GP-MVS through
    its Kalman state); after the capture the forward kernel counts one
    launch a replay in the U-Nets, none in DPSNet and DELTAS."""
    raw = {}
    for graphs in (False, True):
        est, frames = _small_baseline(name, cuda_device, graphs)
        raw[graphs] = []
        est._readback = lambda d, real=type(est)._readback, out=raw[graphs]: (
            out.append(real(d)), out[-1])[1]
        est.predict(*frames[0])
        before = counters[tps.FORWARD_LAUNCHES]
        for f in frames[1:]:
            est.predict(*f)
        want = len(frames) - 1 if name in ("mvdepthnet", "gpmvs") else 0
        assert counters[tps.FORWARD_LAUNCHES] - before == want
    assert all(s.graph is not None for s in est.step_graphs.values())
    assert len(est.step_graphs) == cs.BASELINE_GRAPHS[name]
    for got, want in zip(raw[True], raw[False]):
        np.testing.assert_array_equal(got, want)


def test_a_failed_baseline_capture_raises(cuda_device, monkeypatch):
    """A forward that syncs with the host cannot be captured: the graphed
    predict raises, naming the estimator's eager switch, and does not run
    eagerly instead; the eager path runs the same forward."""
    from dvmvs_tpu_torch.baselines.mvdepthnet import MVDepthNetModel

    real = MVDepthNetModel.forward

    def syncing(self, *args):
        depth = real(self, *args)
        return depth * float(depth.max().item())

    monkeypatch.setattr(MVDepthNetModel, "forward", syncing)
    est, frames = _small_baseline("mvdepthnet", cuda_device, graphs=False)
    assert np.isfinite(est.predict(*frames[0])).all()
    est, frames = _small_baseline("mvdepthnet", cuda_device, graphs=True)
    with pytest.raises(RuntimeError, match=r"capture of the Small step 'forward' failed.*"
                                           r"Small\(\.\.\., graphs=False\)"):
        est.predict(*frames[0])


# --- the training and validation steps as CUDA graphs ---


def _train_case(kind, device, size=64, s=None, b=2):
    """A seeded model at ``size`` (P=16) and three seeded batches on the card."""
    from dvmvs_tpu_torch.apps.run_training import make_model

    cfg = config.TrainConfig(image_width=size, image_height=size,
                             depth=config.DepthConfig(0.25, 20.0, 16))
    s = s or (3 if kind == "fusionnet" else 2)
    batches = [cs.small_batch(torch, device, seed=i, s=s, b=b, size=size) for i in range(3)]
    return make_model(kind, cfg, device, seed=1).train(), batches


def _train_runs(kind, device, modes, group=None):
    """Three steps of "eager" and of each of ``modes`` from one seeded model
    (chip_smoke.py's ``lockstep_train_runs``: each step from the eager run's
    state before it), every module trainable, deterministic cuDNN; the mode
    "fault" with the planted fault's Adam; with ``group`` the data-parallel
    step. Returns {mode: gaps to the eager run} (``lockstep_gaps``, the
    noise leaves left out) and the plane-sweep launches of the graphed steps
    after the first."""
    from dvmvs_tpu_torch.parallel import train as tt

    base, batches = _train_case(kind, device)
    modules = (tt.FUSIONNET_STAGES if kind == "fusionnet" else tt.PAIRNET_STAGES)[-1]
    flips = [torch.tensor(f) for f in cs.FLIPS]
    torch.backends.cudnn.deterministic = True
    try:
        runs, before, launches = cs.lockstep_train_runs(
            torch, base, kind, batches, flips, cs.lockstep_optimizer(torch, modules, 1e-4),
            modes, group)
    finally:
        torch.backends.cudnn.deterministic = False
    noisy = cs.noise_leaves(runs)
    return {m: cs.lockstep_gaps(runs[m], runs, before, noisy) for m in modes}, launches


@pytest.mark.parametrize("kind", ["fusionnet", "pairnet"])
def test_graphed_train_step_equals_eager_on_the_card(cuda_device, kind):
    """Three steps (two-way pairnet) graphed and eagerly from one seeded
    model, each from the eager run's state before it, both with the
    capturable Adam: losses, parameters, BatchNorm buffers, Adam moments and
    step counts bit for bit, or, where the eager path does not repeat
    itself bit for bit, inside chip_smoke.py's [train-graphs] limits
    (``train_gaps_within``: the larger of STEP_RTOL and EAGER_GAP_FACTOR
    times the eager run-to-run gap); the plane-sweep kernels counted at each
    replay as a step launches them (S-1 = 2 of each a fusionnet step at
    S=3, 2 of each a two-way pairnet step)."""
    gaps, launches = _train_runs(kind, cuda_device, ("repeat", "graphs"))
    assert cs.train_gaps_within(gaps["graphs"], gaps["repeat"]), gaps
    assert gaps["graphs"]["steps"] == 0.0, gaps
    assert launches["graphs"] == (4, 4)  # two replays of 2 forward and 2 backward launches


@pytest.mark.parametrize("kind", ["fusionnet", "pairnet"])
def test_graphed_group_step_equals_eager_on_the_card(cuda_device, kind):
    """The data-parallel step in an NCCL group of one, graphed (the
    gradient, loss and metric all-reduces inside the graph) against eager,
    as test_graphed_train_step_equals_eager_on_the_card; the planted fault
    breaks the limits."""
    from dvmvs_tpu_torch.parallel import mesh

    group, _ = mesh.init_data_parallel(1, device="cuda")
    try:
        gaps, launches = _train_runs(kind, cuda_device, ("repeat", "graphs", "fault"), group)
    finally:
        mesh.destroy()
    assert cs.train_gaps_within(gaps["graphs"], gaps["repeat"]), gaps
    assert not cs.train_gaps_within(gaps["fault"], gaps["repeat"]), gaps
    assert launches["graphs"] == (4, 4)


def test_reassigned_adam_state_breaks_the_graphed_step(cuda_device):
    """The planted fault: an Adam that rebinds its state to copies before
    each update. Eagerly the same steps; replays read the tensors bound at
    the capture, so the moments, step counts and parameters leave the eager
    run's by far more than its run-to-run gap."""
    gaps, _ = _train_runs("pairnet", cuda_device, ("repeat", "fault"))
    assert not cs.train_gaps_within(gaps["fault"], gaps["repeat"]), gaps
    assert gaps["fault"]["exp_avg"] > 1e-2 and gaps["fault"]["steps"] > 1e-2, gaps


def test_train_graph_warmup_leaves_the_state_as_it_was(cuda_device):
    """The capture's warm-up runs train for real on a side stream; the
    parameters, BatchNorm buffers and Adam state (step counts included) are
    restored after them, bit for bit, and the capture itself runs nothing."""
    from dvmvs_tpu_torch.parallel import train as tt

    model, batches = _train_case("fusionnet", cuda_device)
    optimizer = tt.make_optimizer(model, tt.FUSIONNET_STAGES[2])
    steps = tt.GraphedTrainStep(model)
    steps.optimizer = optimizer
    step = steps._graph("train", batches[0])
    for key, buffer in step.args["batch"].items():
        buffer.copy_(batches[0][key])
    state = [*model.parameters(), *model.buffers(), *tt.init_optimizer_state(optimizer)]
    before = [t.detach().clone() for t in state]
    step._capture()
    torch.cuda.synchronize()
    assert step.graph is not None
    for got, want in zip(state, before):
        assert torch.equal(got, want)
    steps_taken = {float(optimizer.state[p]["step"]) for p in optimizer.param_groups[0]["params"]}
    assert steps_taken == {0.0}


def test_graphed_train_step_is_one_graph_launch(cuda_device):
    """After the capture a step is one ``cudaGraphLaunch``; besides it only
    the batch and flip copies, no kernel launch (profiler runtime events)."""
    from dvmvs_tpu_torch.apps.profile_step import TRAIN_RANGE, api_calls, launches_per_call
    from dvmvs_tpu_torch.apps.profile_step import trace_events
    from dvmvs_tpu_torch.parallel import train as tt

    model, batches = _train_case("pairnet", cuda_device)
    optimizer = tt.make_optimizer(model, tt.PAIRNET_STAGES[1])
    steps = tt.GraphedTrainStep(model, "pairnet", two_way=True)
    flip = torch.tensor([True, False])
    steps.train(optimizer, batches[0], flip)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for batch in batches[1:]:
            with torch.profiler.record_function(TRAIN_RANGE):
                steps.train(optimizer, batch, flip)
        torch.cuda.synchronize()
    calls = api_calls(trace_events(prof), TRAIN_RANGE)
    per_step = launches_per_call(calls)
    assert calls["ranges"] == 2, calls
    assert per_step["cudaGraphLaunch"] == 1.0 and per_step["cudaLaunchKernel"] == 0.0, calls


def test_eager_capturable_train_step_queues_without_host_sync(cuda_device):
    """The eager step with the capturable Adam queues without a host
    synchronisation, the property a capture needs."""
    from dvmvs_tpu_torch.parallel import train as tt

    model, batches = _train_case("fusionnet", cuda_device)
    optimizer = tt.make_optimizer(model, tt.FUSIONNET_STAGES[2])
    tt.init_optimizer_state(optimizer)
    tt.train_step(model, optimizer, batches[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = tt.train_step(model, optimizer, batches[1])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(metrics["loss"]).item()


def stage_switch_kept():
    """fusionnet's three stages, two graphed steps each, at 128x128 S=4 on
    the card: what stays reserved after each stage once the cache is given
    back, less the stage's Adam state, and whether an earlier stage's graph
    outlived a switch."""
    import gc
    import weakref

    from dvmvs_tpu_torch.parallel import train as tt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, batches = _train_case("fusionnet", torch.device("cuda"), size=128, s=4)
    steps = tt.GraphedTrainStep(model)
    kept, graphs, stale = [], [], False
    for modules in tt.FUSIONNET_STAGES:
        optimizer = tt.make_optimizer(model, modules)
        for batch in batches[:2]:
            steps.train(optimizer, batch)
        torch.cuda.synchronize()
        stale = stale or any(g() is not None for g in graphs)
        graphs += [weakref.ref(g.graph) for g in steps.graphs.values()]
        gc.collect()
        torch.cuda.empty_cache()
        state = sum(t.numel() * t.element_size() for t in tt.init_optimizer_state(optimizer))
        kept.append(torch.cuda.memory_reserved() - state)
    return {"kept_mib": [k / 2 ** 20 for k in kept], "stale": stale}


def test_a_new_stage_frees_the_old_graph_pool(cuda_device):
    """Each new optimizer drops the last stage's graph (garbage after the
    switch), its gradients and its pool: what stays reserved after stage 3,
    less its Adam state, is at most 1.2 times what stage 1 left (piled up,
    three pools; measured 1.08 alone, stage 3's larger update adding). It
    runs in a fresh process: after the other card tests in one process,
    what stays reserved grew 1.06 GB a stage with every earlier graph
    already garbage, and 0.1 GB alone (``stage_switch_kept``, measured on
    an NVIDIA H100 80GB HBM3)."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # by path: a package called ``tests`` elsewhere on sys.path would win
    code = ("import importlib.util, json, sys; sys.path.insert(0, '.'); spec = importlib.util."
            "spec_from_file_location('card_tests', 'tests/test_torch_cuda.py'); module = "
            "importlib.util.module_from_spec(spec); spec.loader.exec_module(module); "
            "print(json.dumps(module.stage_switch_kept()))")
    run = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    result = json.loads(run.stdout.strip().splitlines()[-1])
    kept = result["kept_mib"]
    assert not result["stale"] and kept[2] <= 1.2 * kept[0], result


def test_a_failed_train_capture_raises(cuda_device, monkeypatch):
    """A step that syncs with the host cannot be captured: the graphed step
    raises, naming --no-graphs, and does not run eagerly instead."""
    from dvmvs_tpu_torch.parallel import train as tt

    real = tt.fusionnet_loss_fn

    def syncing(*args, **kwargs):
        loss, metrics = real(*args, **kwargs)
        return loss * float(loss.detach().item() > 0), metrics

    monkeypatch.setattr(tt, "fusionnet_loss_fn", syncing)
    model, batches = _train_case("fusionnet", cuda_device)
    optimizer = tt.make_optimizer(model, tt.FUSIONNET_STAGES[2])
    with pytest.raises(RuntimeError, match=r"capture of run_training's step 'train' "
                                           r"failed.*run_training --no-graphs"):
        tt.GraphedTrainStep(model).train(optimizer, batches[0])
