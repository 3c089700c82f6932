"""The arithmetic of ops/sweep_measure.py, apps/bench_plane_sweep.py and
apps/bench_dlt.py, on the CPU: the bound counts the bytes every input and
output needs once and the flops of the in-range samples only, the ptxas
report pairs each kernel with its registers and spills, and the DLT bench's
check ignores a vector's sign."""

import numpy as np
import pytest
import torch

from dvmvs_tpu_torch.apps import bench_dlt
from dvmvs_tpu_torch.apps import bench_plane_sweep as bench
from dvmvs_tpu_torch.ops import sweep_measure as measure

SHAPE = (2, 2, 8, 12, 16, 5)  # B, V, C, H, W, P


def test_identity_samples_are_all_in_range():
    B, V, C, H, W, P = SHAPE
    ref, meas, mats, w = measure.sweep_case(SHAPE, device="cpu")
    identity = torch.eye(3).expand_as(mats).contiguous()
    assert measure.in_range_samples(identity, w, H, W) == B * V * P * H * W
    bound = measure.sweep_bound(ref, meas, identity, w)
    assert bound["flops"] == B * V * P * H * W * C * measure.FWD_FLOPS
    assert bound["bytes"] == 4 * (B * H * W * C + B * V * H * W * C + mats.numel() + w.numel()
                                  + B * P * H * W)
    assert bound["bound_ms"] == pytest.approx(max(
        bound["bytes"] / measure.PEAK_BYTES_PER_S, bound["flops"] / measure.PEAK_F32_FLOPS) * 1e3)


def test_masked_views_and_samples_off_the_image_cost_nothing():
    B, V, C, H, W, P = SHAPE
    ref, meas, mats, w = measure.sweep_case(SHAPE, device="cpu")
    identity = torch.eye(3).expand_as(mats).contiguous()
    masked = torch.tensor([[1.0, 0.0]] * B)
    assert measure.in_range_samples(identity, masked, H, W) == B * P * H * W
    # a shift by W pixels moves every sample of view 0 off the image
    shifted = identity.clone()
    shifted[:, 0, :, 0, 2] = 2.0 * W
    assert measure.in_range_samples(shifted, w, H, W) == B * P * H * W
    forward = measure.sweep_bound(ref, meas, identity, masked)
    backward = measure.sweep_bound(ref, meas, identity, masked, backward=True)
    assert forward["flops"] == B * P * H * W * C * measure.FWD_FLOPS
    assert backward["flops"] == B * P * H * W * C * measure.BWD_FLOPS
    assert backward["bytes"] - forward["bytes"] == 4 * (B * H * W * C + B * H * W * C)


def test_typical_geometry_leaves_some_samples_off_the_image():
    B, V, C, H, W, P = SHAPE
    _, _, mats, w = measure.sweep_case(SHAPE, device="cpu")
    n = measure.in_range_samples(mats, w, H, W)
    assert 0.5 * B * V * P * H * W < n < B * V * P * H * W


def test_ptxas_report_pairs_kernels_with_registers_and_spills():
    fwd = ("_ZN47_GLOBAL__N__5b31680f_14_plane_sweep_cu_45ba030518plane_sweep_kernel"
           "ILi4ELi2ELb1EEEvPKfS2_S2_S2_Pfiiiiiif")
    bwd = "_ZN12_GLOBAL__N_122plane_sweep_bwd_kernelILb0EEEvPKfS2_S2_S2_S2_PfS3_iiiiif"
    small = ("_ZN47_GLOBAL__N__5b31680f_14_plane_sweep_cu_45ba030524plane_sweep_small_kernel"
             "ILi3ELb0EEEvPKfS2_S2_S2_Pfiiiiiib")
    log = "\n".join([
        "ptxas info    : 0 bytes gmem",
        f"ptxas info    : Compiling entry function '{fwd}' for 'sm_90a'",
        f"ptxas info    : Function properties for {fwd}",
        "    16 bytes stack frame, 16 bytes spill stores, 48 bytes spill loads",
        "ptxas info    : Used 64 registers, used 1 barriers, 2048 bytes smem",
        f"ptxas info    : Compiling entry function '{bwd}' for 'sm_90a'",
        f"ptxas info    : Function properties for {bwd}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, 388 bytes cmem[0]",
        f"ptxas info    : Function properties for {small}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 38 registers, 388 bytes cmem[0]",
        "ptxas info    : Function properties for _Z5otherv",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 8 registers",
    ])
    assert bench.ptxas_report(log) == {
        "plane_sweep_kernel<4,2,1>": "64 registers, 16 bytes spilled",
        "plane_sweep_bwd_kernel<0>": "40 registers, 0 bytes spilled",
        "plane_sweep_small_kernel<3,0>": "38 registers, 0 bytes spilled",
        "_Z5otherv": "8 registers, 0 bytes spilled"}
    assert bench.ptxas_report("") == {}


def test_ptxas_report_names_the_dlt_kernels():
    """The DLT solve's kernel at each chunk height (chip_smoke.py [build]
    reports them)."""
    prefix = "_ZN45_GLOBAL__N__0d700ce6_12_dlt_solve_cu_5d7a3b41"
    log = "\n".join([
        f"ptxas info    : Function properties for {mangled}\n"
        f"    0 bytes stack frame, {spill} bytes spill stores, 0 bytes spill loads\n"
        f"ptxas info    : Used {regs} registers, used 0 barriers, 392 bytes cmem[0]"
        for mangled, regs, spill in (
            (f"{prefix}16dlt_solve_kernelILi8EEEvPKfPfli", 64, 0),
            (f"{prefix}16dlt_solve_kernelILi16EEEvPKfPfli", 92, 0))])
    assert bench.ptxas_report(log) == {
        "dlt_solve_kernel<8>": "64 registers, 0 bytes spilled",
        "dlt_solve_kernel<16>": "92 registers, 0 bytes spilled"}


def test_dlt_bench_gap_ignores_the_sign_and_sees_a_swap():
    """The DLT bench's check: the plain solve against float64 is near 0
    whatever the sign of each homogeneous solution, and a Vh whose last two
    rows are swapped is far from it."""
    from dvmvs_tpu_torch.baselines.deltas import dlt_system
    from dvmvs_tpu_torch.ops import dlt

    proj, points, conf = (torch.from_numpy(a) for a in measure.dlt_case(seed=0, B=1, Kn=16))
    A = dlt_system(proj, points, conf).contiguous()
    want = dlt.dlt_solve_plain(A.double())
    vh = dlt.dlt_solve_plain(A)
    flipped = vh * torch.tensor([1.0, 1.0, 1.0, -1.0])[:, None]
    assert bench_dlt.homogeneous_gap(vh, want) < 1e-4
    assert bench_dlt.homogeneous_gap(flipped, want) == bench_dlt.homogeneous_gap(vh, want)
    assert bench_dlt.homogeneous_gap(vh[..., [0, 1, 3, 2], :], want) > 0.1
    args = bench_dlt.parse_args(["--baseline", "a.cu", "--baseline", "b.cu", "--batch", "8"])
    assert (args.baseline, args.batch) == (["a.cu", "b.cu"], 8)
    assert bench.turns(args.baseline) == ["a.cu", "b.cu", "current", "current", "b.cu", "a.cu"]


def test_pose_matches_scipy():
    from scipy.spatial.transform import Rotation

    got = measure.pose(10, -20, 35, (0.1, 0.2, 0.3))
    want = Rotation.from_euler("xyz", [10, -20, 35], degrees=True).as_matrix()
    np.testing.assert_allclose(got[:3, :3], want, atol=1e-6)
    np.testing.assert_array_equal(got[:3, 3], np.float32([0.1, 0.2, 0.3]))
    np.testing.assert_array_equal(got[3], [0, 0, 0, 1])


def test_bench_parses_the_backward_mode():
    args = bench.parse_args(["--kernel", "backward", "--baseline", "a.cu", "--baseline", "b.cu",
                             "--probe"])
    assert (args.kernel, args.baseline, args.probe) == ("backward", ["a.cu", "b.cu"], True)
    assert args.shapes == ["training", "online_masked", "640x480"]
    args = bench.parse_args(["--shapes", "online,640x480"])
    assert (args.kernel, args.baseline, args.shapes) == ("forward", [], ["online", "640x480"])
    assert bench.parse_args([]).shapes == ["online", "training", "640x480", "baselines_l1"]
    with pytest.raises(SystemExit):
        bench.parse_args(["--kernel", "backward", "--shapes", "online"])
    assert bench.turns(["a", "b"]) == ["a", "b", "current", "current", "b", "a"]
    assert bench.turns([]) == ["current", "current"]


def test_backward_shapes_and_report_keys():
    want = {"training": ((4, 1, 32, 128, 128, 64), [1.0]),
            "online_masked": ((1, 2, 32, 128, 160, 64), [1.0, 0.0]),
            "640x480": ((1, 2, 32, 240, 320, 64), [0.5, 0.5])}
    for name, (shape, weights) in want.items():
        B, V, C, H, W, P = shape
        ref, meas, mats, w, g = bench.case_inputs("backward", name, device="cpu")
        assert (tuple(ref.shape), tuple(meas.shape), tuple(mats.shape), tuple(g.shape)) == (
            (B, H, W, C), (B, V, H, W, C), (B, V, P, 3, 3), (B, P, H, W))
        assert w.tolist() == [weights] * B
    # the bound of the masked shape counts one view's bytes and samples
    ref, meas, mats, w, _ = bench.case_inputs("backward", "online_masked", device="cpu")
    fwd, bwd = (measure.sweep_bound(ref, meas, mats, w, backward=b) for b in (False, True))
    assert bwd["bytes"] - fwd["bytes"] == 4 * 2 * 128 * 160 * 32
    assert bwd["flops"] * measure.FWD_FLOPS == fwd["flops"] * measure.BWD_FLOPS
    got = (torch.zeros(2, 3), torch.ones(4))
    assert bench.max_abs_diff("backward", got, (torch.ones(2, 3), torch.ones(4))) == {
        "d_ref": 1.0, "d_meas": 0.0}
    assert list(bench.max_abs_diff("forward", got[:1], got[:1])) == ["cost"]


def test_forward_shapes_carry_their_mode_and_planes():
    """Each forward shape names its mode: the dot product at C=32, and L1 at
    MVDepthNet's and GP-MVS's RGB shape with their 0.5-50 m planes, whose
    bound is by bytes, about 24 MB (the small-channel kernel's case)."""
    modes = {name: entry[2] for name, entry in bench.SHAPES["forward"].items()}
    assert modes == {"online": True, "training": True, "640x480": True, "baselines_l1": False}
    assert all(entry[2] for entry in bench.SHAPES["backward"].values())
    shape, weights, _, depths = bench.SHAPES["forward"]["baselines_l1"]
    assert (shape, weights, depths) == ((1, 2, 3, 256, 320, 64), None, (0.5, 50.0))
    ref, meas, mats, w = bench.case_inputs("forward", "baselines_l1", device="cpu")
    want = measure.sweep_case(shape, depths=depths, device="cpu")
    for got, expect in zip((ref, meas, mats, w), want):
        assert torch.equal(got, expect)
    # the planes span 0.5-50 m, not the default 0.25-20 m
    near = measure.sweep_case(shape, device="cpu")[2]
    assert not torch.equal(mats, near)
    bound = measure.sweep_bound(ref, meas, mats, w)
    assert bound["bound_by"] == "bytes"
    assert bound["bytes"] == 4 * (256 * 320 * 3 * 3 + 2 * 64 * 9 + 2 + 64 * 256 * 320)
    # the mode reaches the plain version: a matrix that undoes the (W-1)/W
    # fold samples every pixel at itself, so the L1 cost is
    # sum_v w_v sum_c |ref - meas_v|
    ref, meas, mats, w = measure.sweep_case((1, 2, 3, 8, 8, 4), device="cpu")
    unfold = torch.diag(torch.tensor([8 / 7, 8 / 7, 1.0])).expand_as(mats).contiguous()
    got = bench.plain("forward", (ref, meas, unfold, w), dot=False)[0]
    want = sum(w[0, v] * (ref[0] - meas[0, v]).abs().sum(-1) for v in range(2))
    torch.testing.assert_close(got[0], want.expand(4, 8, 8), rtol=0, atol=1e-5)


def test_binned_share_follows_the_tap_boxes(monkeypatch):
    import chip_smoke as cs
    from dvmvs_tpu_torch.ops import plane_sweep as ps

    B, V, C, H, W, P = SHAPE
    _, _, mats, w = measure.sweep_case(SHAPE, device="cpu")
    identity = torch.eye(3).expand_as(mats).contiguous()
    steps = B * V * -(-H // 2) * -(-W // 32) * -(-P // measure.BWD_CHUNK)
    # each tile's top-left taps are its own pixels
    assert measure.binned_share(identity, w, H, W) == (steps, steps)
    assert measure.binned_share(identity, torch.tensor([[1.0, 0.0]] * B), H, W) == (
        steps // 2, steps // 2)
    # with 64 bins a 32x2 tile fits; zoomed out 2x an inner tile's taps span
    # 62x3 pixels (a tile at the image's edge keeps only a few in range)
    monkeypatch.setattr(measure, "BWD_MAX_BINS", 64)
    zoom = identity.clone()
    zoom[..., 0, 0] = zoom[..., 1, 1] = 2.0
    assert measure.binned_share(identity, w, 4 * H, 4 * W) == (steps * 8, steps * 8)
    binned, total = measure.binned_share(zoom, w, 4 * H, 4 * W)
    assert 0 < total - binned < total
    monkeypatch.undo()
    # the card cases: the typical training geometry is binned; the wide
    # diagonal motion scatters about half its steps straight to d_meas
    for name, low, high in (("typical", 1.0, 1.0), ("wide_diagonal", 0.3, 0.7)):
        _, _, mats, w, _ = cs.bwd_case(torch, ps, 0, name, "cpu")
        binned, total = measure.binned_share(mats, w, cs.TH, cs.TW)
        assert total > 0 and low <= binned / total <= high, (name, binned, total)
