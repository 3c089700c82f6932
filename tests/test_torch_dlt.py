"""The DLT solve of DELTAS's triangulation (ops/dlt.py): its plain version
against the JAX package's ``triangulate_dlt`` on the CPU, and the CUDA
kernel ``csrc/dlt_solve.cu`` against the plain version on the card.

Inputs: ``ops/sweep_measure.py::dlt_case``, seeded systems at DELTAS's
320x240 with masked views (zero rows), near rank-deficient ones (a view at
a null segment's 0.001 confidence beside a masked one), noise-free ones,
and a case of points 100-1000 m away, near infinity for cameras 0.1 m
apart. Limits:
  - the points DELTAS keeps (a depth inside its (0.5, 10) m range on
    either side) within 1e-4 of their largest coordinate, the limit of
    tests/test_torch_deltas.py (measured at most 4.8e-5 against JAX);
  - every point's homogeneous solution, [p, 1] / |[p, 1]| up to its sign,
    within 1e-4 (measured at most 1.8e-5). A point out of range is dropped
    from DELTAS's sparse depth, and one near infinity keeps no float32
    digit in p = x / w: two float32 solves differ there by 1e-4 to 3e-1 of
    the largest coordinate (measured), while its direction stays determined.
    So the near-infinity case holds the homogeneous solutions alone: the
    few of its points that the pixel noise brings into the range (under
    1%) are as ill-conditioned as the rest (measured 6.0e-4 of their
    largest coordinate between the kernel and cuSOLVER on an NVIDIA H100).

On the card the kernel is held to ``torch.linalg.svd`` in float64 (the
exact solution of the float32 systems, to float32 rounding) at those limits,
and to the float32 plain version at those limits plus that version's own gap
to float64: cuSOLVER's float32 solve of the near rank-deficient systems
stands up to 6.4e-4 from float64 where the kernel stands 1e-7 from it
(measured on an NVIDIA H100 80GB HBM3).

The card tests need an NVIDIA GPU and skip elsewhere; this file imports jax
only inside the JAX comparison, so on a machine with the card and without
jax they run as ``python -m pytest --noconftest -q tests/test_torch_dlt.py
-m cuda``.
"""

import numpy as np
import pytest
import torch

from dvmvs_tpu_torch.baselines import deltas
from dvmvs_tpu_torch.ops import dlt
from dvmvs_tpu_torch.ops.sweep_measure import (DLT_CHECK_FLOPS, DLT_ROW_FLOPS, DLT_TAIL_FLOPS,
                                               dlt_bound, dlt_case)

POINT_TOL, HOM_TOL = 1e-4, 1e-4
CASES = {
    "three_cameras": {},
    "two_cameras": {"seed": 1, "V": 2},
    "five_cameras": {"seed": 2, "V": 5},
    "near_infinity": {"seed": 3, "depths": (100.0, 1000.0)},
}


def gaps(got, want):
    """(the kept points' gap over their largest coordinate, the homogeneous
    solutions' largest gap, how many points were kept): got and want (...,
    3) points."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all() and np.isfinite(want).all()
    inside = [(p[..., 2] > deltas.MIN_DEPTH) & (p[..., 2] < deltas.MAX_DEPTH)
              for p in (got, want)]
    kept = inside[0] | inside[1]
    point = 0.0
    if kept.any():
        point = float(np.abs(got[kept] - want[kept]).max() / np.abs(want[kept]).max())
    hom = [np.concatenate([p, np.ones_like(p[..., :1])], axis=-1) for p in (got, want)]
    hom = [h / np.linalg.norm(h, axis=-1, keepdims=True) for h in hom]
    sign = np.sign((hom[0] * hom[1]).sum(-1, keepdims=True))
    return point, float(np.abs(hom[0] - sign * hom[1]).max()), int(kept.sum())


def case_tensors(name, device="cpu"):
    return tuple(torch.from_numpy(a).to(device) for a in dlt_case(**CASES[name]))


@pytest.mark.parametrize("name", list(CASES))
def test_plain_solve_matches_jax(name):
    """The port's triangulate_dlt (dlt_solve's plain version on the CPU)
    against the JAX package's, batch element by batch element."""
    import jax.numpy as jnp

    from dvmvs_tpu.baselines import deltas as jd

    proj, points, conf = case_tensors(name)
    got = deltas.triangulate_dlt(proj, points, conf).numpy()
    want = np.stack([np.asarray(jd.triangulate_dlt(jnp.asarray(proj[b].numpy()),
                                                   jnp.asarray(points[b].numpy()),
                                                   jnp.asarray(conf[b].numpy())))
                     for b in range(len(proj))])
    point, hom, kept = gaps(got, want)
    print(f"{name}: kept points {point:.2e} of the largest ({kept} of {got.shape[0] * got.shape[1]}"
          f"), homogeneous {hom:.2e}")
    within(name, point, hom, kept, got.shape[0] * got.shape[1])


def within(name, point, hom, kept, n):
    """This file's limits (module doc) for case ``name`` of n points."""
    assert hom <= HOM_TOL
    if name == "near_infinity":
        assert kept < 0.01 * n
    else:
        assert point <= POINT_TOL and kept > 0.9 * n


def test_wrapper_on_the_cpu_is_the_plain_svd():
    """On the CPU the wrapper is torch.linalg.svd's Vh, bit for bit, and
    counts no launch; it refuses what the kernel would not take."""
    A = deltas.dlt_system(*case_tensors("three_cameras"))
    before = dlt.launch_count
    assert torch.equal(dlt.dlt_solve(A), torch.linalg.svd(A, full_matrices=False)[2])
    assert torch.equal(deltas.dlt_solve(A), dlt.dlt_solve_plain(A))
    assert dlt.launch_count == before
    with pytest.raises(TypeError, match="float32"):
        dlt.dlt_solve(A.double())
    with pytest.raises(ValueError, match="contiguous"):
        dlt.dlt_solve(A.transpose(0, 1))
    with pytest.raises(ValueError, match=r"\(\.\.\., R, 4\)"):
        dlt.dlt_solve(A[..., :3].contiguous())


def test_dlt_bound_counts_rows_and_sweeps():
    """The bound's arithmetic: A read and Vh written once; the flops of the
    non-zero rows and of one checking sweep a system, however many sweeps a
    solver takes. At DELTAS's 512 systems of 6 rows the bytes bound it."""
    A = torch.zeros((2, 3, 6, 4))
    A[0, :, :4] = 1.0  # two zero rows (a masked view) in the first element's systems
    A[1] = 1.0
    b = dlt_bound(A)
    assert b["bytes"] == 4 * (A.numel() + 6 * 16)
    rows = 3 * 4 + 3 * 6
    assert b["flops"] == rows * DLT_ROW_FLOPS + 6 * (DLT_CHECK_FLOPS + DLT_TAIL_FLOPS)
    assert b["bound_by"] in ("bytes", "operations") and b["bound_ms"] > 0
    deltas_bound = dlt_bound(torch.ones((1, 512, 6, 4)))
    assert deltas_bound["bytes"] == 81920 and deltas_bound["bound_by"] == "bytes"


# ------------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_plain_on_the_card(cuda_device, name):
    """The kernel against torch.linalg.svd on the same card in float64 and
    in float32 (module doc), on the points of ``dlt_points`` (the two may
    give a vector the other sign); two launches bit-equal; one launch
    counted a call."""
    A = deltas.dlt_system(*case_tensors(name, cuda_device)).contiguous()
    want = deltas.dlt_points(dlt.dlt_solve_plain(A)).cpu()
    exact = deltas.dlt_points(dlt.dlt_solve_plain(A.double())).float().cpu()
    before = dlt.launch_count
    vh = dlt.dlt_solve(A)
    again = dlt.dlt_solve(A)
    torch.cuda.synchronize()
    assert dlt.launch_count == before + 2 and torch.equal(vh, again)
    eye = torch.eye(4, device=cuda_device)
    assert torch.allclose(vh @ vh.transpose(-1, -2), eye.expand_as(vh), atol=1e-5)
    got = deltas.dlt_points(vh).cpu()
    point, hom, kept = gaps(got, exact)
    within(name, point, hom, kept, A.shape[0] * A.shape[1])
    own_point, own_hom, _ = gaps(want, exact)
    plain_point, plain_hom, _ = gaps(got, want)
    print(f"{name}: against float64 kept points {point:.2e} ({kept}), homogeneous {hom:.2e}; "
          f"against float32 {plain_point:.2e}, {plain_hom:.2e}; float32 against float64 "
          f"{own_point:.2e}, {own_hom:.2e}")
    assert plain_hom <= HOM_TOL + own_hom
    assert name == "near_infinity" or plain_point <= POINT_TOL + own_point


@pytest.mark.cuda
def test_kernel_on_degenerate_systems(cuda_device):
    """Zero systems give the identity, systems with zero rows and one row a
    finite orthonormal Vh, deterministic over calls; a graph captures the
    launch and its replay equals the eager call."""
    rs = np.random.RandomState(5)
    A = torch.from_numpy(rs.randn(64, 6, 4).astype(np.float32)).to(cuda_device)
    A[:8] = 0.0
    A[8:16, 2:] = 0.0
    A[16:24, 1:] = 0.0
    vh = dlt.dlt_solve(A)
    torch.cuda.synchronize()
    assert torch.isfinite(vh).all()
    assert torch.equal(vh[:8], torch.eye(4, device=cuda_device).expand(8, 4, 4))
    eye = torch.eye(4, device=cuda_device)
    assert torch.allclose(vh @ vh.transpose(-1, -2), eye.expand_as(vh), atol=1e-5)
    s = torch.linalg.svdvals(A[8:])
    got = torch.linalg.norm(A[8:] @ vh[8:].transpose(-1, -2), dim=-2)
    assert torch.allclose(got, s, atol=1e-4 * float(s.max()))
    static = A.clone()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        dlt.dlt_solve(static)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        out = dlt.dlt_solve(static)
    static.copy_(A.flip(0))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, dlt.dlt_solve(A.flip(0)))
