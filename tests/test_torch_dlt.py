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
from dvmvs_tpu_torch.utils.profiling import counters

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
    before = counters[dlt.LAUNCHES]
    assert torch.equal(dlt.dlt_solve(A), torch.linalg.svd(A, full_matrices=False)[2])
    assert torch.equal(deltas.dlt_solve(A), dlt.dlt_solve_plain(A))
    assert counters[dlt.LAUNCHES] == before
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
    before = counters[dlt.LAUNCHES]
    vh = dlt.dlt_solve(A)
    again = dlt.dlt_solve(A)
    torch.cuda.synchronize()
    assert counters[dlt.LAUNCHES] == before + 2 and torch.equal(vh, again)
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


# Shapes the kernel's layout (four lanes a system, 16 systems a block, the
# rows through registers, 8 a chunk for R <= 8 and 16 otherwise, each chunk
# after the first stacked under the triangle so far) can get wrong:
# (systems, rows). Rows 1 and 2 leave the
# triangle short; 6 is DELTAS's default (V=2) and 10 the five-camera case;
# 16 fills the first chunk, 17 and 40 take a second and a third; 62 is 30
# measurement frames, a full keyframe buffer. 37 systems end inside a block
# and a warp; one system; DELTAS's batch of 8 keyframes; about 10^5.
LAYOUTS = {
    "rows1": (37, 1), "rows2": (37, 2), "rows6": (37, 6), "rows10": (37, 10),
    "rows16": (37, 16), "rows17": (37, 17), "rows40": (37, 40), "rows62": (37, 62),
    "one_system": (1, 6), "one_block_and_one": (17, 6), "deltas_8x512": ((8, 512), 6),
    "many": (100003, 6),
}


def layout_systems(systems, rows, seed=0):
    """Seeded float32 systems (*systems, rows, 4), Gaussian at a log-uniform
    scale of 1e-3-1e3 a system; by flat index, (i + 4) % 8: 0 zero, 1 every
    row from the third on zero (a masked view), 2 one row (the rest zero), 3
    its middle row zero, the others full (so is a single system)."""
    shape = (systems,) if isinstance(systems, int) else systems
    n = int(np.prod(shape))
    rs = np.random.RandomState(seed)
    A = rs.randn(n, rows, 4) * 10.0 ** rs.uniform(-3, 3, (n, 1, 1))
    kind = (np.arange(n) + 4) % 8
    A[kind == 0] = 0.0
    A[kind == 1, 2:] = 0.0
    A[kind == 2, 1:] = 0.0
    A[kind == 3, rows // 2] = 0.0
    return torch.from_numpy(A.astype(np.float32).reshape(shape + (rows, 4)))


def svd_gaps(A, vh):
    """How far vh (..., 4, 4) is from the right singular vectors of A (...,
    R, 4) by torch.linalg.svd in float64, each gap over the system's largest
    singular value s_max (squared for the Gram matrix): the columns' norms
    of A Vh^T against the singular values, their Gram matrix's largest
    off-diagonal (0 for singular vectors, whatever the basis of a repeated
    value), and each vector against float64's up to its sign where its
    singular value stands more than 1e-2 s_max from its neighbours. Also
    Vh Vh^T against the identity, and whether the zero systems gave it."""
    A, vh = A.double().reshape(-1, *A.shape[-2:]), vh.double().reshape(-1, 4, 4)
    assert torch.isfinite(vh).all()
    _, s, want = torch.linalg.svd(A, full_matrices=False)
    s = torch.cat([s, s.new_zeros(len(s), 4 - s.shape[1])], 1)  # R < 4: the rest are zero
    if want.shape[1] < 4:
        want = torch.linalg.svd(torch.cat([A, A.new_zeros(len(A), 4 - A.shape[1], 4)], 1))[2]
    smax = s[:, :1]
    live = smax[:, 0] > 0
    eye = torch.eye(4, dtype=vh.dtype, device=vh.device)
    B = A @ vh.transpose(-1, -2)
    gram = B.transpose(-1, -2) @ B
    off = (gram - torch.diag_embed(torch.diagonal(gram, dim1=-2, dim2=-1))).abs().amax((-2, -1))
    norms = torch.linalg.norm(B, dim=-2)
    spaced = torch.full_like(s, float("inf"))
    spaced[:, 1:] = (s[:, 1:] - s[:, :-1]).abs()
    spaced[:, :-1] = torch.minimum(spaced[:, :-1], (s[:, 1:] - s[:, :-1]).abs())
    alone = (spaced > 1e-2 * smax) & live[:, None]
    sign = torch.sign((vh * want).sum(-1, keepdim=True))
    vec = ((vh - sign * want).abs().amax(-1) * alone).amax() if alone.any() else vh.new_zeros(())
    def worst(x):
        return float(x[live].max()) if live.any() else 0.0

    return {"norms": worst((norms - s).abs() / smax.clamp_min(1e-300)),
            "gram": worst(off / smax[:, 0].clamp_min(1e-300) ** 2),
            "vectors": float(vec), "alone": int(alone.sum()),
            "orthonormal": float((vh @ vh.transpose(-1, -2) - eye).abs().max()),
            "zero_is_identity": bool((vh[~live] == eye).all())}


def assert_svd(A, vh):
    """svd_gaps within this file's 1e-4 (module doc); orthonormal within
    1e-5, as test_kernel_on_degenerate_systems."""
    g = svd_gaps(A, vh)
    print(g)
    assert g["norms"] <= HOM_TOL and g["gram"] <= HOM_TOL and g["vectors"] <= HOM_TOL
    assert g["orthonormal"] <= 1e-5 and g["zero_is_identity"] and g["alone"] > 0


def test_svd_gaps_take_the_plain_solve_and_catch_a_fault():
    """The card tests' check on the plain version: torch.linalg.svd's Vh
    passes at the layouts' row counts from 4 on (below 4 it has R rows, the
    kernel always 4); Vh with two rows swapped, or one rotated a little,
    does not."""
    for name in ("rows6", "rows10", "rows17", "rows62"):
        A = layout_systems(37, LAYOUTS[name][1])
        assert_svd(A, dlt.dlt_solve(A))
    A = layout_systems(37, 6)
    vh = dlt.dlt_solve(A)
    swapped = vh[:, [1, 0, 2, 3]]
    assert svd_gaps(A, swapped)["norms"] > 1e-2
    c, s = np.cos(1e-3), np.sin(1e-3)
    turn = torch.tensor([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                        dtype=torch.float32)
    g = svd_gaps(A, turn @ vh)
    assert g["gram"] > HOM_TOL and g["vectors"] > HOM_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_kernel_layouts_on_the_card(cuda_device, name):
    """The kernel at each of LAYOUTS against torch.linalg.svd in float64 by
    svd_gaps, with zero systems, a masked view, one row and a zero middle
    row among them; two launches bit-equal."""
    systems, rows = LAYOUTS[name]
    A = layout_systems(systems, rows).to(cuda_device)
    vh = dlt.dlt_solve(A)
    again = dlt.dlt_solve(A)
    torch.cuda.synchronize()
    assert vh.shape == A.shape[:-2] + (4, 4) and torch.equal(vh, again)
    assert_svd(A, vh)
