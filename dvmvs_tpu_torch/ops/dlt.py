"""Batched solve of DELTAS's DLT systems: the CUDA kernel, its wrapper and
its plain PyTorch version (the JAX package's ``jnp.linalg.svd`` in
dvmvs_tpu/baselines/deltas.py::triangulate_dlt).

``dlt_solve`` takes the confidence-weighted systems A (..., R, 4) float32,
R >= 1 rows each, and returns the right singular vectors Vh (..., 4, 4) as
rows in descending singular value. A CPU tensor goes to ``dlt_solve_plain``,
``torch.linalg.svd(A, full_matrices=False)[2]``; a CUDA tensor launches
``csrc/dlt_solve.cu`` on the current stream: Householder QR, then one-sided
Jacobi in parallel order, in double precision, four lanes a system (one a
column), 16 systems a block. The kernel makes no host synchronisation, so a
CUDA graph captures it; ``torch.linalg.svd`` copies its convergence info to
the host and cannot be captured. The two may give a vector the other sign:
the points of ``baselines/deltas.py::dlt_points`` do not depend on it.
"""

from __future__ import annotations

import ctypes
import functools
import torch

from dvmvs_tpu_torch.ops import cuda_build
from dvmvs_tpu_torch.utils.profiling import counters

KERNELS = ("dlt_solve",)

# Launches of the CUDA kernel (never the plain version's) are counted under
# this name of ``utils/profiling.py::counters``
LAUNCHES = "dlt.launches"


def dlt_solve_plain(A: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same argument and result)."""
    return torch.linalg.svd(A, full_matrices=False)[2]


def bind(lib: ctypes.CDLL):
    """The kernel's C entry point in a loaded library, typed."""
    fn = lib.dlt_solve
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _entry():
    """The kernel's C entry point, built and loaded once per process."""
    return bind(cuda_build.load("dlt_solve"))


def _check(A: torch.Tensor):
    if A.dtype != torch.float32:
        raise TypeError(f"dlt_solve: A must be float32, got {A.dtype}")
    if A.dim() < 2 or A.shape[-1] != 4 or A.shape[-2] < 1:
        raise ValueError(f"dlt_solve: want systems (..., R, 4) with R >= 1, got {tuple(A.shape)}")
    if not A.is_contiguous():
        raise ValueError("dlt_solve: A must be contiguous")
    if A.device.type not in ("cpu", "cuda"):
        raise ValueError(f"dlt_solve: unsupported device {A.device}")


def launch(A: torch.Tensor, fn=None) -> torch.Tensor:
    """Launch the kernel (or ``fn``, the entry point of another build of a
    source of it, from ``bind``) on a checked CUDA tensor on the current
    stream; returns Vh."""
    n = A.numel() // (A.shape[-2] * 4)
    vh = torch.empty(A.shape[:-2] + (4, 4), dtype=torch.float32, device=A.device)
    with torch.cuda.device(A.device):
        err = (fn or _entry())(A.data_ptr(), vh.data_ptr(), n, A.shape[-2],
                               torch.cuda.current_stream(A.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dlt_solve kernel launch failed: cudaError {err}")
    return vh


def dlt_solve(A: torch.Tensor) -> torch.Tensor:
    """The right singular vectors (..., 4, 4) of the systems A (..., R, 4),
    contiguous float32: the plain version on the CPU, the kernel on the card
    (it raises if the kernel cannot run)."""
    _check(A)
    if A.device.type == "cpu":
        return dlt_solve_plain(A)
    vh = launch(A)
    counters.add(LAUNCHES)
    return vh
