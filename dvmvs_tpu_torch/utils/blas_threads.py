"""OpenBLAS on one thread around small host linear algebra.

NumPy and SciPy each load their own OpenBLAS, each with a pool of worker
threads (one a core) that spin for a while after every call that used them.
A host step that runs between two CUDA graph replays (GP-MVS's Kalman update
on a 2 x 40960 latent) wakes those pools, and their spinning then takes the
cores from the thread that launches the next graph and waits for it. Run
such a step inside ``single_threaded_blas()``: the pools stay asleep.
Partitioning a product over threads does not change any of its elements, so
the results are the same.

The libraries are found among the shared objects this process has loaded
(``/proc/self/maps``) and their thread count set through OpenBLAS's own
``openblas_set_num_threads`` (NumPy's and SciPy's wheels prefix it with
``scipy_`` and suffix the 64-bit interface with ``64_``). Where there is no
such library (another BLAS, another platform) the context does nothing.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
from typing import List, Optional, Tuple

_PREFIXES, _SUFFIXES = ("", "scipy_"), ("", "64_")
_pools: Optional[List[Tuple[ctypes._CFuncPtr, ctypes._CFuncPtr]]] = None


def _loaded_openblas() -> List[str]:
    try:
        with open("/proc/self/maps") as f:
            fields = [line.split() for line in f]
    except OSError:
        return []
    return sorted({p[-1] for p in fields if len(p) >= 6
                   and "openblas" in os.path.basename(p[-1]).lower()})


def openblas_pools():
    """(get, set) thread-count functions of each OpenBLAS loaded now."""
    global _pools
    if _pools is None:
        found = []
        for path in _loaded_openblas():
            lib = ctypes.CDLL(path)  # already loaded: the same library
            for prefix in _PREFIXES:
                for suffix in _SUFFIXES:
                    get = getattr(lib, f"{prefix}openblas_get_num_threads{suffix}", None)
                    set_ = getattr(lib, f"{prefix}openblas_set_num_threads{suffix}", None)
                    if get is not None and set_ is not None:
                        found.append((get, set_))
        _pools = found
    return _pools


@contextlib.contextmanager
def single_threaded_blas():
    """Every loaded OpenBLAS on one thread inside the block, restored after."""
    pools = openblas_pools()
    saved = [get() for get, _ in pools]
    for _, set_ in pools:
        set_(1)
    try:
        yield
    finally:
        for (_, set_), n in zip(pools, saved):
            set_(n)
