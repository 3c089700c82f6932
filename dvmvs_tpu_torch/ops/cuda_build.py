"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface; it may
include headers of ``csrc/`` (``#include "x.cuh"``). At first use it is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/kernels/`` at the root of the checkout, in a directory keyed by a
hash of the source, the headers it includes and the flags, and loaded with
``ctypes``. Nothing includes PyTorch's headers, so a build takes seconds.

A kernel is named by a string (``csrc/<name>.cu``) or by a ``(name, source
path)`` pair, which builds another source of a kernel (an earlier version of
it, to time beside it) in a directory of its own.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def find_nvcc() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin)")


def _spec(kernel) -> tuple[str, Path]:
    if isinstance(kernel, str):
        return kernel, CSRC / f"{kernel}.cu"
    name, source = kernel
    return name, Path(source)


def _included(source: Path, seen: set) -> list[Path]:
    """The headers a source includes with quotes, found beside it or in
    ``csrc/``, recursively."""
    found = []
    for header in re.findall(r'^\s*#\s*include\s+"([^"]+)"', source.read_text(), re.M):
        path = next((d / header for d in (source.parent, CSRC) if (d / header).is_file()), None)
        if path is not None and path not in seen:
            seen.add(path)
            found += [path, *_included(path, seen)]
    return found


def library_path(kernel) -> Path:
    name, source = _spec(kernel)
    digest = hashlib.sha256(source.read_bytes())
    for header in _included(source, set()):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / f"{name}-{digest.hexdigest()[:16]}" / f"lib{name}.so"


def build_all(kernels) -> dict:
    """Compile every kernel of ``kernels`` that has no library of the same
    hash yet, one ``nvcc`` process per source, all running at once.
    Returns {kernel: (library path, compiler output, "" if cached)}."""
    results, running, nvcc = {}, [], None
    for kernel in kernels:
        _, source = _spec(kernel)
        lib = library_path(kernel)
        if lib.is_file():
            results[kernel] = (lib, "")
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        nvcc = nvcc or find_nvcc()
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        running.append((kernel, source, lib, tmp, cmd, proc))
    failures = []
    for kernel, source, lib, tmp, cmd, proc in running:
        out, err = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed ({proc.returncode}) on {source.name}:\n"
                            f"{' '.join(cmd)}\n{out}{err}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
        results[kernel] = (lib, out + err)
    if failures:
        raise KernelBuildError("\n".join(failures))
    return results


def build(kernel) -> tuple[Path, str]:
    """Compile a kernel unless a library of the same hash exists. Returns
    the library's path and the compiler's output ("" if cached)."""
    return build_all([kernel])[kernel]


@functools.lru_cache(maxsize=None)
def _open(lib: Path) -> ctypes.CDLL:
    return ctypes.CDLL(str(lib))


def load(kernel) -> ctypes.CDLL:
    """Build (if needed) and load a kernel's library, once per process."""
    lib, _ = build(kernel)
    return _open(lib)


def load_all(kernels) -> dict:
    """Build (if needed, ``build_all``: all sources at once) and load every
    kernel of ``kernels``; ``load`` then finds them loaded. Returns the
    compiler's output by kernel ("" if cached)."""
    built = build_all(kernels)
    for lib, _ in built.values():
        _open(lib)
    return {kernel: log for kernel, (_, log) in built.items()}
