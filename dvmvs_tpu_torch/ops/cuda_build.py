"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface. At
first use it is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared
library under ``build/kernels/`` at the root of the checkout, in a directory
keyed by a hash of the source and the flags, and loaded with ``ctypes``.
Nothing includes PyTorch's headers, so a build takes seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
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


def library_path(name: str) -> Path:
    source = CSRC / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / f"{name}-{digest.hexdigest()[:16]}" / f"lib{name}.so"


def build_all(names) -> dict[str, tuple[Path, str]]:
    """Compile every ``csrc/<name>.cu`` of ``names`` that has no library of
    the same hash yet, one ``nvcc`` process per source, all running at once.
    Returns {name: (library path, compiler output, "" if cached)}."""
    results, running, nvcc = {}, [], None
    for name in names:
        lib = library_path(name)
        if lib.is_file():
            results[name] = (lib, "")
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        nvcc = nvcc or find_nvcc()
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        running.append((name, lib, tmp, cmd, proc))
    failures = []
    for name, lib, tmp, cmd, proc in running:
        out, err = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed ({proc.returncode}) on {name}.cu:\n"
                            f"{' '.join(cmd)}\n{out}{err}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
        results[name] = (lib, out + err)
    if failures:
        raise KernelBuildError("\n".join(failures))
    return results


def build(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless a library of the same hash exists.
    Returns the library's path and the compiler's output ("" if cached)."""
    return build_all([name])[name]


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library ``name``."""
    lib, _ = build(name)
    return ctypes.CDLL(str(lib))
