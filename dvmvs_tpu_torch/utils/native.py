"""Host C++ libraries of the port, built at first use, and the ctypes
bindings of the repo's native marching cubes and PLY writers
(``native/marching_cubes.cpp``, ``native/mc_tables.h``; counterpart of
dvmvs_tpu/utils/native.py).

A ``NativeSource`` names a library and its sources (the first is compiled,
all are hashed). At first use it is compiled with ``g++`` (on the card's
machine it is nvcc's host compiler) into ``build/native/<name>-<hash>/`` at
the root of the checkout, in a directory keyed by a hash of the sources,
the flags and the compiler's version, written under a temporary name and
moved into place (the scheme of ``ops/cuda_build.py``). Nothing is written
into ``native/``, and the library tracked there, built elsewhere for another
CPU, is never loaded. A failed build raises ``NativeBuildError`` with the
compiler's output. The JPEG entropy decoder (``data/jpeg.py``) is built the
same way from ``dvmvs_tpu_torch/csrc/jpeg_huffman.cpp``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path
from typing import Tuple

import numpy as np

NATIVE = Path(__file__).resolve().parents[2] / "native"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")


@dataclass(frozen=True)
class NativeSource:
    """A shared library built from ``sources`` in ``directory`` (the first is
    compiled; the others are headers it includes, hashed with it)."""

    name: str
    directory: Path
    sources: Tuple[str, ...]


MARCHING_CUBES = NativeSource("dvmvs_native", NATIVE, ("marching_cubes.cpp", "mc_tables.h"))


class NativeBuildError(RuntimeError):
    """g++ is missing or refused the native sources."""


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise NativeBuildError("g++ not found on PATH (set CXX to a C++17 compiler)")
    return cxx


def library_path(cxx: str, spec: NativeSource = MARCHING_CUBES) -> Path:
    digest = hashlib.sha256()
    for name in spec.sources:
        digest.update((spec.directory / name).read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    version = subprocess.run([cxx, "-dumpfullversion", "-dumpmachine"], capture_output=True,
                             text=True, timeout=60).stdout
    digest.update(version.encode())
    return BUILD_ROOT / f"{spec.name}-{digest.hexdigest()[:16]}" / f"lib{spec.name}.so"


def build(spec: NativeSource = MARCHING_CUBES) -> Path:
    """Compile ``spec``'s library unless one of the same hash exists;
    returns its path."""
    cxx = _compiler()
    lib = library_path(cxx, spec)
    if lib.is_file():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-I", str(spec.directory), "-o", str(tmp),
           str(spec.directory / spec.sources[0])]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return lib


def _floats(flags="C"):
    return np.ctypeslib.ndpointer(np.float32, flags=flags)


@functools.lru_cache(maxsize=None)
def _load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.mc_run.argtypes = [_floats(), ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                           ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
                           ctypes.POINTER(ctypes.c_int64)]
    lib.mc_run.restype = ctypes.c_int
    for name in ("mc_get_vertices", "mc_get_normals"):
        getattr(lib, name).argtypes = [ctypes.c_void_p, _floats()]
        getattr(lib, name).restype = None
    lib.mc_get_faces.argtypes = [ctypes.c_void_p, np.ctypeslib.ndpointer(np.int32, flags="C")]
    lib.mc_get_faces.restype = None
    lib.mc_free.argtypes = [ctypes.c_void_p]
    lib.mc_free.restype = None
    lib.ply_write_mesh.argtypes = [ctypes.c_char_p, _floats(), _floats(),
                                   np.ctypeslib.ndpointer(np.uint8, flags="C"), ctypes.c_int64,
                                   np.ctypeslib.ndpointer(np.int32, flags="C"), ctypes.c_int64]
    lib.ply_write_mesh.restype = ctypes.c_int
    lib.ply_write_points.argtypes = [ctypes.c_char_p, _floats(),
                                     np.ctypeslib.ndpointer(np.uint8, flags="C"), ctypes.c_int64]
    lib.ply_write_points.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The native library, built if needed and loaded once per path."""
    return _load(str(build()))


def marching_cubes(volume: np.ndarray, level: float = 0.0
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The ``level`` isosurface of a (dx, dy, dz) float volume: (verts (N, 3)
    float32 in voxel coordinates, faces (M, 3) int32, normals (N, 3)
    float32)."""
    lib = library()
    vol = np.ascontiguousarray(volume, dtype=np.float32)
    if vol.ndim != 3:
        raise ValueError(f"marching_cubes: want a 3-D volume, got shape {vol.shape}")
    dx, dy, dz = vol.shape
    handle, nv, nf = ctypes.c_void_p(), ctypes.c_int64(), ctypes.c_int64()
    rc = lib.mc_run(vol, dx, dy, dz, float(level), ctypes.byref(handle), ctypes.byref(nv),
                    ctypes.byref(nf))
    if rc != 0:
        raise RuntimeError(f"mc_run failed: {rc}")
    try:
        verts = np.empty((nv.value, 3), np.float32)
        norms = np.empty((nv.value, 3), np.float32)
        faces = np.empty((nf.value, 3), np.int32)
        if nv.value:
            lib.mc_get_vertices(handle, verts)
            lib.mc_get_normals(handle, norms)
        if nf.value:
            lib.mc_get_faces(handle, faces)
    finally:
        lib.mc_free(handle)
    return verts, faces, norms


def write_mesh_ply(path: str, verts: np.ndarray, faces: np.ndarray, norms: np.ndarray,
                   colors: np.ndarray):
    """Binary PLY mesh: per vertex position, normal and RGB; triangles."""
    n = len(verts)
    if not (len(norms) == len(colors) == n):
        raise ValueError("write_mesh_ply: verts, norms and colors differ in length")
    rc = library().ply_write_mesh(
        path.encode(), np.ascontiguousarray(verts, np.float32),
        np.ascontiguousarray(norms, np.float32), np.ascontiguousarray(colors, np.uint8), n,
        np.ascontiguousarray(faces, np.int32), len(faces))
    if rc != 0:
        raise RuntimeError(f"ply_write_mesh failed: {rc}")


def write_points_ply(path: str, xyz: np.ndarray, rgb: np.ndarray):
    """Binary PLY point cloud: per point position and RGB."""
    if len(xyz) != len(rgb):
        raise ValueError("write_points_ply: xyz and rgb differ in length")
    rc = library().ply_write_points(path.encode(), np.ascontiguousarray(xyz, np.float32),
                                    np.ascontiguousarray(rgb, np.uint8), len(xyz))
    if rc != 0:
        raise RuntimeError(f"ply_write_points failed: {rc}")
