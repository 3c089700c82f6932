"""Package hygiene of dvmvs_tpu_torch: it imports neither jax nor OpenCV,
and of the JAX package only the jax-free config; its kernel build reports
compiler failures and builds all sources at once, and chip_smoke.py refuses
to run without a GPU.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from dvmvs_tpu_torch.ops import cuda_build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax_or_cv2():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import dvmvs_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(dvmvs_tpu_torch.__path__,
                                                       "dvmvs_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        # dvmvs_tpu.config is jax-free; its other subpackages import jax or cv2
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "cv2")
                     or m.startswith("dvmvs_tpu.") and m != "dvmvs_tpu.config")
        print(json.dumps({"names": names, "bad": bad}))
    """)
    out = subprocess.run([sys.executable, "-c", "import json\n" + code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300, check=True).stdout
    result = json.loads(out)
    assert result["bad"] == []
    assert TRAINING_MODULES <= set(result["names"])  # the training slice was walked too
    assert len(result["names"]) >= 30


TRAINING_MODULES = {f"dvmvs_tpu_torch.{m}" for m in (
    "apps.run_training", "parallel.train", "models.training_heads", "utils.losses",
    "utils.checkpoint", "utils.run_logging", "data.crawler", "data.preprocess",
    "data.dataset")}


def _fake_nvcc(tmp_path, body):
    path = tmp_path / "nvcc"
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(0o755)
    return str(path)


def test_kernel_build_reports_compiler_output_and_caches(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: _fake_nvcc(
        tmp_path, "echo 'plane_sweep.cu(1): error: no such type' >&2\nexit 2\n"))
    with pytest.raises(cuda_build.KernelBuildError, match="no such type"):
        cuda_build.build("plane_sweep")
    assert not any((tmp_path / "build").rglob("*.so"))

    # a compiler that writes its -o target: built once, then found by hash
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: _fake_nvcc(
        tmp_path, 'while [ "$1" != "-o" ]; do shift; done\ntouch "$2"\necho built\n'))
    lib, log = cuda_build.build("plane_sweep")
    assert lib.is_file() and "built" in log
    assert lib.parent.parent == tmp_path / "build"
    assert cuda_build.build("plane_sweep") == (lib, "")


def test_kernels_build_all_at_once(tmp_path, monkeypatch):
    """One nvcc per source, started together; a failure names its source."""
    from dvmvs_tpu_torch.ops import plane_sweep

    monkeypatch.setattr(cuda_build, "BUILD_ROOT", tmp_path / "build")
    nvcc = _fake_nvcc(tmp_path, 'while [ "$1" != "-o" ]; do shift; done\ntouch "$2"\n'
                                'echo built "$2"\n')
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: nvcc)
    built = cuda_build.build_all(plane_sweep.KERNELS)
    assert sorted(built) == sorted(plane_sweep.KERNELS) == ["plane_sweep", "plane_sweep_bwd"]
    assert all(lib.is_file() and "built" in log for lib, log in built.values())

    monkeypatch.setattr(cuda_build, "BUILD_ROOT", tmp_path / "other")
    (tmp_path / "failing").mkdir()
    failing = _fake_nvcc(tmp_path / "failing",
                         'for a in "$@"; do case "$a" in *_bwd.cu) echo bad >&2; exit 1;; esac; '
                         'done\nwhile [ "$1" != "-o" ]; do shift; done\ntouch "$2"\n')
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: failing)
    with pytest.raises(cuda_build.KernelBuildError, match="plane_sweep_bwd.cu"):
        cuda_build.build_all(plane_sweep.KERNELS)
    assert [p.name for p in (tmp_path / "other").rglob("*.so")] == ["libplane_sweep.so"]


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed here")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(cuda_build.KernelBuildError, match="nvcc not found"):
        cuda_build.find_nvcc()


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run for real")
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if alone:  # a directory holding chip_smoke.py and nothing else of the repo
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    proc = subprocess.run([sys.executable, script], cwd=cwd, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
