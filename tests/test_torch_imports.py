"""Package hygiene of dvmvs_tpu_torch: it imports neither jax nor flax nor
msgpack nor OpenCV nor PIL nor imageio nor any module of the JAX package,
and neither it nor chip_smoke.py names one in an import or a path; it never
loads the native library tracked in native/ (built elsewhere for another
CPU) but builds its own; its kernel build reports compiler failures, builds
all sources at once and rebuilds when an included header changes, its host
C++ (the JPEG entropy decoder) rebuilds when its source changes, and
chip_smoke.py refuses to run without a GPU.
"""

import ast
import json
import os
import re
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from dvmvs_tpu_torch.ops import cuda_build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# top-level modules the port and chip_smoke.py may not load: the card's
# machine has none of them
FORBIDDEN = ("jax", "jaxlib", "flax", "msgpack", "cv2", "PIL", "imageio", "dvmvs_tpu")
FORBID = f"FORBIDDEN = {FORBIDDEN!r}\n"  # the same list in a subprocess's code


def test_port_imports_no_jax_or_cv2():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import dvmvs_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(dvmvs_tpu_torch.__path__,
                                                       "dvmvs_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in FORBIDDEN)
        print(json.dumps({"names": names, "bad": bad}))
    """)
    out = subprocess.run([sys.executable, "-c", "import json\n" + FORBID + code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300, check=True).stdout
    result = json.loads(out)
    assert result["bad"] == []
    assert TRAINING_MODULES <= set(result["names"])  # the training slice was walked too
    assert BULK_MODULES <= set(result["names"])
    assert BASELINE_MODULES <= set(result["names"])
    assert REAL_DATA_MODULES <= set(result["names"])
    assert len(result["names"]) >= 35


BULK_MODULES = {f"dvmvs_tpu_torch.{m}" for m in (
    "apps.run_testing", "apps.run_tsdf", "apps.simulate_keyframe_buffer", "ops.tsdf",
    "utils.native", "apps.bench_bulk", "data.scene_folders")}


BASELINE_MODULES = {f"dvmvs_tpu_torch.{m}" for m in (
    "apps.run_testing_baseline", "baselines", "baselines.registry", "baselines.mvdepth_backbone",
    "baselines.mvdepthnet", "baselines.gpmvs", "baselines.dpsnet", "baselines.deltas",
    "utils.baseline_weights")}


REAL_DATA_MODULES = {f"dvmvs_tpu_torch.{m}" for m in (
    "data.jpeg", "data.synth_scannet", "data.exporters", "data.exporters.scannet",
    "data.exporters.sevenscenes", "data.exporters.tum_rgbd", "data.exporters.iclnuim",
    "data.exporters.rgbd_scenes", "data.exporters.point_cloud", "utils.msgpack",
    "utils.visualization", "utils.profiling")}


def test_exporter_and_checkpoint_paths_load_no_forbidden_module(tmp_path):
    """Export a small .sens (JPEG colour written here by cv2) in both layouts,
    write and read a JAX-layout checkpoint of pairnet and load it into
    fusionnet as a warm start, and write visualization panels: none of it
    loads jax, flax, msgpack, cv2, PIL, imageio or dvmvs_tpu."""
    import cv2
    import numpy as np

    from dvmvs_tpu_torch.data.synth_scannet import write_sens

    rs = np.random.RandomState(0)
    K = np.array([[20.0, 0, 12], [0, 20.0, 8], [0, 0, 1]])
    poses = [np.eye(4)] * 3
    jpegs = [cv2.imencode(".jpg", rs.randint(0, 255, (16, 24, 3)).astype(np.uint8))[1].tobytes()
             for _ in poses]
    depths = [rs.randint(500, 3000, (16, 24)).astype(np.uint16) for _ in poses]
    write_sens(str(tmp_path / "scan" / "scan.sens"), K, K, (24, 16), (24, 16), poses, jpegs,
               depths)
    code = textwrap.dedent(f"""
        import json, sys
        import numpy as np
        from dvmvs_tpu_torch.apps.engine import InferenceEngine
        from dvmvs_tpu_torch.config import TestConfig
        from dvmvs_tpu_torch.data.exporters import scannet
        from dvmvs_tpu_torch.utils import checkpoint
        from dvmvs_tpu_torch.utils.visualization import save_visualization
        root = {str(tmp_path)!r}
        for train in (False, True):
            out = root + ("/train" if train else "/test")
            scannet.export_scene(root + "/scan", out, train, 1)
            assert scannet.sanity_check(out, train) == []
        cfg = TestConfig(image_width=64, image_height=64)
        pair = InferenceEngine("pairnet", cfg, device="cpu", seed=1)
        checkpoint.save_jax_checkpoint(root + "/pair.msgpack", pair.model)
        fusion = InferenceEngine("fusionnet", cfg, device="cpu", seed=2)
        fresh = checkpoint.load_checkpoint(root + "/pair.msgpack", fusion.model, partial=True)
        image = np.zeros((8, 8, 3), np.float32)
        save_visualization(root + "/vis", 0, image, image, np.ones((8, 8), np.float32),
                           [0.0] * 3, [1.0] * 3, 1.0)
        print(json.dumps({{"fresh": fresh,
                          "bad": sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)}}))
    """)
    out = subprocess.run([sys.executable, "-c", FORBID + code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    result = json.loads(out.splitlines()[-1])
    assert result == {"fresh": ["lstm_fusion"], "bad": []}
    assert len(os.listdir(tmp_path / "test" / "scan" / "images")) == 3
    assert len(os.listdir(tmp_path / "vis")) == 4


def test_editing_the_jpeg_source_rebuilds_it(tmp_path, monkeypatch):
    """The JPEG entropy decoder is built by g++ into a directory keyed by
    the hash of its source: an edit gives a new library, built anew."""
    from dvmvs_tpu_torch.data import jpeg
    from dvmvs_tpu_torch.utils import native

    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    shutil.copy(jpeg.JPEG_HUFFMAN.directory / "jpeg_huffman.cpp", csrc)
    spec = native.NativeSource("jpeg_huffman", csrc, ("jpeg_huffman.cpp",))
    first = native.build(spec)
    assert first.is_file() and first.parent.parent == tmp_path / "build"
    assert native.build(spec) == first  # found by hash, not rebuilt
    source = csrc / "jpeg_huffman.cpp"
    source.write_text(source.read_text() + "\n// edited\n")
    second = native.build(spec)
    assert second != first and second.is_file() and first.is_file()


def test_baselines_path_loads_no_jax_or_cv2():
    """Importing the baseline driver registers all four baselines, and one
    GP-MVS prediction on the CPU (its L1 sweep and host Kalman step) loads no
    jax, flax, cv2 or dvmvs_tpu module."""
    code = textwrap.dedent("""
        import json, sys
        import numpy as np
        import dvmvs_tpu_torch.apps.run_testing_baseline
        import dvmvs_tpu_torch.utils.baseline_weights
        from dvmvs_tpu_torch.baselines import BASELINE_REGISTRY
        from dvmvs_tpu_torch.baselines.gpmvs import GPMVS
        est = type("Small", (GPMVS,), {"image_width": 64, "image_height": 32})(device="cpu")
        K = np.array([[40.0, 0, 32], [0, 40.0, 16], [0, 0, 1]], np.float32)
        pose = np.eye(4); pose[0, 3] = 0.1
        image = np.zeros((32, 64, 3), np.float32)
        depth = est.predict(image, [image], np.eye(4), [pose], K)
        print(json.dumps({
            "registered": sorted(BASELINE_REGISTRY), "shape": list(depth.shape),
            "bad": sorted(m for m in sys.modules
                          if m.split(".")[0] in FORBIDDEN)}))
    """)
    out = subprocess.run([sys.executable, "-c", FORBID + code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True).stdout
    result = json.loads(out.splitlines()[-1])
    assert result["bad"] == []
    assert result["registered"] == ["deltas", "dpsnet", "gpmvs", "mvdepthnet"]
    assert result["shape"] == [32, 64]


def test_bulk_and_tsdf_paths_load_no_jax_cv2_or_tracked_native_library(tmp_path):
    """Run the TSDF path (integrate, marching cubes, a PLY) with the bulk
    modules imported: no jax, flax, cv2 or dvmvs_tpu module is loaded, and
    the shared library in use is the port's own build, not
    native/libdvmvs_native.so."""
    code = textwrap.dedent(f"""
        import json, sys
        import numpy as np
        import dvmvs_tpu_torch.apps.run_testing, dvmvs_tpu_torch.apps.run_tsdf
        import dvmvs_tpu_torch.apps.simulate_keyframe_buffer
        from dvmvs_tpu_torch.ops.tsdf import TSDFVolume
        from dvmvs_tpu_torch.utils import native
        from pathlib import Path
        native.BUILD_ROOT = Path({str(tmp_path / "build")!r})
        vol = TSDFVolume(np.array([[-0.5, 0.5], [-0.5, 0.5], [0.5, 1.5]]), 0.2, device="cpu")
        K = np.array([[14.0, 0, 8], [0, 14.0, 6], [0, 0, 1]], np.float32)
        pose = np.eye(4, dtype=np.float32); pose[2, 3] = -1.0
        vol.integrate(np.full((12, 16, 3), 200, np.uint8), np.full((12, 16), 1.8, np.float32),
                      K, pose)
        verts, faces, norms, rgb = vol.get_mesh()
        native.write_mesh_ply({str(tmp_path / "m.ply")!r}, verts, faces, norms, rgb)
        maps = open("/proc/self/maps").read()
        print(json.dumps({{
            "bad": sorted(m for m in sys.modules
                          if m.split(".")[0] in FORBIDDEN),
            "libs": sorted({{l.split()[-1] for l in maps.splitlines() if "dvmvs_native" in l}}),
            "verts": len(verts)}}))
    """)
    out = subprocess.run([sys.executable, "-c", FORBID + code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    result = json.loads(out.splitlines()[-1])
    assert result["bad"] == [] and result["verts"] > 0
    assert len(result["libs"]) == 1
    assert result["libs"][0].startswith(str(tmp_path / "build"))
    assert not any("native/libdvmvs_native.so" in lib for lib in result["libs"])


TRAINING_MODULES = {f"dvmvs_tpu_torch.{m}" for m in (
    "apps.run_training", "parallel.train", "models.training_heads", "utils.losses",
    "utils.checkpoint", "utils.run_logging", "data.crawler", "data.preprocess",
    "data.dataset", "config", "data.io", "data.synthetic")}

# a string that names the JAX package as a module or a path to one of its files
# (a "file:line" reference in a report is neither)
JAX_PACKAGE_NAME = re.compile(r"^dvmvs_tpu(\.[\w.]+)?$|^dvmvs_tpu/[\w/]*(\.py)?$")


def jax_package_references(source: str) -> list:
    """Imports of dvmvs_tpu or dvmvs_tpu.* in a Python source, and string
    constants (docstrings aside) that name it as a module or a path."""
    tree = ast.parse(source)
    docstrings = {id(node.body[0].value) for node in ast.walk(tree)
                  if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                       ast.AsyncFunctionDef))
                  and node.body and isinstance(node.body[0], ast.Expr)
                  and isinstance(node.body[0].value, ast.Constant)}
    found = []
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docstrings and JAX_PACKAGE_NAME.match(node.value):
            found.append(f"line {node.lineno}: {node.value!r}")
        found += [f"line {node.lineno}: import {n}" for n in names
                  if n == "dvmvs_tpu" or n.startswith("dvmvs_tpu.")]
    return found


def _port_sources():
    package = os.path.join(ROOT, "dvmvs_tpu_torch")
    paths = [os.path.join(d, f) for d, _, files in os.walk(package) for f in files
             if f.endswith(".py")]
    return sorted(paths) + [os.path.join(ROOT, "chip_smoke.py")]


def test_port_sources_name_no_module_or_path_of_the_jax_package():
    """chip_smoke.py imports inside main(), so importing it proves nothing:
    the sources of the port and of chip_smoke.py are read instead. They
    name no path of the tracked native library either."""
    sources = _port_sources()
    assert len(sources) >= 45
    assert {os.path.join(ROOT, "dvmvs_tpu_torch", *m.split(".")[1:]) + ".py"
            for m in BULK_MODULES} <= set(sources)
    found = {os.path.relpath(p, ROOT): jax_package_references(open(p).read())
             + tracked_library_references(open(p).read()) + forbidden_imports(open(p).read())
             for p in sources}
    assert {p: refs for p, refs in found.items() if refs} == {}


def forbidden_imports(source: str) -> list:
    """Import statements of a FORBIDDEN top-level module anywhere in a source
    (chip_smoke.py imports inside functions, which running it here would not
    reach)."""
    found = []
    for node in ast.walk(ast.parse(source)):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        found += [f"line {node.lineno}: import {n}" for n in names
                  if n.split(".")[0] in FORBIDDEN]
    return found


def test_the_forbidden_import_scan_finds_them():
    assert forbidden_imports("def f():\n    import msgpack\n")
    assert forbidden_imports("from PIL import Image")
    assert forbidden_imports("import cv2 as c")
    assert not forbidden_imports("from dvmvs_tpu_torch.utils import msgpack")


def tracked_library_references(source: str) -> list:
    """String constants that name the library tracked in
    native/, which the port must not load."""
    return [f"line {node.lineno}: {node.value!r}" for node in ast.walk(ast.parse(source))
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and "libdvmvs_native.so" in node.value]


def test_the_library_scan_finds_references():
    assert tracked_library_references("lib = ctypes.CDLL('native/libdvmvs_native.so')")
    assert tracked_library_references("p = NATIVE / 'libdvmvs_native.so'")


@pytest.mark.parametrize("snippet", [
    "import dvmvs_tpu",
    "import dvmvs_tpu.config as c",
    "from dvmvs_tpu.config import TestConfig",
    "from dvmvs_tpu import config",
    "def f():\n    from dvmvs_tpu.data.io import load_image",
    "spec = spec_from_file_location('s', os.path.join(ROOT, 'dvmvs_tpu', 'data', 'synthetic.py'))",
    "exec(open('dvmvs_tpu/data/synthetic.py').read())",
    "importlib.import_module('dvmvs_tpu.config')",
])
def test_the_source_scan_finds_references(snippet):
    assert jax_package_references(snippet)


def test_the_source_scan_passes_docstrings_and_reports():
    source = ('"""Counterpart of dvmvs_tpu/data/io.py."""\n'
              'import dvmvs_tpu_torch.config\n'
              'REPLACES = "dvmvs_tpu/ops/pallas/cost_volume_kernel.py:274"\n')
    assert jax_package_references(source) == []


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


def test_editing_the_shared_header_rebuilds_both_kernels(tmp_path, monkeypatch):
    """library_path hashes the headers a source includes: an edit of
    csrc/plane_sweep_common.cuh gives both kernels new libraries."""
    from dvmvs_tpu_torch.ops import plane_sweep

    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc)
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    monkeypatch.setattr(cuda_build, "BUILD_ROOT", tmp_path / "build")
    nvcc = _fake_nvcc(tmp_path, 'while [ "$1" != "-o" ]; do shift; done\ntouch "$2"\necho built\n')
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: nvcc)
    for name in plane_sweep.KERNELS:
        assert '#include "plane_sweep_common.cuh"' in (csrc / f"{name}.cu").read_text()
    before = {name: cuda_build.library_path(name) for name in plane_sweep.KERNELS}
    assert all(log for _, log in cuda_build.build_all(plane_sweep.KERNELS).values())
    assert all(log == "" for _, log in cuda_build.build_all(plane_sweep.KERNELS).values())

    header = csrc / "plane_sweep_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: cuda_build.library_path(name) for name in plane_sweep.KERNELS}
    assert all(after[name] != before[name] for name in plane_sweep.KERNELS)
    rebuilt = cuda_build.build_all(plane_sweep.KERNELS)
    assert all(lib == after[name] and "built" in log for name, (lib, log) in rebuilt.items())
    # another source of a kernel (an earlier version, timed beside it) gets a
    # library of its own
    earlier = tmp_path / "earlier.cu"
    earlier.write_text((csrc / "plane_sweep.cu").read_text() + "\n// earlier\n")
    assert cuda_build.library_path(("plane_sweep", earlier)) not in after.values()
    assert cuda_build.library_path(("plane_sweep", csrc / "plane_sweep.cu")) == after["plane_sweep"]


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
