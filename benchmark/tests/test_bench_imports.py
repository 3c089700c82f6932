"""What the benchmark's process loads: never JAX or the JAX package (whole
top-level names compared, since ``dvmvs_tpu_torch`` begins with
``dvmvs_tpu``), and the reference nothing of the port. A run without a
card fails and prints no result."""

import json
import subprocess
import sys

from benchmark.harness import core

ROOT = str(core.ROOT)


def python(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=600)


def test_top_level_names_are_compared_whole():
    sys.modules.setdefault("dvmvs_tpu_torch_lookalike", sys)
    assert "dvmvs_tpu_torch_lookalike" not in core.forbidden_modules()


def test_reference_loads_nothing_of_the_port():
    p = python("import sys, json\n"
               "import benchmark.reference.nets, benchmark.reference.loops, "
               "benchmark.reference.geometry\n"
               "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert p.returncode == 0, p.stderr
    names = json.loads(p.stdout.strip().splitlines()[-1])
    assert not {"dvmvs_tpu_torch", "dvmvs_tpu", "jax", "jaxlib", "flax"} & set(names)


def test_a_run_of_every_cell_loads_no_jax():
    p = python("import torch; torch.set_num_threads(2)\n"
               "from benchmark.harness import core, faults, readers\n"
               "from benchmark.tests import tiny\n"
               "for cell in ('fusionnet.online', 'pairnet.bulk', 'fusionnet.train'):\n"
               "    tiny.run(cell, seconds=0.3)\n"
               "for m in core.spec()['end_to_end'] + core.spec()['per_layer']:\n"
               "    core.load_code('metrics', m['name'])\n"
               "print('FORBIDDEN', core.forbidden_modules())")
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "FORBIDDEN []"


def test_a_run_without_a_card_exits_without_a_result():
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "fusionnet.online",
                        "--seed", "2147483653", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode != 0
    assert "correct" not in p.stdout
    assert "CUDA device" in p.stderr
