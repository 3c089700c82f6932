"""The control on the card: each cell, with the port's TF32 path switched on
(``utils/precision.py::unpinned``, the precision below the configuration's
float32), comes out not correct, and the same cell in IEEE float32 correct,
at ``tiny.py``'s size. The full-size readings of the control are in
PERF.md (``run.py --control``). Skips where there is no card."""

import pytest
import torch

from benchmark.tests import tiny

CELLS = ("fusionnet.online", "pairnet.bulk", "fusionnet.train")


def on_card(cell: str, **kwargs):
    ctx = tiny.context(cell, **kwargs)
    ctx.device = "cuda"
    from benchmark.harness import core

    return core.run_cell(ctx)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_and_the_program_is(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control is TF32, which only the card computes")
    from dvmvs_tpu_torch.utils.precision import unpinned

    assert on_card(cell, seed=31, seconds=1.0).correct
    with unpinned():
        control = on_card(cell, seed=32, seconds=1.0)
    assert not control.correct, control.checks
