"""A run with the timed path broken underneath comes out not correct: each
fault a cell can have (``harness/faults.py``), planted in the port, the
rest of the run as the benchmark makes it (at ``tiny.py``'s size)."""

import pytest
import torch

from benchmark.harness import faults
from benchmark.tests import tiny

CASES = [("fusionnet.online", "frozen_state"), ("fusionnet.online", "altered_answer"),
         ("pairnet.bulk", "half_batch"), ("pairnet.bulk", "altered_answer"),
         ("fusionnet.train", "frozen_state"), ("fusionnet.train", "frozen_buffers"),
         ("fusionnet.train", "half_batch"), ("fusionnet.train", "altered_answer")]
# the check that alone catches a fault, where the others cannot
CAUGHT_BY = {"frozen_buffers": "buffer_gap"}


@pytest.mark.parametrize("cell, fault", CASES)
def test_fault_is_caught(cell, fault):
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    take_off = faults.plant(fault)
    try:
        run = tiny.run(cell, seconds=0.5)
    finally:
        take_off()
        torch.set_num_threads(saved)
    assert not run.correct, run.checks
    if fault in CAUGHT_BY:
        reading, limit = run.checks[CAUGHT_BY[fault]]
        assert reading > limit, run.checks


def test_faults_come_off():
    from dvmvs_tpu_torch.apps.engine import InferenceEngine
    from dvmvs_tpu_torch.parallel import train

    before = (InferenceEngine.__dict__["_write_state"], InferenceEngine.__dict__["_readback"],
              train.train_step, train.fusionnet_loss_fn)
    for name in ("frozen_state", "frozen_buffers", "half_batch", "altered_answer"):
        faults.plant(name)()
    assert before == (InferenceEngine.__dict__["_write_state"],
                      InferenceEngine.__dict__["_readback"], train.train_step,
                      train.fusionnet_loss_fn)
