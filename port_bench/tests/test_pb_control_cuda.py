"""On the card, at each cell's own size and load: the program as it serves
passes the check, and the control (the program with its int8-activation
paths on: W4A8 decode, W8A8 prefill and, for the 7B, int8 towers) fails
it. One seed each; ``control.py`` reads many.

    python -m pytest port_bench/tests/test_pb_control_cuda.py -q -m cuda"""

import time

import pytest
from conftest import ROOT

from port_bench import core

CELLS = ["a3vlm7b-eval-rec2d"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cuda_card, cell):
    seed = 2 ** 31 + 101
    control, _ = core.run_cell(ROOT, cell, seed, 0.0, False, cuda_card,
                               time.perf_counter(), control=True)
    program, _ = core.run_cell(ROOT, cell, seed, 0.0, False, cuda_card,
                               time.perf_counter())
    assert not control["correct"], control["check"]
    assert program["correct"], program["check"]
