"""The control, the reference computed in bfloat16 in the program's place
(``reference/control.py``), comes out not correct: at least one of each
cell's compared numbers lies above its limit.  At 16^3 on the CPU; the
readings at the cells' own size are in PERF.md."""
from __future__ import annotations

import pytest

from portbench.calibrate import readings

from .conftest import CELLS, small


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(cell):
    config, traffic = small(cell)
    summary = readings(cell, [], [2 ** 31 + 77], "cpu", config, traffic,
                       emit=lambda line: None)
    over = {k: v for k, v in summary["control_min"].items()
            if v > traffic["limits"][k]}
    assert over, summary
