"""Shared pieces of the benchmark's CPU tests: cells cut to a size the
CPU holds (same cell width, fewer cells a side), and the card fixture."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.lib import harness  # noqa: E402

CELLS = ("mock256.step_b8", "cola256.single", "mock256.chain16")
SMALL_N = 16


def small(cell: str, n: int = SMALL_N):
    """(config, traffic) of ``cell`` at n^3 (the box cut with it, so the
    cells keep their width) and at most two realisations a call."""
    _, config, traffic = harness.cell_files(harness.load_manifest(), cell)
    config = dict(config, nsamp=n,
                  box_mpc=config["box_mpc"] * n / config["nsamp"])
    traffic = dict(traffic, realisations_per_call=min(
        2, traffic["realisations_per_call"]), warmup_calls=1)
    return config, traffic


@pytest.fixture
def cuda_device():
    """The CUDA card, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
