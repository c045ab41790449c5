"""The keyed mock survey where its RSD takes K2's band-4 tier: the chained
pipeline at one key against the plain reference, and the RSD work
counters (``rsdwork.*``) beside the tier counter.

On the CPU at 32^3 with one intra-op thread, in the 512^3 configuration's
physics (``portbench/configs/im_mock_4gpc_512.json``) and float32.  The
largest displacement is ~11 Mpc whatever the box, so a 125 Mpc box (3.9
Mpc cells) puts it at ~2.6 cells, past band 2 and inside band 4, as the
4 Gpc box does at 512^3 (~2.2 cells); a 250 Mpc box (7.9 Mpc cells) puts
it at ~1.4 cells, inside band 2.
"""
import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from fastbox_tpu_torch import pipeline, timing
from portbench.lib.program import grid_and_cosmology, pipeline_config
from portbench.reference.compare import MOCK_OUTPUTS, mock_gaps
from portbench.reference.mock import MockReference

CONFIG = Path(__file__).resolve().parents[1] / "portbench" / "configs" / \
    "im_mock_4gpc_512.json"
N = 32
SEED = 2 ** 31 + 2929
# Widest relative gaps to the float64 reference on the same float32 draws.
TOLERANCE = {
    # the density's spectrum: the float32 half-spectrum times the float32
    # sqrt(P); ~1.6e-7 read, a few float32 roundings
    "pk_density_gap": 1e-5,
    # the cleaned spectrum and its error: the clean subtracts foregrounds
    # ~1e4 times the signal, so float32 rounding of the data cube shows
    # magnified in the residual; 0.6e-3 read over five seeds
    "pk_cleaned_gap": 1e-2,
    "pk_cleaned_err_gap": 1e-2,
    # the data cube's rms, one float32 sum of N^3 values: ~5e-7 read
    "sigma_data_gap": 1e-5,
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(box: float) -> dict:
    config = copy.deepcopy(json.loads(CONFIG.read_text()))
    config.update(nsamp=N, box_mpc=box)
    return config


def _run(config: dict, clock=None) -> dict:
    """``make_pipeline``'s single call on the key ``SEED`` (what the
    cell's chain runs at one key), on ``clock``."""
    grid, cosmo = grid_and_cosmology(config, "cpu")
    single = pipeline.make_pipeline(grid, cosmo, pipeline_config(config),
                                    "cpu")
    out = single(SEED, None, clock)
    return {k: out[k].cpu().numpy() for k in MOCK_OUTPUTS}


def _reference_disp_cells(ref: MockReference) -> float:
    """max |v_z + sigma_NL n| / H / dz of the reference's realisation of
    ``SEED``, in float64 from the same float32 draws."""
    g = ref.geo
    d = ref._draw_fields(SEED, "keys")
    vel = torch.fft.irfftn(1j * ref.vz_w * d["delta_k"], (g.N,) * 3) \
        + ref.p["sigma_nl"] * d["rsd"]
    dz = float(g.z[1] - g.z[0])
    return float(vel.abs().max()) / g.Hz / dz


@pytest.fixture(scope="module")
def band4():
    """(outputs, counts) of one clocked call in the band-4 box."""
    config = _config(125.0)
    clock = timing.StageClock("cpu")
    out = _run(config, clock)
    return config, out, clock.counts()


def test_chain_matches_the_reference_at_band_4(band4):
    config, out, _ = band4
    grid, cosmo = grid_and_cosmology(config, "cpu")
    chain = pipeline.make_chained_pipeline(grid, cosmo,
                                           pipeline_config(config), "cpu")
    got = chain(generators=[SEED])
    for k in MOCK_OUTPUTS:
        # the chain at K = 1 is the single call, bit for bit (the empty
        # top bins of a 32^3 cube are NaN in both, as in the reference)
        assert np.array_equal(got[k][0].numpy(), out[k], equal_nan=True), k
    ref = MockReference(config, "cpu").realise(SEED, "keys")
    gaps = mock_gaps(out, ref)
    for k, tol in TOLERANCE.items():
        assert gaps[k] <= tol, (k, gaps[k])


def test_band_4_counted_once_with_its_work(band4):
    config, _, counts = band4
    rsd = {k: v for k, v in counts.items() if k.startswith("rsd.")}
    assert rsd == {"rsd.band4": 1}
    assert counts["rsdwork.cells"] == N ** 3
    assert counts["rsdwork.disp_reads"] == 1
    assert counts["sync.rsd_band"] == 1
    want = _reference_disp_cells(MockReference(config, "cpu"))
    assert 2.0 < want < 4.0
    # the program reads max|v| in float32 (a few units of 6e-8 from the
    # float64 value) and times 1/H in float32; counted to the nearest
    # thousandth of a cell, so at most one count apart
    assert abs(counts["rsdwork.disp_mcells"] - 1000.0 * want) <= 1.0


def test_band_2_box_moves_the_counters_with_the_tier():
    config = _config(250.0)
    clock = timing.StageClock("cpu")
    _run(config, clock)
    counts = clock.counts()
    assert {k: v for k, v in counts.items() if k.startswith("rsd.")} == \
        {"rsd.band2": 1}
    assert counts["rsdwork.cells"] == N ** 3
    assert counts["rsdwork.disp_reads"] == 1
    assert 0 < counts["rsdwork.disp_mcells"] <= 2000


def test_without_a_clock_no_totals():
    timing.reset_trace_totals()
    try:
        _run(_config(125.0))
        t = timing.trace_totals()
        assert t["calls"] == 0 and t["counts"] == {}
    finally:
        timing.reset_trace_totals()
