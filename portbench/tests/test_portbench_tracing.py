"""The readers of the program's own trace (``lib/trace.py``): their
arithmetic on synthetic totals, None on a wrong base or an older program,
and a traced run of each cell at 16^3 on the CPU that reports every one of
its trace metrics."""
from __future__ import annotations

import time
import types

import pytest

from portbench.lib import harness

from .conftest import CELLS, small

TRACE_METRICS = {
    "host_syncs", "host_syncs.chain", "rsd_exact_share",
    "rsd_exact_share.chain", "collectives", "collective_mb",
    "cola_exact_share", "paint_band_mean", "host_ms.schedule",
    "host_ms.draw.chain", "host_ms.foregrounds.chain"}
SEED = 2 ** 31 + 2323


def _read(name, run):
    return harness.load_module("metrics", name).read(run)


def _run(per_call=8, clocked=16):
    return types.SimpleNamespace(realisations_per_call=per_call,
                                 clocked_realisations=clocked)


@pytest.fixture
def totals(monkeypatch):
    """Synthetic process totals: two calls of eight realisations."""
    from fastbox_tpu_torch import timing

    t = {"calls": 2,
         "host_ms": {"draw": 16.0, "foregrounds": 48.0, "schedule": 40.0},
         "counts": {"sync.rsd_cover": 2, "sync.eigh": 2, "rsd.band4": 1,
                    "rsd.exact": 1, "collective.calls": 48,
                    "collective.bytes": 8_000_000_000, "cola.band1": 6,
                    "cola.band2": 1, "cola.band3": 1, "cola.exact": 2}}
    monkeypatch.setattr(timing, "trace_totals", lambda: t)
    return t


def test_readers_on_synthetic_totals(totals):
    run = _run()
    assert _read("host_syncs", run) == _read("host_syncs.chain", run) == 0.25
    assert _read("rsd_exact_share", run) == 50.0
    assert _read("rsd_exact_share.chain", run) == 50.0
    assert _read("collectives", run) == 3.0
    assert _read("collective_mb", run) == pytest.approx(500.0)
    assert _read("cola_exact_share", run) == 20.0
    assert _read("paint_band_mean", run) == pytest.approx(11 / 8)
    assert _read("host_ms.schedule", run) == 2.5
    assert _read("host_ms.draw.chain", run) == 1.0
    assert _read("host_ms.foregrounds.chain", run) == 3.0


def test_readers_give_none_on_a_wrong_base(totals):
    # the totals hold two calls; the run clocked three, or none
    for run in (_run(clocked=24), _run(clocked=0)):
        for name in TRACE_METRICS:
            assert _read(name, run) is None, name


def test_readers_give_none_without_a_family(totals):
    totals["counts"] = {"sync.eigh": 2}
    totals["host_ms"] = {}
    run = _run()
    assert _read("host_syncs", run) == 0.125
    assert _read("collectives", run) == 0.0
    for name in ("rsd_exact_share", "cola_exact_share", "paint_band_mean",
                 "host_ms.schedule", "host_ms.draw.chain"):
        assert _read(name, run) is None, name
    totals["counts"] = {"cola.exact": 4}
    assert _read("cola_exact_share", run) == 100.0
    assert _read("paint_band_mean", run) is None


def test_readers_give_none_on_an_older_program(monkeypatch):
    from fastbox_tpu_torch import timing

    monkeypatch.delattr(timing, "trace_totals")
    for name in TRACE_METRICS:
        assert _read(name, _run()) is None, name


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_every_trace_metric(cell):
    from fastbox_tpu_torch import timing

    m = harness.load_manifest()
    want = TRACE_METRICS & set(harness.cell_metrics(m, cell, "per_layer"))
    assert want
    config, traffic = small(cell)
    timing.reset_trace_totals()
    try:
        result, _ = harness.execute(cell, SEED, 0.3, True, "cpu",
                                    time.perf_counter(), config, traffic)
    finally:
        calls = timing.trace_totals()["calls"]
        timing.reset_trace_totals()
    assert calls >= 1
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert want <= set(got), want - set(got)
    for name in want:
        assert got[name] is not None and got[name] >= 0.0, name
    if cell == "mock256.step_b8":
        # one cover check and one batched eigh a call; one tier a call
        assert got["host_syncs"] == pytest.approx(
            2 / traffic["realisations_per_call"])
        assert got["rsd_exact_share"] in (0.0, 100.0)
        assert got["collectives"] > 0 and got["collective_mb"] > 0
    elif cell == "mock256.chain16":
        assert got["host_syncs.chain"] == 2.0
    else:
        # the band picks of the force evaluations and of the finish
        n = int(config["cola"]["n_steps"])
        assert got["host_syncs"] == n + 1
        assert got["cola_exact_share"] <= 100.0
        assert 1.0 <= got["paint_band_mean"] <= 3.0
