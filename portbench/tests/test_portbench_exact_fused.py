"""``exact_fused_share``, the reader of the program's ``exactcic.*``
counters: its arithmetic on synthetic totals, None on a program that does
not count them (the parent's), the exact tier's and the COLA readers
unmoved by them, the metric listed for the 512^3 cell alone, and a traced
run of that cell at 16^3 on the CPU, where the tier takes the plain
passes."""
from __future__ import annotations

import time
import types

import pytest

from portbench.lib import harness

from .conftest import small

CELL = "cola512_4gpc.single"
SEED = 2 ** 31 + 2626
READERS = ("exact_roofline", "cola_exact_share", "paint_band_mean",
           "host_syncs")


def _read(name, run):
    return harness.load_module("metrics", name).read(run)


def _run():
    return types.SimpleNamespace(
        realisations_per_call=1, clocked_realisations=2,
        entry="cola_single",
        stage_ms={"paint_exact": 100.0, "gather_exact": 80.0},
        config={"nsamp": 512, "cola": {"n_steps": 16}})


@pytest.fixture
def totals(monkeypatch):
    """Synthetic process totals: two 512^3 COLA calls, 19 exact force
    evaluations (a paint and a gather each) and two exact finishes of four
    paints, all on the kernels."""
    from fastbox_tpu_torch import timing

    t = {"calls": 2, "host_ms": {},
         "counts": {"sync.cola_band": 34, "cola.band1": 4, "cola.band2": 4,
                    "cola.band3": 5, "cola.exact": 21, "kick.fused": 32,
                    "exact.paint": 19, "exact.gather": 57,
                    "exactcic.fused": 46}}
    monkeypatch.setattr(timing, "trace_totals", lambda: t)
    return t


def test_share_of_calls_on_the_kernels(totals):
    run = _run()
    assert _read("exact_fused_share", run) == 100.0
    with_cic = {n: _read(n, run) for n in READERS}
    assert all(v is not None for v in with_cic.values()), with_cic
    totals["counts"].update({"exactcic.fused": 30, "exactcic.plain": 10})
    assert _read("exact_fused_share", run) == 75.0
    assert {n: _read(n, run) for n in READERS} == with_cic
    totals["counts"] = {k: v for k, v in totals["counts"].items()
                        if not k.startswith("exactcic.")}
    assert _read("exact_fused_share", run) is None
    assert {n: _read(n, run) for n in READERS} == with_cic
    # a wrong base: the totals hold two calls, the run clocked three
    totals["counts"]["exactcic.fused"] = 46
    run.clocked_realisations = 3
    assert _read("exact_fused_share", run) is None


def test_none_on_an_older_program(monkeypatch):
    from fastbox_tpu_torch import timing

    monkeypatch.delattr(timing, "trace_totals")
    assert _read("exact_fused_share", _run()) is None


def test_listed_for_the_512_cell_alone():
    m = harness.load_manifest()
    assert "exact_fused_share" in harness.cell_metrics(m, CELL, "per_layer")
    for cell in ("mock256.step_b8", "cola256.single", "mock256.chain16"):
        assert "exact_fused_share" not in harness.cell_metrics(
            m, cell, "per_layer")
    entry = harness._named(m["per_layer"], "exact_fused_share")
    assert entry["layer"] == "COLA exact CIC tier"
    assert entry["moves"] == "realisations_per_s"


def test_traced_run_on_the_cpu_takes_the_plain_passes():
    from fastbox_tpu_torch import timing

    config, traffic = small(CELL)
    # band 1 is passed in the late steps at 16^3, as band 3 is at 512^3
    config["cola"] = dict(config["cola"], lattice_B=1)
    timing.reset_trace_totals()
    try:
        result, _ = harness.execute(CELL, SEED, 0.3, True, "cpu",
                                    time.perf_counter(), config, traffic)
        counts = timing.trace_totals()["counts"]
    finally:
        timing.reset_trace_totals()
    assert result["metrics"]["exact_fused_share"]["value"] == 0.0
    assert counts["exactcic.plain"] > 0 and "exactcic.fused" not in counts
    assert result["correct"], result["checks"]
