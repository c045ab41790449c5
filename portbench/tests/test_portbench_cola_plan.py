"""``cola_plan_hit_share``, the reader of the program's ``colaplan.*``
counters: its arithmetic on synthetic totals, None without the counters
(an older program), the COLA readers unmoved by them, and a traced COLA
run at 16^3 on the CPU, whose clocked calls find the plan that the
warm-up built."""
from __future__ import annotations

import time
import types

import pytest

from portbench.lib import harness

from .conftest import small

SEED = 2 ** 31 + 2828
COLA_READERS = ("cola_exact_share", "paint_band_mean", "host_syncs",
                "kick_fused_share")


def _read(name, run):
    return harness.load_module("metrics", name).read(run)


@pytest.fixture
def totals(monkeypatch):
    """Synthetic process totals: two COLA calls of 16 steps, one a call."""
    from fastbox_tpu_torch import timing

    t = {"calls": 2, "host_ms": {},
         "counts": {"sync.cola_band": 34, "cola.band1": 10,
                    "cola.band2": 12, "cola.band3": 8, "cola.exact": 4,
                    "kick.fused": 32}}
    monkeypatch.setattr(timing, "trace_totals", lambda: t)
    return t


def test_share_of_built_plans(totals):
    run = types.SimpleNamespace(realisations_per_call=1,
                                clocked_realisations=2)
    assert _read("cola_plan_hit_share", run) is None
    without = {n: _read(n, run) for n in COLA_READERS}
    totals["counts"].update({"colaplan.hit": 2})
    assert _read("cola_plan_hit_share", run) == 100.0
    assert {n: _read(n, run) for n in COLA_READERS} == without
    totals["counts"].update({"colaplan.hit": 1, "colaplan.miss": 1})
    assert _read("cola_plan_hit_share", run) == 50.0
    assert {n: _read(n, run) for n in COLA_READERS} == without
    # a wrong base: the totals hold two calls, the run clocked three
    run.clocked_realisations = 3
    assert _read("cola_plan_hit_share", run) is None


def test_none_on_an_older_program(monkeypatch):
    from fastbox_tpu_torch import timing

    monkeypatch.delattr(timing, "trace_totals")
    run = types.SimpleNamespace(realisations_per_call=1,
                                clocked_realisations=2)
    assert _read("cola_plan_hit_share", run) is None


def test_listed_for_the_cola_cells():
    m = harness.load_manifest()
    for cell in ("cola256.single", "cola512_4gpc.single"):
        assert "cola_plan_hit_share" in harness.cell_metrics(m, cell,
                                                             "per_layer")
    for cell in ("mock256.step_b8", "mock256.chain16"):
        assert "cola_plan_hit_share" not in harness.cell_metrics(
            m, cell, "per_layer")


def test_traced_cola_run_on_the_cpu_finds_the_plan_built():
    from fastbox_tpu_torch import timing

    config, traffic = small("cola256.single")
    timing.reset_trace_totals()
    try:
        result, _ = harness.execute("cola256.single", SEED, 0.3, True, "cpu",
                                    time.perf_counter(), config, traffic)
        counts = timing.trace_totals()["counts"]
    finally:
        timing.reset_trace_totals()
    assert result["metrics"]["cola_plan_hit_share"]["value"] == 100.0
    assert counts["colaplan.hit"] > 0 and "colaplan.miss" not in counts
