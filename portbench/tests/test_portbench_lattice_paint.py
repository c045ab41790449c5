"""``lattice_paint_kernel_share``, the reader of the program's
``latpaint.*`` counters: 100 where every lattice paint took K11a, 0 where
every one took the plain roll sums, None without the counters (an older
program), the COLA readers unmoved by them, the metric listed for the two
COLA cells alone, and a traced COLA run at 16^3 on the CPU, where every
paint takes the plain roll sums."""
from __future__ import annotations

import time
import types

import pytest

from portbench.lib import harness

from .conftest import small

SEED = 2 ** 31 + 3030
METRIC = "lattice_paint_kernel_share"
COLA_CELLS = ("cola256.single", "cola512_4gpc.single")
COLA_READERS = ("cola_exact_share", "paint_band_mean", "kick_fused_share",
                "host_syncs")


def _read(name, run):
    return harness.load_module("metrics", name).read(run)


def _run():
    return types.SimpleNamespace(realisations_per_call=1,
                                 clocked_realisations=2)


@pytest.fixture
def totals(monkeypatch):
    """Synthetic process totals: two COLA calls of 16 force evaluations and
    a finish of four paints each, every paint on the lattice."""
    from fastbox_tpu_torch import timing

    t = {"calls": 2, "host_ms": {},
         "counts": {"sync.cola_band": 34, "cola.band1": 10,
                    "cola.band2": 12, "cola.band3": 12, "kick.fused": 32,
                    "latpaint.kernel": 40}}
    monkeypatch.setattr(timing, "trace_totals", lambda: t)
    return t


def test_share_of_paints_on_the_kernel(totals):
    run = _run()
    assert _read(METRIC, run) == 100.0
    with_paint = {n: _read(n, run) for n in COLA_READERS}
    assert all(v is not None for v in with_paint.values()), with_paint
    totals["counts"].pop("latpaint.kernel")
    totals["counts"]["latpaint.plain"] = 40
    assert _read(METRIC, run) == 0.0
    totals["counts"].update({"latpaint.kernel": 30, "latpaint.plain": 10})
    assert _read(METRIC, run) == 75.0
    assert {n: _read(n, run) for n in COLA_READERS} == with_paint
    totals["counts"] = {k: v for k, v in totals["counts"].items()
                        if not k.startswith("latpaint.")}
    assert _read(METRIC, run) is None
    assert {n: _read(n, run) for n in COLA_READERS} == with_paint
    # a wrong base: the totals hold two calls, the run clocked three
    totals["counts"]["latpaint.kernel"] = 40
    run.clocked_realisations = 3
    assert _read(METRIC, run) is None


def test_none_on_an_older_program(monkeypatch):
    from fastbox_tpu_torch import timing

    monkeypatch.delattr(timing, "trace_totals")
    assert _read(METRIC, _run()) is None


def test_listed_for_the_cola_cells_alone():
    m = harness.load_manifest()
    for cell in COLA_CELLS:
        assert METRIC in harness.cell_metrics(m, cell, "per_layer")
    for cell in ("mock256.step_b8", "mock256.chain16", "mock512.single"):
        assert METRIC not in harness.cell_metrics(m, cell, "per_layer")


def test_traced_cola_run_on_the_cpu_takes_the_plain_paint():
    from fastbox_tpu_torch import timing

    config, traffic = small("cola256.single")
    timing.reset_trace_totals()
    try:
        result, _ = harness.execute("cola256.single", SEED, 0.3, True, "cpu",
                                    time.perf_counter(), config, traffic)
        counts = timing.trace_totals()["counts"]
    finally:
        timing.reset_trace_totals()
    assert result["metrics"][METRIC]["value"] == 0.0
    assert counts["latpaint.plain"] > 0 and "latpaint.kernel" not in counts
