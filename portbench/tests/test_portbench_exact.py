"""The COLA exact CIC tier's readers and the 512^3 cell that reports them:
their arithmetic on synthetic totals, None without the program's
``exact.*`` counters (an older program), the ``cola.*`` readers unmoved by
them, the cell found by name and held to the manifest's rules, and a
traced run of the cell at 16^3 on the CPU that takes the exact tier."""
from __future__ import annotations

import time
import types

import pytest

from portbench.calibrate import readings
from portbench.lib import harness, peaks

from .conftest import small

CELL = "cola512_4gpc.single"
SEED = 2 ** 31 + 2525
EXACT = ("stage_ms.paint_exact", "stage_ms.gather_exact", "exact_roofline")
COLA_READERS = ("cola_exact_share", "paint_band_mean", "host_syncs")


def _read(name, run):
    return harness.load_module("metrics", name).read(run)


def _run(stage_ms, N=512, clocked=2):
    return types.SimpleNamespace(
        realisations_per_call=1, clocked_realisations=clocked,
        entry="cola_single", stage_ms=stage_ms,
        config={"nsamp": N, "cola": {"n_steps": 16}})


@pytest.fixture
def totals(monkeypatch):
    """Synthetic process totals: two 512^3 COLA calls, 9 and 10 of their
    16 force evaluations on the exact tier, both finishes exact."""
    from fastbox_tpu_torch import timing

    t = {"calls": 2, "host_ms": {},
         "counts": {"sync.cola_band": 34, "cola.band1": 4, "cola.band2": 4,
                    "cola.band3": 5, "cola.exact": 21, "kick.fused": 32,
                    "exact.paint": 19, "exact.gather": 57}}
    monkeypatch.setattr(timing, "trace_totals", lambda: t)
    return t


def test_exact_work_counts_at_512():
    roof = harness.load_module("metrics", "exact_roofline")
    N = 512
    assert roof.gather_work(N)[0] == 36 * N ** 3 == 4_831_838_208
    b, by = peaks.bound_ms(*roof.gather_work(N))
    assert by == "bytes" and b == pytest.approx(1.442340, rel=1e-5)
    # a force evaluation: 16 N^3 painted + 36 N^3 gathered, 2.08 ms
    assert roof.bound(N, 1, 3) == pytest.approx(
        52 * N ** 3 / peaks.PEAK_BYTES_S * 1e3)
    assert roof.bound(N, 1, 3) == pytest.approx(2.0832, rel=1e-4)


def test_readers_on_synthetic_totals(totals):
    run = _run({"paint_exact": 1000.0, "gather_exact": 3000.0,
                "paint": 200.0})
    assert _read("stage_ms.paint_exact", run) == 500.0
    assert _read("stage_ms.gather_exact", run) == 1500.0
    roof = harness.load_module("metrics", "exact_roofline")
    want = 100.0 * roof.bound(512, 9.5, 28.5) / 2000.0
    assert _read("exact_roofline", run) == pytest.approx(want)
    assert 0.9 < want < 1.0
    # the lattice paint's reader reads its own stage alone
    assert _read("stage_ms.paint", run) == 100.0


def test_none_without_the_exact_counters(totals):
    """The parent's program: the exact tier marked 'paint' and 'gather'
    and no ``exact.*`` counts."""
    totals["counts"] = {k: v for k, v in totals["counts"].items()
                        if not k.startswith("exact.")}
    run = _run({"paint": 2000.0, "gather": 6000.0})
    for name in EXACT:
        assert _read(name, run) is None, name
    # counters without the stages, or stages on a wrong base
    totals["counts"].update({"exact.paint": 19, "exact.gather": 57})
    assert _read("exact_roofline", run) is None
    run = _run({"paint_exact": 1000.0, "gather_exact": 3000.0}, clocked=3)
    assert _read("exact_roofline", run) is None


def test_none_on_an_older_program(monkeypatch):
    from fastbox_tpu_torch import timing

    monkeypatch.delattr(timing, "trace_totals")
    run = _run({"paint_exact": 1000.0, "gather_exact": 3000.0})
    assert _read("exact_roofline", run) is None


def test_cola_readers_unmoved_by_the_exact_family(totals):
    run = _run({})
    with_exact = {n: _read(n, run) for n in COLA_READERS}
    assert with_exact["cola_exact_share"] == pytest.approx(100 * 21 / 34)
    assert with_exact["paint_band_mean"] == pytest.approx(27 / 13)
    totals["counts"] = {k: v for k, v in totals["counts"].items()
                        if not k.startswith("exact.")}
    assert {n: _read(n, run) for n in COLA_READERS} == with_exact


def test_cell_found_and_within_the_rules():
    m = harness.load_manifest()
    w, config, traffic = harness.cell_files(m, CELL)
    assert w["chips"] == 1 and config["name"] == w["config"]
    entry = harness.load_module("entries", traffic["entry"])
    assert traffic["entry"] == "cola_single"
    for fn in ("build", "gaps", "reference"):
        assert callable(getattr(entry, fn))
    assert set(traffic["limits"]) == {"delta_gap", "vel_gap"}
    # the 256^3 configuration's deployment at bench_cola.py's 512^3
    _, c256, _ = harness.cell_files(m, "cola256.single")
    same = ("box_mpc", "redshift", "cosmology", "cola", "precision",
            "source")
    assert {k: config[k] for k in same} == {k: c256[k] for k in same}
    assert config["nsamp"] == 512 and config["reduced"] == []
    entry_cfg = harness._named(m["configs"], config["name"])
    assert entry_cfg["reduced"] == [] and entry_cfg["source"] == \
        config["source"]
    layer = harness.cell_metrics(m, CELL, "per_layer")
    for name in EXACT + ("call_ms_p50", "device_idle_pct", "host_syncs",
                         "cola_exact_share", "stage_ms.update",
                         "kick_fused_share"):
        assert name in layer, name
    # readers that count n_steps lattice paints, and a p95 over ~14 calls
    for name in ("paint_roofline", "stage_ms.paint"):
        assert name not in layer, name
    e2e = harness.cell_metrics(m, CELL, "end_to_end")
    # the peak read 28.0004 GiB on every run and seed (PERF.md section 2)
    assert {"realisations_per_s", "peak_device_gib", "setup_s"} <= set(e2e)
    assert "call_ms_p95" not in e2e
    for x in m["per_layer"]:
        if x["name"] in EXACT:
            assert x["layer"] == "COLA exact CIC tier"
            assert x["moves"] == "realisations_per_s"
            assert x["workloads"] == [CELL]
    # the cell reaches none of the other cells' metric lists it should not
    for other in ("mock256.step_b8", "cola256.single", "mock256.chain16"):
        assert not set(EXACT) & set(harness.cell_metrics(m, other,
                                                         "per_layer"))


def test_traced_run_at_16_reports_the_exact_tier():
    from fastbox_tpu_torch import timing

    config, traffic = small(CELL)
    # at 16^3 the displacements stay under band 3; band 1 is passed in the
    # late steps at the deployment's 7.8 Mpc cells, as band 3 is at 512^3
    config["cola"] = dict(config["cola"], lattice_B=1)
    timing.reset_trace_totals()
    try:
        result, lines = harness.execute(CELL, SEED, 0.3, True, "cpu",
                                        time.perf_counter(), config, traffic)
    finally:
        timing.reset_trace_totals()
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(EXACT) <= set(got), set(EXACT) - set(got)
    assert got["stage_ms.paint_exact"] > 0 and got["stage_ms.gather_exact"] > 0
    assert 0 < got["exact_roofline"]
    assert 0 < got["cola_exact_share"] <= 100
    assert got["host_syncs"] == config["cola"]["n_steps"] + 1
    assert result["correct"], result["checks"]
    assert any("paint_exact" in line for line in lines)


def test_control_fails_a_limit_at_16():
    config, traffic = small(CELL)
    summary = readings(CELL, [], [2 ** 31 + 77], "cpu", config, traffic,
                       emit=lambda line: None)
    over = {k: v for k, v in summary["control_min"].items()
            if v > traffic["limits"][k]}
    assert over, summary
