"""The readers of the program's RSD work counters (``rsdwork.*``) and the
512^3 mock cell that reports them: their arithmetic on synthetic totals
(the 512^3 bound among them), None without the counters (an older
program), the ``rsd.*`` readers unmoved by the new family, the cell found
by name and held to the manifest's rules, a traced run of the cell at
16^3 on the CPU that reports both readers, and the bfloat16 control
failing a limit there."""
from __future__ import annotations

import time
import types

import pytest

from portbench.calibrate import readings
from portbench.lib import harness, peaks

from .conftest import small

CELL = "mock512.single"
SEED = 2 ** 31 + 2929
RSDWORK = ("rsd_roofline", "rsd_disp_cells")
RSD_READERS = ("rsd_exact_share", "rsd_exact_share.chain", "host_syncs",
               "host_syncs.chain")


def _read(name, run):
    return harness.load_module("metrics", name).read(run)


def _run(stage_ms, per_call=1, clocked=2, dtype="float32"):
    return types.SimpleNamespace(
        realisations_per_call=per_call, clocked_realisations=clocked,
        entry="chained_pipeline", stage_ms=stage_ms,
        config={"nsamp": 512, "pipeline": {"dtype": dtype}})


@pytest.fixture
def totals(monkeypatch):
    """Synthetic process totals: two 512^3 calls of one realisation, each
    remap on K2's band 4, 2.150 and 2.250 cells read."""
    from fastbox_tpu_torch import timing

    t = {"calls": 2, "host_ms": {},
         "counts": {"sync.rsd_band": 2, "sync.eigh": 2, "rsd.band4": 2,
                    "rsdwork.cells": 2 * 512 ** 3,
                    "rsdwork.disp_mcells": 2150 + 2250,
                    "rsdwork.disp_reads": 2}}
    monkeypatch.setattr(timing, "trace_totals", lambda: t)
    return t


def test_rsd_work_bound_at_512():
    roof = harness.load_module("metrics", "rsd_roofline")
    n_bytes, ops = roof.work(512 ** 3)
    assert n_bytes == 12 * 512 ** 3 == 1_610_612_736
    b, by = peaks.bound_ms(n_bytes, ops)
    assert by == "bytes" and b == pytest.approx(0.480780, rel=1e-5)
    # float64 cells move twice the bytes
    assert roof.work(512 ** 3, "float64")[0] == 2 * n_bytes


def test_readers_on_synthetic_totals(totals):
    run = _run({"rsd": 8.0})
    b = 12 * 512 ** 3 / peaks.PEAK_BYTES_S * 1e3
    assert _read("rsd_roofline", run) == pytest.approx(100.0 * b / 4.0)
    assert _read("rsd_disp_cells", run) == pytest.approx(2.2)
    # the sharded step: eight realisations a call, their cells counted
    # in one remap of 8 N^2 rows
    totals["counts"]["rsdwork.cells"] = 2 * 8 * 256 ** 3
    totals["counts"]["rsdwork.disp_reads"] = 2
    run = _run({"rsd": 16 * 2.4}, per_call=8, clocked=16)
    b = 12 * 256 ** 3 / peaks.PEAK_BYTES_S * 1e3
    assert _read("rsd_roofline", run) == pytest.approx(100.0 * b / 2.4)
    # a wrong base: the totals hold two calls, the run clocked three
    for name in RSDWORK:
        assert _read(name, _run({"rsd": 8.0}, clocked=3)) is None, name


def test_none_without_the_rsdwork_counters(totals):
    """The parent's program: ``rsd.*`` and ``sync.*`` but no
    ``rsdwork.*``."""
    totals["counts"] = {k: v for k, v in totals["counts"].items()
                        if not k.startswith("rsdwork.")}
    run = _run({"rsd": 8.0})
    for name in RSDWORK:
        assert _read(name, run) is None, name
    # cells counted but no displacement read (the exact tier on targets
    # that are not uniform), or no 'rsd' stage
    totals["counts"]["rsdwork.cells"] = 2 * 512 ** 3
    assert _read("rsd_disp_cells", run) is None
    assert _read("rsd_roofline", _run({})) is None


def test_none_on_an_older_program(monkeypatch):
    from fastbox_tpu_torch import timing

    monkeypatch.delattr(timing, "trace_totals")
    for name in RSDWORK:
        assert _read(name, _run({"rsd": 8.0})) is None, name


def test_rsd_readers_unmoved_by_the_work_family(totals):
    run = _run({})
    with_work = {n: _read(n, run) for n in RSD_READERS}
    assert with_work["rsd_exact_share"] == 0.0
    assert with_work["host_syncs"] == 2.0
    totals["counts"] = {k: v for k, v in totals["counts"].items()
                        if not k.startswith("rsdwork.")}
    assert {n: _read(n, run) for n in RSD_READERS} == with_work
    totals["counts"]["rsd.exact"] = 2
    assert _read("rsd_exact_share", run) == 50.0


def test_cell_found_and_within_the_rules():
    m = harness.load_manifest()
    w, config, traffic = harness.cell_files(m, CELL)
    assert w["chips"] == 1 and config["name"] == w["config"]
    assert traffic["entry"] == "chained_pipeline"
    assert traffic["realisations_per_call"] == 1
    assert set(traffic["limits"]) == {"pk_density_gap", "pk_cleaned_gap",
                                      "pk_cleaned_err_gap", "sigma_data_gap"}
    # the 256^3 configuration's deployment at 512^3, nothing cut
    _, c256, _ = harness.cell_files(m, "mock256.chain16")
    same = ("source", "box_mpc", "redshift", "cosmology", "pipeline",
            "precision")
    assert {k: config[k] for k in same} == {k: c256[k] for k in same}
    assert config["nsamp"] == 512 and config["reduced"] == []
    assert "nsamp" in config["assumed"]
    entry_cfg = harness._named(m["configs"], config["name"])
    assert entry_cfg["reduced"] == [] and \
        entry_cfg["source"] == config["source"]
    layer = harness.cell_metrics(m, CELL, "per_layer")
    for name in RSDWORK + ("call_ms_p50", "stage_ms.draw",
                           "stage_ms.foregrounds", "stage_ms.rsd",
                           "stage_ms.pca", "pk_roofline", "device_idle_pct",
                           "host_syncs", "rsd_exact_share"):
        assert name in layer, name
    e2e = harness.cell_metrics(m, CELL, "end_to_end")
    assert {"realisations_per_s", "call_ms_p95", "setup_s"} <= set(e2e)
    for x in m["per_layer"]:
        if x["name"] in RSDWORK:
            assert x["layer"] == "RSD remap"
            assert x["moves"] == "realisations_per_s"
    assert "mock256.step_b8" in harness._named(
        m["per_layer"], "rsd_roofline")["workloads"]
    # the chain's metrics stay the chain's
    for name in layer + e2e:
        assert not name.endswith(".chain"), name


def test_traced_run_at_16_reports_the_rsd_work():
    from fastbox_tpu_torch import timing

    config, traffic = small(CELL)
    timing.reset_trace_totals()
    try:
        result, _ = harness.execute(CELL, SEED, 0.3, True, "cpu",
                                    time.perf_counter(), config, traffic)
        counts = timing.trace_totals()["counts"]
    finally:
        timing.reset_trace_totals()
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(RSDWORK) <= set(got), set(RSDWORK) - set(got)
    assert 0 < got["rsd_roofline"] < 100
    # one remap a realisation, its displacement read once
    assert counts["rsdwork.cells"] == 16 ** 3 * counts["rsdwork.disp_reads"]
    assert got["rsd_disp_cells"] == pytest.approx(
        counts["rsdwork.disp_mcells"] / 1000 / counts["rsdwork.disp_reads"])
    assert 0 < got["rsd_disp_cells"] < 4
    assert got["host_syncs"] == 2.0
    assert got["rsd_exact_share"] == 0.0
    assert result["correct"], result["checks"]


def test_control_fails_a_limit_at_16():
    config, traffic = small(CELL)
    summary = readings(CELL, [], [2 ** 31 + 77], "cpu", config, traffic,
                       emit=lambda line: None)
    over = {k: v for k, v in summary["control_min"].items()
            if v > traffic["limits"][k]}
    assert over, summary
