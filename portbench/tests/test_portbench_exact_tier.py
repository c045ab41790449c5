"""The readers of the RSD exact tier (``stage_ms.rsd_exact.chain``,
``rsd_exact_roofline.chain``) and the 1 Gpc mock cell that reports them:
their arithmetic on synthetic totals, None without the counter or the
stage (an older program, or a run with no exact remap), the cell found by
name and held to the manifest's rules, a traced run at 16^3 in a box past
band 4 that reports both, and the bfloat16 control failing a limit of the
cell."""
from __future__ import annotations

import time
import types

import pytest

from portbench.calibrate import readings
from portbench.lib import harness, peaks

from .conftest import small

CELL = "mock1gpc_256.chain16"
SEED = 2 ** 31 + 3131
EXACT = ("stage_ms.rsd_exact.chain", "rsd_exact_roofline.chain")
CHAIN = ("call_ms_p50.chain", "stage_ms.draw.chain",
         "stage_ms.foregrounds.chain", "stage_ms.rsd.chain",
         "stage_ms.pca.chain", "pk_roofline.chain", "device_idle_pct.chain",
         "host_syncs.chain", "rsd_exact_share.chain", "host_ms.draw.chain",
         "host_ms.foregrounds.chain")


def _read(name, run):
    return harness.load_module("metrics", name).read(run)


def _run(stage_ms, per_call=16, clocked=32, dtype="float32"):
    return types.SimpleNamespace(
        realisations_per_call=per_call, clocked_realisations=clocked,
        entry="chained_pipeline", stage_ms=stage_ms,
        config={"nsamp": 256, "pipeline": {"dtype": dtype}})


@pytest.fixture
def totals(monkeypatch):
    """Synthetic process totals: two 256^3 calls of 16 realisations, 12
    of the 32 remaps on the exact tier, the rest on band 4."""
    from fastbox_tpu_torch import timing

    t = {"calls": 2, "host_ms": {},
         "counts": {"sync.rsd_band": 32, "sync.eigh": 32, "rsd.band4": 20,
                    "rsd.exact": 12, "rsdwork.cells": 32 * 256 ** 3,
                    "rsdwork.exact_cells": 12 * 256 ** 3,
                    "rsdwork.disp_mcells": 32 * 3950,
                    "rsdwork.disp_reads": 32}}
    monkeypatch.setattr(timing, "trace_totals", lambda: t)
    return t


def test_exact_floor_at_256():
    # a 256^3 remap's floor: 12 bytes a cell in float32, 0.060 ms
    work = harness.load_module("metrics", "rsd_roofline").work
    b, by = peaks.bound_ms(*work(256 ** 3))
    assert by == "bytes" and b == pytest.approx(0.0600975, rel=1e-5)


def test_readers_on_synthetic_totals(totals):
    # 12 exact remaps of 32 realisations, 0.6 ms each: 0.225 ms a
    # realisation over the run
    run = _run({"rsd": 32 * 0.5, "rsd_exact": 12 * 0.6})
    assert _read("stage_ms.rsd_exact.chain", run) == pytest.approx(0.225)
    b = 12 * 256 ** 3 / peaks.PEAK_BYTES_S * 1e3
    # the per-realisation counts cancel: one exact remap's floor over its
    # own time
    assert _read("rsd_exact_roofline.chain", run) == \
        pytest.approx(100.0 * b / 0.6)
    assert _read("rsd_exact_share.chain", run) == pytest.approx(37.5)
    # float64 cells move twice the bytes
    assert _read("rsd_exact_roofline.chain", _run(
        {"rsd_exact": 12 * 0.6}, dtype="float64")) == \
        pytest.approx(200.0 * b / 0.6)
    # a wrong base: the totals hold two calls, the run clocked three
    assert _read("rsd_exact_roofline.chain",
                 _run({"rsd_exact": 7.2}, clocked=48)) is None


def test_none_without_the_counter_or_the_stage(totals):
    # the stage without the counter (a program that marks but does not
    # count), the counter without the stage (one that counts but does not
    # mark: the parent's counters lack both)
    del totals["counts"]["rsdwork.exact_cells"]
    assert _read("rsd_exact_roofline.chain", _run({"rsd_exact": 7.2})) \
        is None
    totals["counts"]["rsdwork.exact_cells"] = 12 * 256 ** 3
    for name in EXACT:
        assert _read(name, _run({"rsd": 16.0})) is None, name
    # a run whose remaps all took band 4
    totals["counts"] = {"rsd.band4": 32, "rsdwork.cells": 32 * 256 ** 3}
    for name in EXACT:
        assert _read(name, _run({"rsd": 16.0})) is None, name


def test_none_on_an_older_program(monkeypatch):
    from fastbox_tpu_torch import timing

    monkeypatch.delattr(timing, "trace_totals")
    assert _read("rsd_exact_roofline.chain", _run({"rsd_exact": 7.2})) \
        is None


def test_cell_found_and_within_the_rules():
    m = harness.load_manifest()
    w, config, traffic = harness.cell_files(m, CELL)
    assert w["chips"] == 1 and config["name"] == w["config"]
    # the 4 Gpc chain's traffic, its own limits
    _, c4, t4 = harness.cell_files(m, "mock256.chain16")
    assert {k: v for k, v in traffic.items() if k != "limits"} == \
        {k: v for k, v in t4.items() if k != "limits"}
    assert traffic["entry"] == "chained_pipeline"
    assert traffic["realisations_per_call"] == 16
    assert set(traffic["limits"]) == set(t4["limits"])
    # the 4 Gpc configuration in the 1 Gpc box, nothing cut
    assert {k for k in c4 if c4[k] != config.get(k)} == \
        {"name", "source", "deployment", "box_mpc", "reduced", "assumed"}
    assert config["box_mpc"] == 1000.0 and config["nsamp"] == 256
    assert config["reduced"] == [] and "nsamp" in config["assumed"]
    entry_cfg = harness._named(m["configs"], config["name"])
    assert entry_cfg["reduced"] == [] and \
        entry_cfg["source"] == config["source"]
    assert len(config["source"]) <= 200
    e2e = harness.cell_metrics(m, CELL, "end_to_end")
    assert set(e2e) == {"realisations_per_s.chain", "call_ms_p95.chain",
                        "peak_device_gib", "setup_s"}
    layer = harness.cell_metrics(m, CELL, "per_layer")
    assert set(layer) == set(CHAIN + EXACT)
    for name in EXACT:
        x = harness._named(m["per_layer"], name)
        assert x["layer"] == "RSD remap"
        assert x["moves"] == "realisations_per_s.chain"
        assert x["workloads"] == [CELL]
    # one chip; no four-chip cell
    assert all(w["chips"] == 1 for w in m["workloads"])


@pytest.fixture(scope="module")
def traced():
    """A traced run of the cell at 16^3 in a 16 Mpc box (1 Mpc cells:
    every key's largest displacement 5-7 cells, past band 4)."""
    from fastbox_tpu_torch import timing

    config, traffic = small(CELL)
    config = dict(config, box_mpc=16.0)
    timing.reset_trace_totals()
    try:
        result, lines = harness.execute(CELL, SEED, 0.3, True, "cpu",
                                        time.perf_counter(), config, traffic)
        counts = timing.trace_totals()["counts"]
    finally:
        timing.reset_trace_totals()
    return result, counts


def test_traced_run_past_band_4_reports_the_exact_tier(traced):
    result, counts = traced
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(EXACT) <= set(got), set(EXACT) - set(got)
    assert got["rsd_exact_share.chain"] == 100.0
    assert got["stage_ms.rsd_exact.chain"] > 0
    assert 0 < got["rsd_exact_roofline.chain"] < 100
    assert counts["rsdwork.exact_cells"] == counts["rsdwork.cells"] \
        == 16 ** 3 * counts["rsd.exact"]
    # one band pick and one eigh a realisation, as on band 4
    assert got["host_syncs.chain"] == 2.0
    assert result["correct"], result["checks"]


def test_control_fails_a_limit_at_16():
    config, traffic = small(CELL)
    summary = readings(CELL, [], [2 ** 31 + 77], "cpu", config, traffic,
                       emit=lambda line: None)
    over = {k: v for k, v in summary["control_min"].items()
            if v > traffic["limits"][k]}
    assert over, summary
