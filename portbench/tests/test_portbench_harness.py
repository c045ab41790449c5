"""The harness finds its parts by name, its arithmetic, and its refusal
to run without a card."""
from __future__ import annotations

import os
import subprocess
import sys
import types

import pytest

from portbench.lib import harness, keys, peaks, readers, stats
from portbench.lib.profile import read_trace

from .conftest import CELLS, ROOT


@pytest.fixture(scope="module")
def m():
    return harness.load_manifest()


@pytest.mark.parametrize("cell", CELLS)
def test_cells_found_by_name(m, cell):
    w, config, traffic = harness.cell_files(m, cell)
    assert w["name"] == cell and config["name"] == w["config"]
    entry = harness.load_module("entries", traffic["entry"])
    for fn in ("build", "gaps", "reference"):
        assert callable(getattr(entry, fn))
    assert set(traffic["limits"]) and traffic["realisations_per_call"] >= 1


def test_metrics_found_by_name(m):
    for section in ("end_to_end", "per_layer"):
        for x in m[section]:
            assert callable(harness.load_module("metrics", x["name"]).read)


def test_run_py_names_no_cell_config_or_metric(m):
    text = (harness.BENCH / "run.py").read_text() \
        + (harness.BENCH / "lib" / "harness.py").read_text()
    names = [w["name"] for w in m["workloads"]] \
        + [c["name"] for c in m["configs"]] \
        + [x["name"] for s in ("end_to_end", "per_layer") for x in m[s]]
    # no name as a string literal: the harness reads them from the manifest
    assert not [n for n in names if f'"{n}"' in text or f"'{n}'" in text]


def _run(call_s, realisations=1, window_s=None, **kw):
    return types.SimpleNamespace(call_s=call_s, calls=len(call_s),
                       realisations_per_call=realisations,
                       window_s=window_s or sum(call_s), **kw)


def test_percentile_and_rate_with_a_stall():
    # 40 calls of 10 ms and one stall of 300 ms: the stall is 1 call in 41,
    # beyond the 95th percentile, and counts in the rate
    calls = [0.010] * 40 + [0.300]
    run = _run(calls, realisations=8)
    p95 = harness.load_module("metrics", "call_ms_p95").read(run)
    rate = harness.load_module("metrics", "realisations_per_s").read(run)
    assert p95 == pytest.approx(10.0)
    assert rate == pytest.approx(41 * 8 / 0.7)
    # three stalls in 41 calls reach the 95th percentile
    run = _run([0.010] * 38 + [0.300] * 3)
    assert harness.load_module("metrics", "call_ms_p95").read(run) \
        == pytest.approx(300.0)
    assert stats.percentile(range(1, 101), 50) == 50
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx(
        (4.5 - 1.5) / 3.0)


def test_roofline_counts_at_256():
    N, H = 256, 129
    assert readers.pk_work("chained_pipeline", N)[0] \
        == 4 * N ** 3 + 4 * N * N * H == 100_925_440
    assert readers.pk_work("sharded_step", N)[0] == 201_850_880
    assert readers.pk_work("cola_single", N) is None
    assert readers.paint_work(N)[0] == 268_435_456
    b, by = peaks.bound_ms(*readers.pk_work("chained_pipeline", N))
    assert by == "bytes" and b == pytest.approx(0.030127, rel=1e-4)
    b, by = peaks.bound_ms(*readers.pk_work("sharded_step", N))
    assert by == "bytes" and b == pytest.approx(0.060254, rel=1e-4)
    b, by = peaks.bound_ms(*readers.paint_work(N))
    assert by == "bytes" and b == pytest.approx(0.080130, rel=1e-4)
    assert peaks.share_pct(0.03, 0.3) == pytest.approx(10.0)
    assert peaks.share_pct(0.03, 0.0) is None


def test_stage_readers_per_realisation():
    run = _run([0.1], realisations=8, entry="sharded_step",
               config={"nsamp": 256}, stage_ms={"pca": 80.0, "pk": 8.0},
               clocked_realisations=16)
    assert harness.load_module("metrics", "stage_ms.pca").read(run) == 5.0
    assert harness.load_module("metrics", "stage_ms.draw").read(run) is None
    share = harness.load_module("metrics", "pk_roofline").read(run)
    assert share == pytest.approx(100 * 0.060254 / 0.5, rel=1e-4)
    run.entry, run.config = "cola_single", {"nsamp": 256,
                                            "cola": {"n_steps": 16}}
    run.stage_ms = {"paint": 32.0}
    assert harness.load_module("metrics", "paint_roofline").read(run) \
        == pytest.approx(100 * 16 * 0.080130 / 2.0, rel=1e-4)


def test_trace_reading():
    ev = [{"name": "portbench.call", "ts": 0, "dur": 100},
          {"name": "k1", "ts": 10, "dur": 20, "cat": "kernel"},
          {"name": "k2", "ts": 25, "dur": 20, "cat": "kernel"},
          {"name": "aten::item", "ts": 40, "dur": 30, "cat": "cpu_op"},
          {"name": "k1", "ts": 80, "dur": 10, "cat": "kernel"},
          {"name": "k9", "ts": 500, "dur": 10, "cat": "kernel"}]
    t = read_trace(ev)
    assert t["window_s"] == pytest.approx(100e-6)
    assert t["busy_s"] == pytest.approx(45e-6)
    assert t["device_ops"][0] == ("k1", pytest.approx(30e-6))
    assert dict(t["idle_gaps"]) == {"aten::item": pytest.approx(35e-6),
                                    "host": pytest.approx(20e-6)}
    run = types.SimpleNamespace(profile=t)
    assert harness.load_module("metrics", "device_idle_pct").read(run) \
        == pytest.approx(55.0)
    assert read_trace(ev[1:]) is None


def test_seeds_differ_across_calls_and_runs():
    a = [s for i in range(-2, 50) for s in keys.realisation_seeds(7, i, 8)]
    b = [s for i in range(-2, 50)
         for s in keys.realisation_seeds(2 ** 31 + 9, i, 8)]
    assert len(set(a)) == len(a) and not set(a) & set(b)
    assert keys.realisation_seeds(7, 3, 8) == keys.realisation_seeds(7, 3, 8)
    assert max(b) < 2 ** 63


def test_run_py_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
