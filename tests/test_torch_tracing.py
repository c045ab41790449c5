"""The program's own trace (``fastbox_tpu_torch.timing``): host times at
the stage marks, the per-call counters, the active clock, the null clock's
profiler marks and the process totals, on the CPU at 16^3."""
from __future__ import annotations

import json
import os
import tempfile

import pytest
import torch

from fastbox_tpu_torch import timing
from fastbox_tpu_torch.cosmology import build_cosmology
from fastbox_tpu_torch.fields.cola import realise_density_cola
from fastbox_tpu_torch.grid import GridSpec
from fastbox_tpu_torch.pipeline import PipelineConfig, make_pipeline

COSMO = dict(Omega_c=0.25, Omega_b=0.05, h=0.7, n_s=0.95, sigma8=0.8)
STAGES = ["draw", "velocity_irfft", "lognormal", "rsd", "foregrounds",
          "noise", "pca", "pk"]
N_STEPS = 4


class _Recording(timing.StageClock):
    """A clock that also keeps its marks and its counters' names in call
    order."""

    def __init__(self, device):
        super().__init__(device)
        self.marks, self.order = [], []

    def mark(self, stage):
        self.marks.append(stage)
        super().mark(stage)

    def count(self, name, n=1):
        self.order.append(name)
        super().count(name, n)


@pytest.fixture(scope="module")
def grid():
    return GridSpec.create(box_scale=250.0, nsamp=16, redshift=0.8)


@pytest.fixture(scope="module")
def pipe(grid):
    cosmo = build_cosmology(COSMO, redshift=0.8, device="cpu")
    return make_pipeline(grid, cosmo, PipelineConfig(), device="cpu")


@pytest.fixture
def fresh():
    timing.reset_trace_totals()
    yield
    timing.reset_trace_totals()


def _cola(grid, clock, **kw):
    cosmo = build_cosmology(COSMO, redshift=0.0, device="cpu")
    return realise_density_cola(
        7, grid, cosmo, redshift=0.0, n_steps=N_STEPS, lattice_B=2,
        lattice_impl="plain", clock=clock, device="cpu", **kw)


def test_host_ms_has_the_stages_of_ms(pipe, fresh):
    clock = timing.StageClock("cpu")
    pipe(3, clock=clock)
    ms, host = clock.ms(), clock.host_ms()
    assert list(ms) == list(host) == STAGES
    assert all(v >= 0.0 for v in host.values())
    # on the CPU the device's clock is the host's
    assert ms == host


def test_pipeline_counts_its_tier_and_syncs(pipe, fresh):
    clock = timing.StageClock("cpu")
    pipe(3, clock=clock)
    counts = clock.counts()
    tiers = {k: v for k, v in counts.items() if k.startswith("rsd.")}
    assert sum(tiers.values()) == 1
    assert counts["sync.rsd_band"] == 1 and counts["sync.eigh"] == 1
    assert sum(v for k, v in counts.items() if k.startswith("sync.")) == 2
    # nothing reaches the totals until ms() is read, then once
    assert timing.trace_totals()["calls"] == 0
    clock.ms()
    clock.ms()
    t = timing.trace_totals()
    assert t["calls"] == 1 and t["counts"] == counts
    assert list(t["host_ms"]) == STAGES
    # a call with no clock changes no totals, nor counts into a clock
    pipe(4)
    assert timing.trace_totals() == t
    assert clock.counts() == counts


def test_count_needs_an_active_clock(fresh):
    timing.count("x")
    clock = timing.StageClock("cpu")
    with timing.active(clock) as c:
        assert c is clock
        timing.count("x", 3)
        with timing.active(None) as null:
            assert null is timing.NULL_CLOCK
            timing.count("x")
        # a copy to the card waits for its stream; on the CPU none is made
        timing.count_copy("h2d", "cpu")
        timing.count_copy("h2d", torch.device("cuda", 0), 3)
    timing.count("x")
    timing.count_copy("h2d", "cuda")
    assert clock.counts() == {"x": 4, "sync.h2d": 3}


def test_cola_counts_a_band_a_paint(grid, fresh):
    clock = _Recording("cpu")
    _, _, diag = _cola(grid, clock, diagnostics=True)
    stages = list(clock.ms())
    assert stages[:3] == ["white", "schedule", "ic"] and stages[-1] == \
        "finish"
    paints = [k for k in clock.order if k.startswith("cola.")]
    assert len(paints) == N_STEPS + 1
    counts = clock.counts()
    assert sum(v for k, v in counts.items() if k.startswith("cola.")) \
        == N_STEPS + 1
    assert counts["sync.cola_band"] == N_STEPS + 1
    bands = (1, 2)
    used = [f"cola.band{bands[i]}" if i < len(bands) else "cola.exact"
            for i in diag["used_lattice"].tolist()]
    assert paints[:N_STEPS] == used
    fin = float(diag["final_maxdisp"])
    want = next((f"cola.band{b}" for b in bands if fin < b), "cola.exact")
    assert paints[-1] == want


def _profiled_marks(call) -> list[str]:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return [name[6:] for _, name in sorted(
        (e["ts"], e["name"]) for e in events
        if str(e.get("name", "")).startswith("stage:"))]


@pytest.mark.parametrize("clocked", [True, False])
def test_profiler_marks_in_stage_order(pipe, grid, fresh, clocked):
    clock = timing.StageClock("cpu") if clocked else None
    assert _profiled_marks(lambda: pipe(5, clock=clock)) == STAGES
    clock = _Recording("cpu") if clocked else None
    marks = _profiled_marks(lambda: _cola(grid, clock))
    assert marks[:3] == ["white", "schedule", "ic"]
    assert marks[-1] == "finish" and marks.count("paint") == N_STEPS
    if clocked:
        assert marks == clock.marks
    # no clock's ms() was read
    assert timing.trace_totals()["calls"] == 0


def test_totals_fold_only_clocks_read(pipe, fresh):
    read, unread = timing.StageClock("cpu"), timing.StageClock("cpu")
    pipe(1, clock=read)
    pipe(2, clock=unread)
    read.ms()
    t = timing.trace_totals()
    assert t["calls"] == 1 and t["counts"] == read.counts()
    assert t["host_ms"] == pytest.approx(read.host_ms())
    timing.reset_trace_totals()
    assert timing.trace_totals() == {"calls": 0, "host_ms": {},
                                     "counts": {}}
