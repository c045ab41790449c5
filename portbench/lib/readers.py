"""Readers that several metric files share, and the work counts of the
two rooflines (from shapes; each input the stage needs read once, each
output written once; f32, N^3 cube, H = N/2 + 1)."""
from __future__ import annotations

import math

from .peaks import bound_ms, share_pct
from .stats import percentile

# The P(k) stage of one realisation, bytes in:
# * the single pipeline: the cleaned cube (4 N^3) and the density's power
#   on the half grid (4 N^2 H);
# * the sharded step: the cleaned cube (4 N^3), the density's complex half
#   spectrum (8 N^2 H) and the data cube whose sigma the stage sums (4 N^3).
_PK_BYTES = {
    "chained_pipeline": lambda N, H: 4 * N ** 3 + 4 * N * N * H,
    "sharded_step": lambda N, H: 8 * N ** 3 + 8 * N * N * H,
}


def stage_ms(run, stage: str):
    """Milliseconds of ``stage`` per realisation over the clocked calls
    (``timing.StageClock``: CUDA events at the stage's end marks on the
    stream), or None where no call marked it."""
    total = run.stage_ms.get(stage)
    if total is None or not run.clocked_realisations:
        return None
    return total / run.clocked_realisations


def pk_work(entry: str, N: int):
    """(bytes, operations) of one realisation's P(k) stage, or None for an
    entry without one.  Operations: the forward rFFT, 2.5 N^3 log2(N^3),
    plus the squared moduli and the binned sums, ~10 a half-grid mode."""
    if entry not in _PK_BYTES:
        return None
    H = N // 2 + 1
    flops = 2.5 * N ** 3 * math.log2(N ** 3) + 10.0 * N * N * H
    return _PK_BYTES[entry](N, H), flops


def pk_roofline(run):
    """The P(k) stage's share of its roofline in %: the bound of its work
    over the 'pk' stage's ms."""
    w = pk_work(run.entry, int(run.config["nsamp"]))
    if w is None:
        return None
    return share_pct(bound_ms(*w)[0], stage_ms(run, "pk"))


def paint_work(N: int):
    """(bytes, operations) of one COLA paint: the three wrapped
    displacement fields in (12 N^3 bytes), the mesh out (4 N^3); ~30
    operations a particle (the weights, eight corner products)."""
    return 16 * N ** 3, 30.0 * N ** 3


def paint_roofline(run):
    """The COLA paints' share of their roofline in %: ``n_steps`` paints
    (one a force evaluation) over the 'paint' stage's ms."""
    if run.entry != "cola_single":
        return None
    paints = int(run.config["cola"]["n_steps"])
    bound = paints * bound_ms(*paint_work(int(run.config["nsamp"])))[0]
    return share_pct(bound, stage_ms(run, "paint"))


def device_idle_pct(run):
    """The share of the profiled calls' span in which no kernel, copy or
    set ran on the card, in %."""
    p = run.profile
    if not p or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])


def realisations_per_s(run):
    """Realisations completed in the window over the window's length
    (first call's start to last call's end)."""
    return run.calls * run.realisations_per_call / run.window_s


def call_ms(run, p: float):
    """The nearest-rank ``p``-th percentile of the calls' wall times, ms."""
    return 1e3 * percentile(run.call_s, p)
