"""Readers of the program's own trace.

``fastbox_tpu_torch.timing.StageClock`` keeps, for each call, the host's
time at every stage mark and the call's counters (``sync.<site>``,
``rsd.*``, ``cola.*``, ``collective.*``).  Every clock whose ``ms()`` is
read adds them to process totals (``timing.trace_totals``); the harness
reads the ``ms()`` of every clocked call of the window and of no warm-up
call, so the totals cover the calls that ``run.stage_ms`` sums.  Each
reader gives None where the program keeps no totals, or where they cover
other calls than the run clocked: a wrong base is never reported.
"""
from __future__ import annotations


def totals(run) -> dict | None:
    """The totals of the run's clocked calls, or None (see above)."""
    try:
        from fastbox_tpu_torch import timing
    except ImportError:
        return None
    read = getattr(timing, "trace_totals", None)
    if read is None or not run.clocked_realisations:
        return None
    t = read()
    if t["calls"] * run.realisations_per_call != run.clocked_realisations:
        return None
    return t


def _family(t: dict, prefix: str) -> dict[str, int]:
    return {k[len(prefix):]: v for k, v in t["counts"].items()
            if k.startswith(prefix)}


def per_realisation(run, prefix: str, scale: float = 1.0):
    """The counters named ``<prefix>...`` summed, a realisation, times
    ``scale``."""
    t = totals(run)
    if t is None:
        return None
    return scale * sum(_family(t, prefix).values()) / run.clocked_realisations


def share_pct(run, prefix: str, part: str):
    """``<prefix><part>``'s share of the ``<prefix>...`` counters, in %;
    None where there are none."""
    t = totals(run)
    fam = {} if t is None else _family(t, prefix)
    if not sum(fam.values()):
        return None
    return 100.0 * fam.get(part, 0) / sum(fam.values())


def mean_band(run, prefix: str):
    """The mean of ``b`` over the ``<prefix>band<b>`` counters (the
    banded paths taken); None where none was taken."""
    t = totals(run)
    bands = {} if t is None else {int(k[4:]): v for k, v in
                                  _family(t, prefix).items()
                                  if k.startswith("band")}
    if not sum(bands.values()):
        return None
    return sum(b * n for b, n in bands.items()) / sum(bands.values())


def host_ms(run, stage: str):
    """Host milliseconds of ``stage`` a realisation: from the mark before
    it to its own, on the host's clock."""
    t = totals(run)
    if t is None or stage not in t["host_ms"]:
        return None
    return t["host_ms"][stage] / run.clocked_realisations
