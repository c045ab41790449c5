"""The numbers that decide ``correct``: gaps between what the program
produced and what the reference works out, each held to a limit.

Mock survey (per sampled realisation, bins 1..nbins-1): the widest
relative gap ``|program - reference| / |reference|`` of ``pk_density``,
``pk_cleaned``, ``pk_cleaned_err`` and ``sigma_data``.  COLA: the relative
L2 gap of the density, ``|d_p - d_r| / |d_r|``, and of the velocities
weighted by the reference's CIC mass per cell (empty and nearly empty
cells carry no velocity to speak of).  A value the program leaves NaN or
infinite where the reference is finite, or the other way round, reads as
an infinite gap; so does a nonzero value where the reference's is zero.
"""
from __future__ import annotations

import math

import numpy as np

MOCK_OUTPUTS = ("pk_density", "pk_cleaned", "pk_cleaned_err", "sigma_data")


def _rel_gap(p: np.ndarray, r: np.ndarray) -> float:
    p = np.asarray(p, np.float64)
    r = np.asarray(r, np.float64)
    fp, fr = np.isfinite(p), np.isfinite(r)
    if not np.array_equal(fp, fr):
        return math.inf
    p, r = p[fr], r[fr]
    diff, scale = np.abs(p - r), np.abs(r)
    if np.any((scale == 0) & (diff > 0)):
        return math.inf
    zero = scale == 0
    rel = diff[~zero] / scale[~zero]
    return float(rel.max()) if rel.size else 0.0


def mock_gaps(prog: dict, ref: dict) -> dict:
    """{'<output>_gap': widest relative gap} of one realisation."""
    return {f"{k}_gap": _rel_gap(prog[k], ref[k]) for k in MOCK_OUTPUTS}


def cola_gaps(delta, vel, ref: dict) -> dict:
    """{'delta_gap', 'vel_gap'} of one realisation; ``delta``, ``vel`` and
    ``ref``'s fields are torch tensors on one device."""
    d, v = delta.double(), vel.double()
    if not (bool(d.isfinite().all()) and bool(v.isfinite().all())):
        return {"delta_gap": math.inf, "vel_gap": math.inf}
    rd, rv, w = ref["delta"], ref["vel"], ref["rho"]
    num = float(((d - rd) ** 2).sum())
    den = float((rd ** 2).sum())
    wnum = float((w * ((v - rv) ** 2).sum(0)).sum())
    wden = float((w * (rv ** 2).sum(0)).sum())
    return {"delta_gap": math.sqrt(num / den),
            "vel_gap": math.sqrt(wnum / wden)}


def worst(gap_dicts) -> dict:
    """The largest of each gap over realisations (NaN reads as inf)."""
    out: dict[str, float] = {}
    for g in gap_dicts:
        for k, v in g.items():
            v = math.inf if math.isnan(v) else v
            out[k] = max(out.get(k, 0.0), v)
    return out
