"""Slab-sharded Poisson halo counts.

Counterpart of ``fastbox_tpu/parallel/halos.py``.  The reference's halo
workload (examples/example_halos.py: lognormal field -> Poisson halo
counts -> cross-spectra) as ranks that each hold row slabs of the field:
counts are drawn per voxel with the row-keyed scheme (``rng.row_poisson``:
one R2 launch on the card, ``jax.random.poisson``'s stream for
``PRNGKey(seed)``), so a realisation is a function of its seed alone and
every mesh shape draws the same count field.  Pairs with ``parallel.spectra`` for the
cross-spectra.  Rate conventions of the reference (halos.py:53-117): the
clip at zero only in the non-lognormal branch, nan_to_num on the rate.
"""
from __future__ import annotations

import torch

from ..grid import GridSpec
from .rng import TAGS, row_poisson
from .spectra import _all_reduce, _slab_geometry

__all__ = ["make_sharded_halo_counts", "row_poisson"]


def make_sharded_halo_counts(mesh, grid: GridSpec, nbar: float, bias: float,
                             lognormal: bool = False,
                             return_overdensity: bool = False,
                             dtype=torch.float32):
    """Build ``fn(seed, delta_x) -> counts`` for this rank's (N/P, N, N)
    slab of the density; the result is the same slab of the count field in
    ``dtype`` (on ``delta_x``'s device).  With ``return_overdensity`` it is
    the halo overdensity ``n/<n> - 1`` (the global mean all-reduced), and
    the zero field for an empty draw."""
    group, row0, Np, _ = _slab_geometry(mesh, grid)
    N = grid.N
    rate0 = grid.voxel_volume * nbar

    def global_mean(t):
        return _all_reduce(torch.sum(t, dtype=torch.float64), group) / N**3

    def fn(seed: int, delta_x):
        if tuple(delta_x.shape) != (Np, N, N):
            raise ValueError(f"expected this rank's slab {(Np, N, N)}, got "
                             f"{tuple(delta_x.shape)}")
        delta_h = bias * delta_x.to(dtype)
        if lognormal:
            d = torch.exp(delta_h)
            delta_h = d / global_mean(d) - 1.0
        rate = rate0 * (1.0 + delta_h)
        if not lognormal:
            rate = torch.clamp(rate, min=0.0)
        counts = row_poisson(seed, TAGS["halos"], row0, torch.nan_to_num(rate))
        if not return_overdensity:
            return counts
        mean_n = global_mean(counts)
        # an empty draw has no defined overdensity: the zero field, not NaN
        return torch.where(mean_n > 0, counts / torch.clamp(mean_n, min=1e-30)
                           - 1.0, 0.0)

    return fn
