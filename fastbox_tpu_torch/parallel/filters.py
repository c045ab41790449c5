"""Distributed foreground filters for slab-sharded datacubes.

Counterpart of ``fastbox_tpu/parallel/filters.py``: the PCA clean of the
sharded step as a standalone call.  A (N, N, Nfreq) cube held as row slabs
over the mesh's 'space' group is cleaned without gathering: the mean
spectrum and the Nfreq x Nfreq covariance are all-reduced over 'space',
every rank decomposes the small covariance, and the projection stays
local.  The frequency (LOS) axis is never sharded.

Departure from fastbox_tpu, on purpose and as in ``filters/pca.py`` and the
sharded step (ROADMAP C2, C3): a float32 cube is cleaned in float64
(``pca._work``: the mean, centring, covariance, eigh and projections), and
only the cleaned cube and the fit are rounded to float32.  fastbox_tpu's
sharded filter runs its GEMMs in the cube's dtype.
"""
from __future__ import annotations

import torch

from ..filters.pca import _work, top_eigvecs
from ..grid import GridSpec
from .spectra import _all_reduce, _slab_geometry

__all__ = ["make_sharded_pca_filter"]


def make_sharded_pca_filter(mesh, grid: GridSpec, nmodes: int = 4,
                            return_filtered: bool = True):
    """Build ``fn(data) -> (cleaned, fg_fit)`` (or ``cleaned`` alone with
    ``return_filtered=False``) for this rank's (N/P, N, Nfreq) slab.

    Equals ``filters.pca.pca_filter(data, nmodes)`` on the gathered cube to
    rounding: subtract the mean spectrum, eigendecompose the frequency
    covariance, remove the top-``nmodes`` subspace.
    """
    group, _, Np, _ = _slab_geometry(mesh, grid)
    N = grid.N
    npix = N * N

    def fn(data):
        if tuple(data.shape[:2]) != (Np, N):
            raise ValueError(f"expected this rank's slab ({Np}, {N}, Nfreq),"
                             f" got {tuple(data.shape)}")
        nf = data.shape[-1]
        d2 = _work(data).reshape(Np * N, nf)
        mean_spec = _all_reduce(torch.sum(d2, dim=0), group) / npix
        x = d2 - mean_spec[None, :]
        cov = _all_reduce(torch.matmul(x.T, x), group) / (npix - 1)
        U = top_eigvecs(cov, nmodes)
        fg = torch.matmul(torch.matmul(x, U), U.T) + mean_spec[None, :]
        cleaned = (d2 - fg).reshape(data.shape).to(data.dtype)
        if return_filtered:
            return cleaned, fg.reshape(data.shape).to(data.dtype)
        return cleaned

    return fn
