"""Least-squares component fitting (counterpart of fastbox_tpu/filters/lsq.py).

Reference: ``fastbox.filters.LSQfitting`` (filters.py:598-747): per-pixel
synchrotron power-law fits with lmfit, fanned out over
``multiprocessing.Process`` workers.  Here the per-pixel fit is a bounded
Gauss-Newton iteration of 30 steps run on every pixel at once (fastbox_tpu
vmaps a per-pixel ``fori_loop``): each step is a handful of elementwise
passes and row sums over the (Npix, Nfreq) data on its device.

Model per pixel (filters.py:612-623): T(nu) = A (nu/nu0)^beta, weighted by
1/noise^2; after the spectral-index fit, the synchrotron and free-free
amplitudes are re-solved jointly by the 2 x 2 normal equations
(filters.py:650-657), whose inverse is NaN for a singular system, as
``jnp.linalg.inv`` gives non-finite values where ``torch.linalg.inv`` would
raise.  Float32 data are fitted in float64, as ``pca_filter`` cleans.
"""
from __future__ import annotations

import numpy as np
import torch

from .pca import _work

__all__ = ["lsq_synchrotron_fit", "LSQfitting"]


def _inv(A):
    """A^-1 of a batch of matrices, NaN where one is singular."""
    Ainv, info = torch.linalg.inv_ex(A)
    return torch.where((info == 0)[..., None, None], Ainv, torch.nan)


def _fit_one(tval, noval, bgu, freqs, freeind, n_iter: int = 30):
    """Bounded Gauss-Newton fit of (beta, amp) for every pixel at once.

    ``tval``/``noval`` (Npix, Nfreq), ``bgu`` (Npix,) the starting beta.
    Bounds follow the reference's lmfit setup (filters.py:640-641): beta in
    [bgu*1.1, bgu*0.9] (bgu is negative), amp in [0.5, 1.5] x tval[:, 0].
    Returns (beta, sync amplitude, free-free amplitude, model (Npix,
    Nfreq)).
    """
    x = freqs / freqs[0]
    logx = torch.log(x)
    w = 1.0 / noval**2

    beta_lo, beta_hi = bgu * 1.1, bgu * 0.9  # bgu < 0 so lo < hi
    amp_lo, amp_hi = tval[:, 0] * 0.5, tval[:, 0] * 1.5

    beta, amp = bgu, tval[:, 0] * 0.9
    for _ in range(n_iter):
        xb = x[None, :] ** beta[:, None]
        model = amp[:, None] * xb
        r = w * (model - tval)
        # Jacobian of the weighted residual
        d_beta = w * model * logx
        d_amp = w * xb
        JtJ00 = torch.sum(d_beta * d_beta, dim=1)
        JtJ01 = torch.sum(d_beta * d_amp, dim=1)
        JtJ11 = torch.sum(d_amp * d_amp, dim=1)
        g0 = torch.sum(d_beta * r, dim=1)
        g1 = torch.sum(d_amp * r, dim=1)
        det = JtJ00 * JtJ11 - JtJ01**2
        det = torch.where(torch.abs(det) > 1e-30, det, 1e-30)
        db = -(JtJ11 * g0 - JtJ01 * g1) / det
        da = -(-JtJ01 * g0 + JtJ00 * g1) / det
        beta = torch.clamp(beta + db, beta_lo, beta_hi)
        amp = torch.clamp(amp + da, amp_lo, amp_hi)

    # Joint amplitude solve with fixed spectral shapes (filters.py:650-657)
    specs = torch.stack([x[None, :] ** beta[:, None],
                         (x**freeind).expand(beta.shape[0], -1)],
                        dim=2)                            # (Npix, Nfreq, 2)
    num = torch.einsum("pfi,pf->pi", specs, tval)
    denom = _inv(specs.transpose(1, 2) @ specs)
    amps = torch.einsum("pi,pij->pj", num, denom)
    mod = torch.einsum("pi,pfi->pf", amps, specs)
    return beta, amps[:, 0], amps[:, 1], mod


def lsq_synchrotron_fit(data, noise, freqs, freeind):
    """Fit all pixels at once.

    Parameters:
        data: (Npix, Nfreq) observed spectra (mean point-source temp already
            subtracted, as in filters.py:691).
        noise: (Npix, Nfreq) per-pixel noise realisation/level.
        freqs: (Nfreq,) frequencies.
        freeind: free-free spectral index (scalar).

    Returns:
        dict with 'beta', 'sync_amp', 'ff_amp' (Npix,) and 'model'
        (Npix, Nfreq), in ``data``'s dtype; the residual is
        ``data - model``.
    """
    t = _work(data)
    noise = torch.as_tensor(noise, dtype=t.dtype, device=t.device)
    freqs = torch.as_tensor(np.array(freqs), dtype=t.dtype, device=t.device)
    # Initial beta guess from channel ratios (filters.py:699)
    bidea = torch.log(t[:, 3] / t[:, 0]) / torch.log(freqs[3] / freqs[0])
    beta, syamp, ffamp, mod = _fit_one(t, noise, bidea, freqs, freeind)
    return {k: v.to(data.dtype) for k, v in (("beta", beta),
                                             ("sync_amp", syamp),
                                             ("ff_amp", ffamp),
                                             ("model", mod))}


class LSQfitting:
    """Reference-API shim (filters.py:598-747) over a ``CosmoBox``."""

    def __init__(self, box):
        self.box = box

    def run_fit(self, maps, freqs, numpix, tpsmean, freeind, noise=None):
        """Fit the data cube; returns (residual, beta map) like the
        reference's ``run_fit`` (filters.py:667-723)."""
        maps = torch.as_tensor(maps)
        nf = np.size(freqs)
        data = maps.reshape(numpix, nf) - torch.as_tensor(
            np.asarray(tpsmean), device=maps.device).reshape(nf, 1).T
        if noise is None:
            noise = torch.ones_like(data)
        out = lsq_synchrotron_fit(data, noise, freqs, freeind)
        return data - out["model"], out["beta"]

    def give_hest(self, T_obs, freeind, psaveind, flux_cutoff, indspread,
                  redshift=None):
        """Fit the point-source model to a data cube (filters.py:726-747).

        Builds the mean point-source temperature from ``PointSourceModel``
        (which draws its maps from the box's generator), runs the per-pixel
        fit, and returns the residual cube and spectral-index map.
        """
        from ..models.foregrounds import PointSourceModel

        box = self.box
        cosmology = box.cosmology_at(redshift)
        freqs = box.grid.freq_array(cosmology)
        ang_x, ang_y = box.grid.pixel_array(cosmology)
        xside, yside = ang_x.size, ang_y.size

        _, tpsmean = PointSourceModel(box).construct_cube(
            flux_cutoff=flux_cutoff, beta=psaveind, delta_beta=indspread)

        res, spec = self.run_fit(box._tensor(T_obs), freqs, xside * yside,
                                 tpsmean, freeind)
        return (res.reshape(xside, yside, freqs.size),
                spec.reshape(xside, yside))
