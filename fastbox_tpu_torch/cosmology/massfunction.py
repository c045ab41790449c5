"""Halo mass function and halo bias (Sheth-Tormen), a copy of
``fastbox_tpu/cosmology/massfunction.py``.

The reference delegates these to pyccl (``ccl.massfunction.massfunc`` and
``ccl.halo_bias`` at halos.py:48-50, dead code there).  This is a working
native implementation: sigma(M) from the tabulated linear P(k) at z = 0
with a top-hat window, and the Sheth & Tormen (1999) multiplicity function
and peak-background-split bias.  Host-side float64 numpy, read from the
bundle's ``pk_lin_z0`` table wherever that lives.
"""
from __future__ import annotations

import numpy as np

from . import background as bg

__all__ = ["sigma_m", "dndlog10m", "halo_bias", "RHO_CRIT0"]

# Critical density today in Msun / Mpc^3 (h=1 units applied via params.h)
RHO_CRIT0 = 2.77536627e11  # h^2 Msun / Mpc^3
DELTA_C = 1.686


def _sigma_tophat_table(cosmology, Rs):
    """sigma(R) at z=0 from the bundle's linear P(k) table (top-hat)."""
    table = cosmology.pk_lin_z0
    lnk = table.lnk.detach().cpu().double().numpy()
    lnp = table.lnp.detach().cpu().double().numpy()
    k = np.exp(lnk)
    pk = np.exp(lnp)
    out = np.empty_like(Rs, dtype=np.float64)
    for i, R in enumerate(np.atleast_1d(Rs)):
        x = k * R
        w = np.where(x < 1e-4, 1.0 - x**2 / 10.0,
                     3.0 * (np.sin(x) - x * np.cos(x)) / x**3)
        integ = k**3 * pk * w**2 / (2.0 * np.pi**2)
        out[i] = np.sqrt(np.trapezoid(integ, lnk))
    return out


def sigma_m(cosmology, M, z=0.0):
    """RMS of the linear field smoothed on the Lagrangian scale of mass M
    (Msun), at redshift z."""
    params = cosmology.params
    rho_m = RHO_CRIT0 * params.h**2 * params.Omega_m  # Msun / Mpc^3
    M = np.atleast_1d(np.asarray(M, dtype=np.float64))
    R = (3.0 * M / (4.0 * np.pi * rho_m)) ** (1.0 / 3.0)  # Mpc
    s = _sigma_tophat_table(cosmology, R)
    D = bg.growth_factor(params, 1.0 / (1.0 + z))
    return s * D


def dndlog10m(cosmology, M, z=0.0):
    """Sheth-Tormen halo mass function dn/dlog10M in Mpc^-3 dex^-1."""
    params = cosmology.params
    rho_m = RHO_CRIT0 * params.h**2 * params.Omega_m
    M = np.atleast_1d(np.asarray(M, dtype=np.float64))
    sig = sigma_m(cosmology, M, z)
    nu = DELTA_C / sig

    # dln sigma^-1 / dlog10 M by finite difference
    eps = 1e-3
    sig_hi = sigma_m(cosmology, M * (1 + eps), z)
    dlnsinv_dlnM = -(np.log(sig_hi) - np.log(sig)) / np.log(1 + eps)

    # ST99 multiplicity: f(nu) = A sqrt(2a/pi) nu [1+(a nu^2)^-p] exp(-a nu^2/2)
    A, a, p = 0.3222, 0.707, 0.3
    f = A * np.sqrt(2.0 * a / np.pi) * nu * (1.0 + (a * nu**2) ** (-p)) \
        * np.exp(-a * nu**2 / 2.0)

    dndlnM = f * rho_m / M * dlnsinv_dlnM
    return dndlnM * np.log(10.0)


def halo_bias(cosmology, M, z=0.0):
    """Sheth-Tormen peak-background-split linear halo bias."""
    sig = sigma_m(cosmology, M, z)
    nu = DELTA_C / sig
    a, p = 0.707, 0.3
    return 1.0 + (a * nu**2 - 1.0) / DELTA_C \
        + (2.0 * p / DELTA_C) / (1.0 + (a * nu**2) ** p)
