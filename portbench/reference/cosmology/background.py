"""Background cosmology: expansion, growth, and distances.

The reference calls into the CCL C library for these quantities at pipeline
run time (reference box.py:163-165,280-281,344-345,406,820,851).  Here
everything is evaluated *once at setup time* on the host (float64 numpy),
so the device pipeline only ever sees precomputed scalars and small
interpolation tables.  (A copy of fastbox_tpu/cosmology/background.py.)

Quantities provided (all for flat LCDM + radiation):
  * ``E(a) = H(a)/H0``
  * linear growth factor ``D(a)`` (normalised to D(1)=1) and growth rate
    ``f(a) = dlnD/dlna`` from the standard growth ODE
  * comoving radial/angular distance ``chi(z)`` (equal in flat space)
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
from scipy.integrate import solve_ivp, quad

from .constants import C_KMS
from .params import CosmoParams

__all__ = [
    "e_of_a",
    "h_over_h0",
    "omega_m_of_a",
    "omega_de_of_a",
    "growth_tables",
    "growth_factor",
    "growth_rate",
    "comoving_radial_distance",
    "comoving_angular_distance",
]


def e_of_a(cosmo: CosmoParams, a):
    """Dimensionless expansion rate E(a) = H(a)/H0."""
    a = np.asarray(a, dtype=np.float64)
    return np.sqrt(
        cosmo.Omega_m / a**3
        + cosmo.Omega_r / a**4
        + cosmo.Omega_l * a ** (-3.0 * (1.0 + cosmo.w0))
    )


def h_over_h0(cosmo: CosmoParams, a):
    """Alias matching the CCL name used throughout the reference."""
    return e_of_a(cosmo, a)


def omega_m_of_a(cosmo: CosmoParams, a):
    """Matter density parameter at scale factor a."""
    a = np.asarray(a, dtype=np.float64)
    return cosmo.Omega_m / a**3 / e_of_a(cosmo, a) ** 2


def omega_de_of_a(cosmo: CosmoParams, a):
    """Dark-energy density parameter at scale factor a."""
    a = np.asarray(a, dtype=np.float64)
    return cosmo.Omega_l * a ** (-3.0 * (1.0 + cosmo.w0)) / e_of_a(cosmo, a) ** 2


# ----------------------------------------------------------------------
# Linear growth
# ----------------------------------------------------------------------
_A_INIT = 1e-3


def _growth_ode(lna, y, cosmo: CosmoParams):
    """Growth ODE in x=ln(a): D'' + (2 + dlnE/dlna) D' = 1.5 Om(a) D."""
    a = np.exp(lna)
    D, dD = y
    E2 = e_of_a(cosmo, a) ** 2
    # dlnE/dlna = -0.5 * (3 Om/a^3 + 4 Or/a^4 + 3(1+w) Ol a^-3(1+w)) / E^2
    dlnE = -0.5 * (
        3.0 * cosmo.Omega_m / a**3
        + 4.0 * cosmo.Omega_r / a**4
        + 3.0 * (1.0 + cosmo.w0) * cosmo.Omega_l * a ** (-3.0 * (1.0 + cosmo.w0))
    ) / E2
    om_a = cosmo.Omega_m / a**3 / E2
    return [dD, -(2.0 + dlnE) * dD + 1.5 * om_a * D]


@lru_cache(maxsize=32)
def growth_tables(cosmo: CosmoParams, a_min: float = _A_INIT, n: int = 512):
    """Solve the growth ODE; return (a, D(a) normalised to D(1)=1, f(a)).

    Matter-domination initial conditions D = a, dD/dlna = a at ``a_min``.
    Cached per (cosmology, grid) — the COLA step schedule interrogates it
    dozens of times per realisation (~0.5 s of host solve_ivp otherwise).
    """
    lna = np.linspace(np.log(a_min), 0.0, n)
    sol = solve_ivp(
        _growth_ode,
        (lna[0], 0.0),
        [a_min, a_min],
        t_eval=lna,
        args=(cosmo,),
        rtol=1e-8,
        atol=1e-10,
        method="RK45",
    )
    D = sol.y[0]
    dD = sol.y[1]
    f = dD / D
    a = np.exp(lna)
    out = (a, D / D[-1], f)
    for arr in out:  # cached + shared: guard against caller mutation
        arr.setflags(write=False)
    return out


def growth_factor(cosmo: CosmoParams, a):
    """D(a), normalised to unity today (CCL `growth_factor` convention)."""
    a_tab, D_tab, _ = growth_tables(cosmo)
    return np.interp(np.log(np.asarray(a, dtype=np.float64)), np.log(a_tab), D_tab)


def growth_rate(cosmo: CosmoParams, a):
    """f(a) = dlnD/dlna (CCL `growth_rate` convention)."""
    a_tab, _, f_tab = growth_tables(cosmo)
    return np.interp(np.log(np.asarray(a, dtype=np.float64)), np.log(a_tab), f_tab)


# ----------------------------------------------------------------------
# Distances
# ----------------------------------------------------------------------
def comoving_radial_distance(cosmo: CosmoParams, a):
    """Comoving radial distance chi(a) in Mpc (CCL name/convention)."""
    scalar = np.isscalar(a) or np.ndim(a) == 0
    a_arr = np.atleast_1d(np.asarray(a, dtype=np.float64))
    out = np.empty_like(a_arr)
    for i, ai in enumerate(a_arr):
        if ai >= 1.0:
            out[i] = 0.0
            continue
        val, _ = quad(
            lambda x: 1.0 / (x * x * e_of_a(cosmo, x)), ai, 1.0, epsrel=1e-9, limit=200
        )
        out[i] = (C_KMS / cosmo.H0) * val
    return out[0] if scalar else out


def comoving_angular_distance(cosmo: CosmoParams, a):
    """Comoving angular-diameter distance; equals chi in flat space."""
    return comoving_radial_distance(cosmo, a)
