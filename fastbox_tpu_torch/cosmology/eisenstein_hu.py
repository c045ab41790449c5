"""Eisenstein & Hu (1998) matter transfer function and linear power spectrum.

The reference obtains its linear/nonlinear P(k) from pyccl configured with
``transfer_function='eisenstein_hu'`` (reference box.py:18-20,163-165).  This
module is a from-scratch implementation of the full (baryon-wiggle) EH98
fitting formulae, astro-ph/9709112, used at *setup time only* to tabulate
P(k); the device pipeline interpolates the table (see tables.py).

All functions are host-side float64 numpy.
"""
from __future__ import annotations

import numpy as np
from scipy.integrate import quad

from .params import CosmoParams

__all__ = ["transfer_eh98", "linear_power_unnorm", "sigma_r_unnorm", "linear_power_z0"]


def _eh98_setup(cosmo: CosmoParams):
    """Precompute the EH98 intermediate scales for a given cosmology."""
    om_mh2 = cosmo.Omega_m * cosmo.h**2
    om_bh2 = cosmo.Omega_b * cosmo.h**2
    fb = cosmo.Omega_b / cosmo.Omega_m
    fc = cosmo.Omega_c / cosmo.Omega_m
    theta = cosmo.T_CMB / 2.7

    # Matter-radiation equality (EH98 eqs 2-3)
    z_eq = 2.50e4 * om_mh2 / theta**4
    k_eq = 7.46e-2 * om_mh2 / theta**2  # Mpc^-1

    # Drag epoch (eq 4)
    b1 = 0.313 * om_mh2**-0.419 * (1.0 + 0.607 * om_mh2**0.674)
    b2 = 0.238 * om_mh2**0.223
    z_d = (
        1291.0
        * om_mh2**0.251
        / (1.0 + 0.659 * om_mh2**0.828)
        * (1.0 + b1 * om_bh2**b2)
    )

    # Baryon-to-photon momentum ratio (eq 5)
    R_of_z = lambda z: 31.5 * om_bh2 / theta**4 * (1.0e3 / z)
    R_eq = R_of_z(z_eq)
    R_d = R_of_z(z_d)

    # Sound horizon at drag (eq 6)
    s = (
        (2.0 / (3.0 * k_eq))
        * np.sqrt(6.0 / R_eq)
        * np.log((np.sqrt(1.0 + R_d) + np.sqrt(R_d + R_eq)) / (1.0 + np.sqrt(R_eq)))
    )

    # Silk damping scale (eq 7)
    k_silk = (
        1.6 * om_bh2**0.52 * om_mh2**0.73 * (1.0 + (10.4 * om_mh2) ** -0.95)
    )

    # CDM suppression (eqs 11-12)
    a1 = (46.9 * om_mh2) ** 0.670 * (1.0 + (32.1 * om_mh2) ** -0.532)
    a2 = (12.0 * om_mh2) ** 0.424 * (1.0 + (45.0 * om_mh2) ** -0.582)
    alpha_c = a1 ** (-fb) * a2 ** (-(fb**3))
    bb1 = 0.944 / (1.0 + (458.0 * om_mh2) ** -0.708)
    bb2 = (0.395 * om_mh2) ** -0.0266
    beta_c = 1.0 / (1.0 + bb1 * (fc**bb2 - 1.0))

    # Baryon envelope (eqs 14-15, 23-24)
    y = (1.0 + z_eq) / (1.0 + z_d)
    sq = np.sqrt(1.0 + y)
    G_y = y * (-6.0 * sq + (2.0 + 3.0 * y) * np.log((sq + 1.0) / (sq - 1.0)))
    alpha_b = 2.07 * k_eq * s * (1.0 + R_d) ** -0.75 * G_y
    beta_b = 0.5 + fb + (3.0 - 2.0 * fb) * np.sqrt((17.2 * om_mh2) ** 2 + 1.0)
    beta_node = 8.41 * om_mh2**0.435

    return dict(
        k_eq=k_eq, s=s, k_silk=k_silk, alpha_c=alpha_c, beta_c=beta_c,
        alpha_b=alpha_b, beta_b=beta_b, beta_node=beta_node, fb=fb, fc=fc,
    )


def _T0_tilde(q, alpha, beta):
    """EH98 eqs 19-20: the pressureless CDM fit T0~(k; alpha_c, beta_c)."""
    C = 14.2 / alpha + 386.0 / (1.0 + 69.9 * q**1.08)
    lnarg = np.log(np.e + 1.8 * beta * q)
    return lnarg / (lnarg + C * q**2)


def transfer_eh98(cosmo: CosmoParams, k):
    """Full EH98 transfer function (with BAO wiggles) at wavenumber k [Mpc^-1]."""
    k = np.asarray(k, dtype=np.float64)
    p = _eh98_setup(cosmo)
    theta = cosmo.T_CMB / 2.7
    om_mh2 = cosmo.Omega_m * cosmo.h**2

    q = k / (13.41 * p["k_eq"])  # eq 10
    ks = k * p["s"]

    # CDM piece (eqs 17-18)
    f = 1.0 / (1.0 + (ks / 5.4) ** 4)
    T_c = f * _T0_tilde(q, 1.0, p["beta_c"]) + (1.0 - f) * _T0_tilde(
        q, p["alpha_c"], p["beta_c"]
    )

    # Baryon piece (eqs 21-22)
    s_tilde = p["s"] / (1.0 + (p["beta_node"] / np.maximum(ks, 1e-30)) ** 3) ** (
        1.0 / 3.0
    )
    x = k * s_tilde
    j0 = np.where(x > 1e-8, np.sin(x) / np.maximum(x, 1e-30), 1.0 - x**2 / 6.0)
    T_b = (
        _T0_tilde(q, 1.0, 1.0) / (1.0 + (ks / 5.2) ** 2)
        + p["alpha_b"]
        / (1.0 + (p["beta_b"] / np.maximum(ks, 1e-30)) ** 3)
        * np.exp(-((k / p["k_silk"]) ** 1.4))
    ) * j0

    return p["fb"] * T_b + p["fc"] * T_c  # eq 16


def linear_power_unnorm(cosmo: CosmoParams, k):
    """Un-normalised linear P(k) at z=0: k^n_s T(k)^2."""
    k = np.asarray(k, dtype=np.float64)
    T = transfer_eh98(cosmo, k)
    return np.where(k > 0.0, k**cosmo.n_s * T**2, 0.0)


def _tophat_w(x):
    """Fourier transform of the 3D spherical top-hat window."""
    x = np.asarray(x, dtype=np.float64)
    small = x < 1e-4
    with np.errstate(invalid="ignore", divide="ignore"):
        w = 3.0 * (np.sin(x) - x * np.cos(x)) / x**3
    return np.where(small, 1.0 - x**2 / 10.0, w)


def sigma_r_unnorm(cosmo: CosmoParams, R: float) -> float:
    """sigma(R) of the un-normalised z=0 linear spectrum (R in Mpc)."""

    def integrand(lnk):
        k = np.exp(lnk)
        return k**3 * linear_power_unnorm(cosmo, k) * _tophat_w(k * R) ** 2

    val, _ = quad(integrand, np.log(1e-6), np.log(1e3), epsrel=1e-8, limit=400)
    return float(np.sqrt(val / (2.0 * np.pi**2)))


def linear_power_z0(cosmo: CosmoParams, k):
    """sigma8-normalised linear matter power spectrum at z=0, in Mpc^3."""
    R8 = 8.0 / cosmo.h
    norm = (cosmo.sigma8 / sigma_r_unnorm(cosmo, R8)) ** 2
    return norm * linear_power_unnorm(cosmo, k)
