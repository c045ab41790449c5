"""Takahashi et al. (2012) halofit nonlinear matter power spectrum.

The reference's default density realisation uses ``ccl.nonlin_matter_power``
(reference box.py:165), which for CCL's default config is halofit.  This is a
from-scratch implementation of the revised halofit fitting formulae
(arXiv:1208.2701), run host-side at table-build time.
"""
from __future__ import annotations

import warnings

import numpy as np
from scipy.integrate import IntegrationWarning, quad
from scipy.optimize import brentq

from .background import omega_de_of_a, omega_m_of_a
from .params import CosmoParams

__all__ = ["halofit_power"]


def _sigma2_moments(lnP_interp, R: float):
    """(sigma^2, dln sigma^2/dlnR, d^2 ln sigma^2/dlnR^2) at radius R.

    sigma^2(R) = int Delta^2_L(k) exp(-k^2 R^2) dlnk (Gaussian window,
    Smith et al. 2003 eq 54).  The logarithmic derivatives are computed by
    differentiating under the integral (with x = k^2 R^2:
    d sigma^2/dlnR = int Delta^2 (-2x) e^-x dlnk and
    d^2 sigma^2/dlnR^2 = int Delta^2 (4x^2 - 4x) e^-x dlnk), which is far
    more robust than finite-differencing quadrature output.
    """

    def make_integrand(moment):
        def integrand(lnk):
            k = np.exp(lnk)
            d2 = k**3 * np.exp(lnP_interp(lnk)) / (2.0 * np.pi**2)
            x = (k * R) ** 2
            w = np.exp(-x)
            if moment == 0:
                return d2 * w
            if moment == 1:
                return d2 * (-2.0 * x) * w
            return d2 * (4.0 * x * x - 4.0 * x) * w

        return integrand

    # The Gaussian window kills the integrand above k ~ few/R; truncating
    # there avoids quad roundoff over a huge empty range.
    lo = np.log(1e-6)
    hi = np.log(min(1e4, 40.0 / max(R, 1e-10)))
    with warnings.catch_warnings():
        # Benign roundoff-detection chatter at these tolerances.
        warnings.simplefilter("ignore", IntegrationWarning)
        s2 = quad(make_integrand(0), lo, hi, epsrel=1e-9, limit=400)[0]
        ds2 = quad(make_integrand(1), lo, hi, epsrel=1e-9, limit=400)[0]
        d2s2 = quad(make_integrand(2), lo, hi, epsrel=1e-9, limit=400)[0]
    dln = ds2 / s2
    d2ln = d2s2 / s2 - dln**2
    return s2, dln, d2ln


def _sigma2_gauss(lnP_interp, R: float) -> float:
    return _sigma2_moments(lnP_interp, R)[0]


def _sigma2_moments_tab(lnk, lnp, R):
    """Table-based moments: native C++ kernel when available, else the
    quad-based path above."""
    from .. import native

    if native.available():
        return native.sigma2_gauss_moments(lnk, lnp, R)
    itp = lambda x: np.interp(x, lnk, lnp)
    return _sigma2_moments(itp, R)


def halofit_power(cosmo: CosmoParams, k: np.ndarray, pk_lin: np.ndarray, a: float):
    """Nonlinear P(k) from the revised halofit.

    Parameters:
        k: wavenumbers in Mpc^-1 (ascending).
        pk_lin: linear P(k) at scale factor ``a`` (same shape as k), Mpc^3.
        a: scale factor.

    Returns:
        pk_nl: nonlinear power spectrum, Mpc^3.
    """
    k = np.asarray(k, dtype=np.float64)
    pk_lin = np.asarray(pk_lin, dtype=np.float64)
    lnk = np.log(k)
    lnP = np.log(np.maximum(pk_lin, 1e-300))

    # --- nonlinear scale: sigma(1/k_sigma) = 1 -------------------------
    f = lambda lnR: np.log(_sigma2_moments_tab(lnk, lnP, np.exp(lnR))[0])
    try:
        lnR_sig = brentq(f, np.log(1e-4), np.log(1e3), xtol=1e-8)
    except ValueError:
        # sigma^2 < 1 everywhere (very early times): spectrum is linear.
        return pk_lin.copy()
    R_sig = np.exp(lnR_sig)
    k_sig = 1.0 / R_sig

    # Effective index and curvature from analytic log-derivatives of sigma^2(R)
    _, dlns_dlnR, d2lns_dlnR2 = _sigma2_moments_tab(lnk, lnP, R_sig)
    n_eff = -3.0 - dlns_dlnR
    C_cur = -d2lns_dlnR2

    # --- fitting coefficients (Takahashi 2012 eqs A6-A13) --------------
    om_de = float(omega_de_of_a(cosmo, a))
    om_m = float(omega_m_of_a(cosmo, a))
    w = cosmo.w0
    n = n_eff
    an = 10.0 ** (
        1.5222 + 2.8553 * n + 2.3706 * n**2 + 0.9903 * n**3 + 0.2250 * n**4
        - 0.6038 * C_cur + 0.1749 * om_de * (1.0 + w)
    )
    bn = 10.0 ** (
        -0.5642 + 0.5864 * n + 0.5716 * n**2 - 1.5474 * C_cur
        + 0.2279 * om_de * (1.0 + w)
    )
    cn = 10.0 ** (0.3698 + 2.0404 * n + 0.8161 * n**2 + 0.5869 * C_cur)
    gamma_n = 0.1971 - 0.0843 * n + 0.8460 * C_cur
    alpha_n = abs(6.0835 + 1.3373 * n - 0.1959 * n**2 - 5.5274 * C_cur)
    beta_n = (
        2.0379 - 0.7354 * n + 0.3157 * n**2 + 1.2490 * n**3 + 0.3980 * n**4
        - 0.1682 * C_cur
    )
    mu_n = 0.0
    nu_n = 10.0 ** (5.2105 + 3.6902 * n)

    f1 = om_m**-0.0307
    f2 = om_m**-0.0585
    f3 = om_m**0.0743

    # --- assemble ------------------------------------------------------
    y = k / k_sig
    d2_lin = k**3 * pk_lin / (2.0 * np.pi**2)

    fy = y / 4.0 + y**2 / 8.0
    d2_Q = d2_lin * ((1.0 + d2_lin) ** beta_n / (1.0 + alpha_n * d2_lin)) * np.exp(-fy)

    d2_Hp = an * y ** (3.0 * f1) / (1.0 + bn * y**f2 + (cn * f3 * y) ** (3.0 - gamma_n))
    d2_H = d2_Hp / (1.0 + mu_n / y + nu_n / y**2)

    d2_nl = d2_Q + d2_H
    return 2.0 * np.pi**2 * d2_nl / k**3
