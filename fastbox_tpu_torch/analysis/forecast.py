"""Fisher forecasting for 21cm x galaxy cross-correlations.

A copy of ``fastbox_tpu/analysis/forecast.py`` (reference
``fastbox/forecast.py``) over the port's cosmology: host numpy, as there.
All CCL calls (distances, growth, NumberCountsTracer/angular C_ell) are
replaced by the native background module and a Limber-approximation C_ell
integrator over the tabulated P(k), whose z = 0 table is built on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import C_KMS, INF_NOISE, NU21CM
from ..cosmology import as_cosmo_params, background as bg
from ..cosmology.tables import build_cosmology

__all__ = [
    "inst_meerkatuhf", "inst_gbt", "inst_hirax",
    "sigmaT", "Tb", "bias_HI", "bias_gal",
    "lmax_for_redshift", "lmin_for_redshift",
    "noise_im", "number_density_to_area_density",
    "TracerSpectro", "tracer_spectro", "angular_cl", "fisher_bandpowers",
]

# Example experiment definitions (forecast.py:13-51)
inst_meerkatuhf = {
    "name": "MeerKAT_UHF", "type": "dish", "D": 13.5, "Ndish": 64,
    "fsky": 0.1, "Tsys": 26.0, "ttot": 4000.0, "fsky_overlap": 0.1,
    "kmax0": 0.14,
}
inst_gbt = {
    "name": "GBT", "type": "dish", "D": 100.0, "Ndish": 7, "fsky": 0.15,
    "Tsys": 30.0, "ttot": 3.2e4, "fsky_overlap": 0.15, "kmax0": 0.14,
}
inst_hirax = {
    "name": "hrx", "type": "interferometer", "D": 6.0, "d_min": 6.0,
    "d_max": 32.0 * 6.0 * 1.41, "Ndish": 32 * 32, "fsky": 0.4, "Tsys": 50.0,
    "ttot": 2.8e4, "fsky_overlap": 0.4, "kmax0": 0.14,
}


def sigmaT(expt):
    """Noise RMS in mK.MHz (forecast.py:54-74)."""
    sigmaT2 = (4.0 * np.pi * expt["fsky"] * expt["Tsys"] ** 2
               / (expt["ttot"] * 3600.0 * expt["Ndish"]))
    return np.sqrt(sigmaT2)


def Tb(z):
    """Brightness temperature fit, mK (forecast.py:77-90)."""
    return 5.5919e-02 + 2.3242e-01 * z - 2.4136e-02 * z**2


def bias_HI(z):
    """HI bias fit (forecast.py:93-106)."""
    return 6.6655e-01 + 1.7765e-01 * z + 5.0223e-02 * z**2


def bias_gal(z):
    """ELG-like galaxy bias sqrt(1+z) (forecast.py:109-122)."""
    return np.sqrt(1.0 + z)


def lmax_for_redshift(cosmo, z, kmax0=0.2):
    """kmax scaled by growth, converted to ell (forecast.py:125-146)."""
    params = as_cosmo_params(cosmo)
    r = bg.comoving_radial_distance(params, 1.0 / (1.0 + z))
    D = bg.growth_factor(params, 1.0 / (1.0 + z))
    return r * D * kmax0


def lmin_for_redshift(cosmo, z, dmin):
    """lmin for an interferometer's shortest baseline (forecast.py:149-169)."""
    nu = 1420.0 / (1.0 + z)
    lam = (C_KMS * 1e3) / (nu * 1e6)
    return 2.0 * np.pi * dmin / lam


def noise_im(cosmo, expt, ells, zmin, zmax, kmax_cutoff=False):
    """Noise angular power spectrum, mK^2 (forecast.py:172-248).

    Alonso et al. (2017) expressions; dish vs interferometer selected by
    ``expt['type']``; INF_NOISE cuts outside the sampled scales.
    """
    params = as_cosmo_params(cosmo)
    ells = np.atleast_1d(ells)
    zmin = np.atleast_1d(zmin)
    zmax = np.atleast_1d(zmax)

    zc = 0.5 * (zmin + zmax)
    nu = NU21CM / (1.0 + zc)
    lam = (C_KMS * 1e3) / (nu * 1e6)  # m

    dnu = NU21CM * (1.0 / (1.0 + zmin) - 1.0 / (1.0 + zmax))
    _ell, _lam = np.meshgrid(ells, lam)

    if expt["type"] == "interferometer":
        f_ell = np.exp(_ell * (_ell + 1.0)
                       * (1.22 * _lam / expt["d_max"]) ** 2
                       / (8.0 * np.log(2.0)))
        N_ij = f_ell * sigmaT(expt) ** 2 / dnu[:, None]
        N_ij[np.where(_ell * _lam / (2.0 * np.pi) <= expt["d_min"])] = INF_NOISE
    elif expt["type"] == "dish":
        fwhm = 1.22 * _lam / expt["D"]
        B_l = np.exp(-_ell * (_ell + 1) * fwhm**2 / (16.0 * np.log(2.0)))
        N_ij = sigmaT(expt) ** 2 / dnu[:, None] / B_l**2
    else:
        raise NotImplementedError(
            f"Unrecognised instrument type '{expt['type']}'.")

    N_ij = N_ij.T
    if kmax_cutoff:
        lmax = lmax_for_redshift(params, zmax, kmax0=expt["kmax0"])
        lmax = np.atleast_1d(lmax)
        for i in range(N_ij.shape[1]):
            N_ij[np.where(ells > lmax[i]), i] = INF_NOISE
    return N_ij


def number_density_to_area_density(cosmo, ngal, zmin, zmax, degrees=False):
    """Comoving number density -> per-solid-angle (forecast.py:251-282)."""
    params = as_cosmo_params(cosmo)
    rmin = bg.comoving_radial_distance(params, 1.0 / (1.0 + zmin))
    rmax = bg.comoving_radial_distance(params, 1.0 / (1.0 + zmax))
    vol = (4.0 / 3.0) * np.pi * (rmax**3 - rmin**3)
    Ngal = (ngal * vol) / (4.0 * np.pi)
    return Ngal * (np.pi / 180.0) ** 2 if degrees else Ngal


class TracerSpectro:
    """Native replacement for ccl.NumberCountsTracer in the spectroscopic,
    no-RSD, no-magnification configuration the reference uses
    (forecast.py:285-318): a top-hat selection in z with a bias function.
    """

    def __init__(self, cosmo, zmin, zmax, kind="galaxy"):
        self.params = as_cosmo_params(cosmo)
        self.zmin, self.zmax = zmin, zmax
        self.kind = kind
        z = np.linspace(zmin * 0.8, zmax * 1.2, 2000)
        tomo = np.where((z >= zmin) & (z < zmax), 1.0, 0.0)
        bz = bias_gal(z) if kind == "galaxy" else bias_HI(z) * Tb(z)
        # Normalised radial window W(z) with dN/dz = tomo
        norm = np.trapezoid(tomo, z)
        self.z = z
        self.Wz = tomo / norm
        self.bz = bz

    def kernel(self, z):
        """W(z) b(z) D(z), interpolated."""
        W = np.interp(z, self.z, self.Wz, left=0.0, right=0.0)
        b = np.interp(z, self.z, self.bz)
        return W, b


def tracer_spectro(cosmo, zmin, zmax, kind="galaxy"):
    """Reference-named constructor (forecast.py:285-318)."""
    return TracerSpectro(cosmo, zmin, zmax, kind)


def angular_cl(cosmo, tracer1, tracer2, ells, nz: int = 256):
    """Limber-approximation angular power spectrum for two tracers.

    C_ell = int dz [H(z)/c] W1 W2 b1 b2 D^2(z) / chi^2 * P(k=(l+1/2)/chi, 0)

    This replaces ``ccl.angular_cl`` for the number-counts tracers used in
    the Fisher notebook (SURVEY.md §3.5).
    """
    params = as_cosmo_params(cosmo)
    c = build_cosmology(params, 0.0, device="cpu")
    zmin = min(tracer1.zmin, tracer2.zmin) * 0.8
    zmax = max(tracer1.zmax, tracer2.zmax) * 1.2
    z = np.linspace(max(zmin, 1e-4), zmax, nz)
    a = 1.0 / (1.0 + z)
    chi = bg.comoving_radial_distance(params, a)
    Ez = bg.e_of_a(params, a)
    Dz = bg.growth_factor(params, a)

    W1, b1 = tracer1.kernel(z)
    W2, b2 = tracer2.kernel(z)

    ells = np.atleast_1d(ells).astype(np.float64)
    cls = np.zeros(ells.size)
    H_c = (100.0 * params.h * Ez) / C_KMS  # 1/Mpc
    chi_safe = np.maximum(chi, 1e-4)
    for i, ell in enumerate(ells):
        k = (ell + 0.5) / chi_safe
        pk0 = c.pk_lin_z0(torch.as_tensor(k, dtype=torch.float64)).numpy()
        integrand = H_c * W1 * W2 * b1 * b2 * Dz**2 * pk0 / chi_safe**2
        cls[i] = np.trapezoid(integrand, z)
    return cls


def fisher_bandpowers(ells, delta_ell, fsky, Cell_gal, Cell_im, Cell_cross,
                      Nell_gal, Nell_im):
    """Diagonal Fisher for cross-spectrum bandpowers (forecast.py:321-356)."""
    numerator = (2.0 * ells + 1.0) * delta_ell * fsky
    denom = (Cell_gal + Nell_gal) * (Cell_im + Nell_im) + Cell_cross**2
    return numerator / denom
