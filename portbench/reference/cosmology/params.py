"""Cosmological parameter container.

The reference delegates all cosmology to pyccl's ``ccl.Cosmology`` object
(reference box.py:61-64); here cosmology is plain data.  A ``CosmoParams`` is a
frozen dataclass built from the same keyword names the reference's
``default_cosmo`` dict uses (box.py:18-20), so the familiar

    CosmoBox(cosmo=dict(Omega_c=0.25, Omega_b=0.05, h=0.7, n_s=0.95,
                        sigma8=0.8), ...)

construction keeps working.
"""
from __future__ import annotations

import dataclasses

from .constants import NEFF, T_CMB

# Mirrors the reference's `default_cosmo` (box.py:18-20).  The reference also
# passes `transfer_function='eisenstein_hu'`; Eisenstein-Hu is our native
# transfer function, so that option is implicit.
DEFAULT_COSMO = dict(Omega_c=0.25, Omega_b=0.05, h=0.7, n_s=0.95, sigma8=0.8)


@dataclasses.dataclass(frozen=True)
class CosmoParams:
    """Flat-LCDM cosmological parameters (sigma8-normalised)."""

    Omega_c: float = 0.25
    Omega_b: float = 0.05
    h: float = 0.7
    n_s: float = 0.95
    sigma8: float = 0.8
    T_CMB: float = T_CMB
    Neff: float = NEFF
    w0: float = -1.0

    # ------------------------------------------------------------------
    @property
    def Omega_m(self) -> float:
        return self.Omega_c + self.Omega_b

    @property
    def Omega_g(self) -> float:
        """Photon density parameter from T_CMB."""
        # rho_g = (pi^2/15) (kT)^4 / (hbar^3 c^5); Omega_g h^2 = 2.472e-5 (T/2.725)^4
        return 2.47282e-5 * (self.T_CMB / 2.725) ** 4 / self.h**2

    @property
    def Omega_nu_rel(self) -> float:
        """Massless-neutrino density parameter."""
        return self.Omega_g * self.Neff * (7.0 / 8.0) * (4.0 / 11.0) ** (4.0 / 3.0)

    @property
    def Omega_r(self) -> float:
        return self.Omega_g + self.Omega_nu_rel

    @property
    def Omega_l(self) -> float:
        """Dark-energy density for a flat universe."""
        return 1.0 - self.Omega_m - self.Omega_r

    @property
    def H0(self) -> float:
        """Hubble constant in km/s/Mpc."""
        return 100.0 * self.h

    # ------------------------------------------------------------------
    def __getitem__(self, key: str) -> float:
        """Dict-style access for reference-API compatibility.

        The reference code reads e.g. ``self.cosmo['h']`` and
        ``self.cosmo['Omega_c']`` off the CCL object (box.py:280,343-344).
        """
        try:
            return getattr(self, key)
        except AttributeError as exc:
            raise KeyError(key) from exc

    @classmethod
    def from_dict(cls, d: dict) -> "CosmoParams":
        """Build from a reference-style cosmology dict.

        Unknown keys that CCL accepts but we do not model (e.g.
        ``transfer_function``) are ignored.
        """
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


def as_cosmo_params(cosmo) -> CosmoParams:
    """Coerce a CosmoParams, reference-style dict, or built Cosmology
    (anything carrying a ``.params`` CosmoParams — the analog of the
    reference passing its ``ccl.Cosmology`` into forecast helpers,
    forecast.py:59-210) into CosmoParams."""
    if isinstance(cosmo, CosmoParams):
        return cosmo
    if isinstance(cosmo, dict):
        return CosmoParams.from_dict(cosmo)
    params = getattr(cosmo, "params", None)
    if isinstance(params, CosmoParams):
        return params
    raise TypeError("`cosmo` must be a CosmoParams, a params dict, or a "
                    "built Cosmology.")
