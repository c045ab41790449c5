"""Setup-time cosmology tabulation -> device-side interpolation.

Torch counterpart of ``fastbox_tpu/cosmology/tables.py``: the host
tabulates ln P(ln k) once per (cosmology, redshift) in float64 numpy, and
the pipeline evaluates the spectrum on the device with a log-uniform
index, a truncation to an integer and two gathers.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import background as bg
from .eisenstein_hu import linear_power_z0
from .halofit import halofit_power
from .params import CosmoParams, as_cosmo_params

__all__ = ["PowerSpectrumTable", "Cosmology", "build_cosmology"]

# Mpc^-1; the same table as fastbox_tpu/cosmology/tables.py:_KTAB.
_KTAB = np.logspace(-5.0, 3.0, 8192)


@dataclasses.dataclass(frozen=True)
class PowerSpectrumTable:
    """Log-log P(k) table evaluated on the device by linear interpolation."""

    lnk: torch.Tensor  # (n,) ln k, ascending, log-uniform
    lnp: torch.Tensor  # (n,) ln P(k)

    def __call__(self, k: torch.Tensor) -> torch.Tensor:
        """Interpolate P(k); 0 at k <= 0 (reference nan_to_num, box.py:167).

        ``k`` is cast to the table's dtype and device, so the whole
        interpolation runs in the table's precision.
        """
        k = torch.as_tensor(k, dtype=self.lnk.dtype, device=self.lnk.device)
        x = torch.log(torch.where(k > 0.0, k, torch.ones_like(k)))
        n = self.lnk.shape[0]
        x0 = self.lnk[0]
        dx = (self.lnk[-1] - x0) / (n - 1)
        f = torch.clamp((x - x0) / dx, 0.0, n - 1.0)
        i = torch.clamp(f.to(torch.int64), 0, n - 2)
        w = f - i.to(f.dtype)
        lnp = self.lnp[i] * (1.0 - w) + self.lnp[i + 1] * w
        return torch.where(k > 0.0, torch.exp(lnp), torch.zeros_like(lnp))

    @classmethod
    def from_arrays(cls, k, pk, dtype=torch.float64, device="cpu"):
        k = np.asarray(k, dtype=np.float64)
        pk = np.asarray(pk, dtype=np.float64)
        good = (k > 0) & (pk > 0)
        lnk = np.log(k[good])
        lnp = np.log(pk[good])
        # __call__ assumes a log-uniform grid; resample if it isn't.
        d = np.diff(lnk)
        if d.size and (np.abs(d - d[0]).max() > 1e-9 * abs(d[0])):
            lnk_u = np.linspace(lnk[0], lnk[-1], max(lnk.size, 4096))
            lnp = np.interp(lnk_u, lnk, lnp)
            lnk = lnk_u
        return cls.from_log_arrays(lnk, lnp, dtype, device)

    @classmethod
    def from_log_arrays(cls, lnk, lnp, dtype=torch.float64, device="cpu"):
        """A table from ln k / ln P arrays that are already log-uniform."""
        return cls(lnk=torch.tensor(np.asarray(lnk), dtype=dtype,
                                    device=device),
                   lnp=torch.tensor(np.asarray(lnp), dtype=dtype,
                                    device=device))


@dataclasses.dataclass(frozen=True)
class Cosmology:
    """Parameters + background scalars + P(k) tables at one redshift.

    ``params`` may be None for a bundle converted from another package's
    state (``fastbox_tpu_torch.convert.from_jax_state``), which carries
    only the scalars the pipeline reads.
    """

    params: CosmoParams | None
    h: float
    redshift: float
    scale_factor: float
    Ea: float           # E(a) = H(a)/H0
    growth: float       # D(a), normalised to 1 today
    growth_rate: float  # f(a) = dlnD/dlna
    chi: float          # comoving radial distance, Mpc
    pk_lin: PowerSpectrumTable
    pk_nl: PowerSpectrumTable
    pk_lin_z0: PowerSpectrumTable

    @property
    def H(self) -> float:
        """H(a) in km/s/Mpc."""
        return 100.0 * self.h * self.Ea

    def pk(self, k, linear: bool = False):
        """Matter power spectrum at the bundle's redshift."""
        return self.pk_lin(k) if linear else self.pk_nl(k)


def build_cosmology(cosmo, redshift: float = 0.0,
                    k_table: np.ndarray | None = None,
                    dtype=torch.float64, device="cpu") -> Cosmology:
    """Tabulate all cosmology inputs the pipeline needs.

    Parameters:
        cosmo: CosmoParams or a reference-style dict (box.py:18-20).
        redshift: redshift at which fields will be realised.
        k_table: optional custom wavenumber table (Mpc^-1).
        dtype, device: of the P(k) tables.
    """
    params = as_cosmo_params(cosmo)
    a = 1.0 / (1.0 + redshift)
    k = np.asarray(k_table if k_table is not None else _KTAB, dtype=np.float64)

    pk0 = linear_power_z0(params, k)
    D = float(bg.growth_factor(params, a))
    pk_lin_z = pk0 * D**2
    pk_nl_z = halofit_power(params, k, pk_lin_z, a)

    def table(pk):
        return PowerSpectrumTable.from_arrays(k, pk, dtype, device)

    return Cosmology(
        params=params,
        h=float(params.h),
        redshift=float(redshift),
        scale_factor=a,
        Ea=float(bg.e_of_a(params, a)),
        growth=D,
        growth_rate=float(bg.growth_rate(params, a)),
        chi=float(bg.comoving_radial_distance(params, a)),
        pk_lin=table(pk_lin_z),
        pk_nl=table(pk_nl_z),
        pk_lin_z0=table(pk0),
    )
