"""Cosmology: parameters, background, transfer functions, and tables.

The host-side modules (params, background, eisenstein_hu, halofit,
massfunction) are copies of fastbox_tpu's numpy/scipy code; ``tables`` returns torch tables.
"""
from .params import DEFAULT_COSMO, CosmoParams, as_cosmo_params
from .background import (
    comoving_angular_distance,
    comoving_radial_distance,
    e_of_a,
    growth_factor,
    growth_rate,
    h_over_h0,
    omega_m_of_a,
)
from .eisenstein_hu import linear_power_z0, transfer_eh98
from .halofit import halofit_power
from . import massfunction
from .tables import Cosmology, PowerSpectrumTable, build_cosmology

__all__ = [
    "DEFAULT_COSMO",
    "CosmoParams",
    "as_cosmo_params",
    "comoving_angular_distance",
    "comoving_radial_distance",
    "e_of_a",
    "growth_factor",
    "growth_rate",
    "h_over_h0",
    "omega_m_of_a",
    "linear_power_z0",
    "transfer_eh98",
    "halofit_power",
    "massfunction",
    "Cosmology",
    "PowerSpectrumTable",
    "build_cosmology",
]
