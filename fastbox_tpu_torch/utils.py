"""Survey-geometry helpers (a copy of fastbox_tpu/utils.py:20-67).

Converts an observational survey footprint (angular extent on the sky plus
a frequency or redshift interval along the line of sight) into the comoving
cuboid a :class:`~fastbox_tpu_torch.grid.GridSpec` needs.  Functional
parity with the reference's ``comoving_dimensions_from_survey``
(fastbox/utils.py:8-67), with the pyccl background calls replaced by the
native tabulated background (:mod:`fastbox_tpu_torch.cosmology.background`).
"""
from __future__ import annotations

import numpy as np

from .constants import LINE_FREQ_21CM
from .cosmology import as_cosmo_params, background as bg

__all__ = ["comoving_dimensions_from_survey"]


def comoving_dimensions_from_survey(cosmo, angular_extent, freq_range=None,
                                    z_range=None, line_freq=LINE_FREQ_21CM):
    """Comoving box dimensions for a survey footprint.

    Parameters:
        cosmo: cosmology parameters (dict or ``CosmoParams``).
        angular_extent: (dx_deg, dy_deg) transverse sky extent in degrees.
        freq_range: (f_lo, f_hi) observing band in MHz.  Exactly one of
            ``freq_range`` / ``z_range`` must be given; a frequency band is
            converted to redshifts via the line rest frequency.
        z_range: (z_lo, z_hi) redshift interval along the line of sight.
        line_freq: rest-frame line frequency in MHz (21cm by default).

    Returns:
        ``(zc, (Lx, Ly, Lz))`` — the volume-centre redshift (the redshift of
        the midpoint in comoving radial distance, not in z) and the comoving
        side lengths in Mpc.  The transverse sides are evaluated at ``zc``.
    """
    params = as_cosmo_params(cosmo)
    if (freq_range is None) == (z_range is None):
        raise ValueError(
            "give exactly one of freq_range or z_range, not both/neither")
    if len(angular_extent) != 2:
        raise ValueError("angular_extent needs two entries (dx_deg, dy_deg)")

    if freq_range is not None:
        if len(freq_range) != 2:
            raise ValueError("freq_range needs two entries (f_lo, f_hi) MHz")
        z_range = tuple(line_freq / f - 1.0 for f in freq_range)
    if len(z_range) != 2:
        raise ValueError("z_range needs two entries (z_lo, z_hi)")
    zmin, zmax = sorted(z_range)

    # Radial depth: difference of comoving distances to the interval edges.
    chi_near = bg.comoving_radial_distance(params, 1.0 / (1.0 + zmin))
    chi_far = bg.comoving_radial_distance(params, 1.0 / (1.0 + zmax))
    Lz = chi_far - chi_near

    # Centre redshift: invert chi(z) at the radial midpoint on a fine table.
    ztab = np.linspace(zmin, zmax, 100)
    chitab = bg.comoving_radial_distance(params, 1.0 / (1.0 + ztab))
    zc = float(np.interp(0.5 * (chi_near + chi_far), chitab, ztab))

    # Transverse extent: angle times comoving angular-diameter distance at zc.
    d_trans = bg.comoving_angular_distance(params, 1.0 / (1.0 + zc))
    deg = np.pi / 180.0
    Lx = angular_extent[0] * deg * d_trans
    Ly = angular_extent[1] * deg * d_trans
    return zc, (Lx, Ly, Lz)
