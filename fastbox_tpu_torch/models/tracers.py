"""Biased-tracer models (a copy of fastbox_tpu/models/tracers.py:15-62).

Matches the reference's ``TracerModel`` / ``HITracer``
(reference tracers.py:11-164): constant signal amplitude, b(z) = b0 sqrt(1+z)
linear bias, and the Bull et al. (2015) HI fitting formulae.  Closed-form
host functions of the redshift.
"""
from __future__ import annotations

import numpy as np

__all__ = ["TracerModel", "HITracer"]


class TracerModel:
    """Simple biased tracer on top of a density field (tracers.py:11-59)."""

    def __init__(self, box):
        self.box = box

    def signal_amplitude(self, amp, redshift):
        """Constant-amplitude model (tracers.py:25-41)."""
        return amp + 0.0 * redshift

    def linear_bias(self, b0, redshift):
        """b(z) = b0 sqrt(1+z) (tracers.py:44-59)."""
        return b0 * np.sqrt(1.0 + redshift)


class HITracer(TracerModel):
    """HI brightness-temperature tracer (tracers.py:63-164)."""

    def __init__(self, box, OmegaHI0=0.000486, bHI0=0.677105):
        super().__init__(box)
        self.OmegaHI0 = OmegaHI0
        self.bHI0 = bHI0

    def signal_amplitude(self, redshift=None, formula="powerlaw"):
        """Tb(z) in mK (tracers.py:88-126)."""
        z = self.box.redshift if redshift is None else redshift
        omegaHI = self.Omega_HI(redshift=z)
        if formula == "powerlaw":
            # Mario Santos' fit, used in Bull et al. (2015)
            return 5.5919e-02 + 2.3242e-01 * z - 2.4136e-02 * z**2
        if formula == "hall":
            E = self.box.cosmology_at(z).Ea
            return 188.0 * self.box.cosmo["h"] * omegaHI * (1.0 + z) ** 2 / E
        raise ValueError(f"No formula found with name '{formula}'")

    def bias_HI(self, redshift=None):
        """b_HI(z) fitting formula (tracers.py:129-144)."""
        z = self.box.redshift if redshift is None else redshift
        return (self.bHI0 / 0.677105) * (
            6.6655e-01 + 1.7765e-01 * z + 5.0223e-02 * z**2
        )

    def Omega_HI(self, redshift=None, formula="powerlaw"):
        """Omega_HI(z) fitting formula (tracers.py:147-163)."""
        z = self.box.redshift if redshift is None else redshift
        return (self.OmegaHI0 / 0.000486) * (
            4.8304e-04 + 3.8856e-04 * z - 6.5119e-05 * z**2
        )
