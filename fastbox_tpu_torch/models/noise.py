"""Radiometer-equation instrumental noise (copy of fastbox_tpu/models/noise.py:19-37).

Matches the reference's ``NoiseModel.realise_radiometer_noise``
(reference noise.py:25-75): frequency-dependent sky temperature
T_sky = 60 K (nu/300 MHz)^-2.5 and the per-channel RMS from the
radiometer equation.  The draw itself is ``ops.rsd.add_scaled_normal``.
"""
from __future__ import annotations

import numpy as np

__all__ = ["radiometer_sigma"]


def radiometer_sigma(freqs_mhz, ang_x_deg, Tinst, tp, fov, Ndish):
    """Per-channel noise RMS sigma(nu) in mK (noise.py:53-70). Host-side numpy.

    Parameters:
        freqs_mhz: frequency channels (MHz), e.g. from GridSpec.freq_array.
        ang_x_deg: angular pixel coordinates (deg), from GridSpec.pixel_array.
        Tinst: instrument temperature in Kelvin.
        tp: integration time per pointing, hours.
        fov: field of view in deg^2.
        Ndish: number of dishes.
    """
    freqs = np.asarray(freqs_mhz, dtype=np.float64)
    dnu = np.abs(freqs[1] - freqs[0])       # MHz
    tp_sec = tp * 3600.0                     # hrs -> sec (noise.py:58)
    dtheta = ang_x_deg[1] - ang_x_deg[0]     # deg
    t_res = tp_sec * dtheta**2 / fov         # sec per resolution element
    Tsky = 60e3 * (freqs / 300.0) ** (-2.5)  # mK (noise.py:66)
    Tsys = Tinst * 1e3 + Tsky                # mK
    return Tsys / np.sqrt(Ndish * t_res * (dnu * 1e6))  # dnu in Hz (noise.py:70)
