"""Radiometer-equation instrumental noise.

Counterpart of ``fastbox_tpu/models/noise.py`` (``radiometer_sigma``
:19-37 copied, ``realise_radiometer_noise`` and ``NoiseModel`` :41-61).
Matches the reference's ``NoiseModel.realise_radiometer_noise``
(reference noise.py:25-75): frequency-dependent sky temperature
T_sky = 60 K (nu/300 MHz)^-2.5, the per-channel RMS from the radiometer
equation, and white noise scaled per frequency channel, drawn by
``ops.rsd.add_scaled_normal`` (K1 on the card, its twin on the CPU): from
a key, fastbox_tpu's ``jax.random.normal`` field (R1w, then K1's supplied
mode).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve
from ..ops.rsd import add_scaled_normal

__all__ = ["radiometer_sigma", "realise_radiometer_noise", "NoiseModel"]


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


def realise_radiometer_noise(generator, grid, sigma_rms,
                             dtype=torch.float32, device=None, normals=None):
    """White noise cube scaled by the per-channel sigma(nu) along the last
    axis (noise.py:73-74): ``normals * sigma`` with ``normals`` supplied
    (grid-shaped, on ``device``), or ``jax.random.normal(key, grid.shape,
    dtype)`` for a key (fastbox_tpu/models/noise.py:41-45), or drawn from a
    ``torch.Generator``."""
    device = normals.device if normals is not None else resolve(device)
    sigma = torch.as_tensor(np.asarray(sigma_rms), dtype=dtype, device=device)
    zero = torch.zeros(grid.shape, dtype=dtype, device=device)
    return add_scaled_normal(zero, sigma, generator, normals)


class NoiseModel:
    """Reference-API shim (noise.py:11-75) over a ``CosmoBox``."""

    def __init__(self, box):
        self.box = box

    def realise_radiometer_noise(self, Tinst, tp, fov, Ndish, redshift=None,
                                 normals=None):
        box = self.box
        cosmology = box.cosmology_at(redshift)
        freqs = box.grid.freq_array(cosmology)
        ang_x, _ = box.grid.pixel_array(cosmology)
        sigma = radiometer_sigma(freqs, ang_x, Tinst, tp, fov, Ndish)
        return realise_radiometer_noise(
            None if normals is not None else box.next_key(), box.grid,
            sigma, box.dtype, box.device, normals)
