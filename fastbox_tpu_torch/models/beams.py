"""Instrumental beam models.

Counterpart of ``fastbox_tpu/models/beams.py:47-270`` (reference
``fastbox/beams.py``).  The reference's per-channel 2D convolutions
(beams.py:63-135), a scipy ``fftconvolve`` per frequency slice and a
direct ``convolve2d`` loop, are batched FFT convolutions over the whole
cube on its device.

Beam families:
  * ``BeamModel`` — unit beam base class (beams.py:13-135).
  * ``GaussianBeamModel`` — Gaussian beam with FWHM = 1.22 lambda/D.
  * ``CosineBeamModel`` — the cosine-tapered illumination formula of
    MeerKAT's JimBeam, without the optional ``katbeam`` package.
  * ``KatBeamModel`` — JimBeam through ``katbeam`` (beams.py:139-236),
    which raises ImportError where the package is absent.
  * ``ZernikeBeamModel`` — Zernike-polynomial beam (beams.py:239-946), the
    polynomials from the closed-form radial sum for any OSA/ANSI index.

A model's cubes and values are tensors on its box's device; the angle and
frequency grids are host numpy.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import C_MS

__all__ = [
    "convolve_fft_cube",
    "convolve_wrap_cube",
    "BeamModel",
    "GaussianBeamModel",
    "CosineBeamModel",
    "KatBeamModel",
    "ZernikeBeamModel",
    "zernike_eval",
]


# ----------------------------------------------------------------------
# Convolution primitives (batched over frequency)
# ----------------------------------------------------------------------
def _beam_like(beam, field):
    return torch.as_tensor(beam).to(device=field.device, dtype=field.dtype)


def _beam_norm(beam):
    """The per-channel beam sum (the reference's normalisation)."""
    return torch.sum(beam.reshape(-1, beam.shape[-1]), dim=0)


def convolve_fft_cube(beam, field):
    """Per-channel linear FFT convolution, 'same' cropping (beams.py:63-87).

    Matches ``scipy.signal.fftconvolve(beam, field, mode='same',
    axes=[0,1])`` followed by the reference's per-channel normalisation by
    the beam sum: a zero-padded (aperiodic) convolution, cropped to the
    centre like scipy's 'same'.  The beam is cast to the field's dtype and
    device.
    """
    beam = _beam_like(beam, field)
    n0, n1, _ = field.shape
    m0, m1, _ = beam.shape
    f0, f1 = n0 + m0 - 1, n1 + m1 - 1
    Bk = torch.fft.rfft2(beam, s=(f0, f1), dim=(0, 1))
    Fk = torch.fft.rfft2(field, s=(f0, f1), dim=(0, 1))
    full = torch.fft.irfft2(Bk * Fk, s=(f0, f1), dim=(0, 1))
    s0, s1 = (f0 - n0) // 2, (f1 - n1) // 2
    out = full[s0:s0 + n0, s1:s1 + n1, :]
    return out / _beam_norm(beam)[None, None, :]


def convolve_wrap_cube(beam, field):
    """Per-channel circular convolution, matching
    ``scipy.signal.convolve2d(beam, field, mode='same', boundary='wrap')``
    per slice (beams.py:90-135), normalised by the beam sum: the FFT
    product, rolled by (N-1)//2 per axis for convolve2d's 'same' centring.
    """
    beam = _beam_like(beam, field)
    n0, n1, _ = field.shape
    Bk = torch.fft.fft2(beam, dim=(0, 1))
    Fk = torch.fft.fft2(field, dim=(0, 1))
    circ = torch.fft.ifft2(Bk * Fk, dim=(0, 1)).real
    out = torch.roll(circ, shifts=(-((n0 - 1) // 2), -((n1 - 1) // 2)),
                     dims=(0, 1))
    return out / _beam_norm(beam)[None, None, :]


# ----------------------------------------------------------------------
# Beam models
# ----------------------------------------------------------------------
class BeamModel:
    """Unit beam (beams.py:13-61)."""

    def __init__(self, box):
        self.box = box

    def _tensor(self, a):
        """A host array as a tensor on the box's device."""
        return torch.as_tensor(np.asarray(a), device=self.box.device)

    def beam_cube(self, pol=None):
        n = self.box.N
        return torch.ones((n, n, n), dtype=self.box.dtype,
                          device=self.box.device)

    def beam_value(self, x, y, freq, pol=None):
        if not x.shape == y.shape == freq.shape:
            raise ValueError("x, y, and freq arrays should have the same "
                             "shape")
        return 1.0 + 0.0 * x

    def convolve_fft(self, field_x, pol=None):
        """FFT-convolve a cube with the beam, per channel (beams.py:63-87)."""
        return convolve_fft_cube(self.beam_cube(pol=pol),
                                 torch.as_tensor(field_x))

    def convolve_real(self, field_x, pol=None, verbose=False):
        """Wrap-boundary convolution (beams.py:90-135), by FFT: the same
        operator as the reference's direct loop."""
        return convolve_wrap_cube(self.beam_cube(pol=pol),
                                  torch.as_tensor(field_x))

    def _angle_freq_mesh(self):
        ang_x, ang_y = self.box.pixel_array()
        freqs = self.box.freq_array()
        # np.meshgrid's default (xy) indexing, as the reference uses
        return np.meshgrid(ang_x, ang_y, freqs)


class GaussianBeamModel(BeamModel):
    """Gaussian beam with FWHM = 1.22 lambda / D (D in metres)."""

    def __init__(self, box, dish_diameter: float):
        super().__init__(box)
        self.D = dish_diameter

    def beam_value(self, x, y, freq, pol=None):
        lam = C_MS / (np.asarray(freq) * 1e6)
        fwhm_deg = np.degrees(1.22 * lam / self.D)
        sigma = fwhm_deg / (2.0 * np.sqrt(2.0 * np.log(2.0)))
        r2 = np.asarray(x) ** 2 + np.asarray(y) ** 2
        return torch.exp(self._tensor(-0.5 * r2 / sigma**2))

    def beam_cube(self, pol=None):
        x, y, nu = self._angle_freq_mesh()
        return self.beam_value(x, y, nu, pol=pol)


class CosineBeamModel(BeamModel):
    """Cosine-tapered-illumination beam (the JimBeam functional form).

    b(theta) = [cos(1.189 pi theta / theta_b) / (1 - 4 (1.189 theta/theta_b)^2)]^2
    with theta_b the FWHM ~ 1.22 lambda/D (Mauch et al. 2020, eq. 3).
    """

    def __init__(self, box, dish_diameter: float = 13.5):
        super().__init__(box)
        self.D = dish_diameter

    def beam_value(self, x, y, freq, pol="I"):
        lam = C_MS / (np.asarray(freq) * 1e6)
        theta_b = np.degrees(1.22 * lam / self.D)  # FWHM, deg
        r = np.sqrt(np.asarray(x) ** 2 + np.asarray(y) ** 2)
        u = self._tensor(1.189 * r / theta_b)
        num = torch.cos(math.pi * u)
        den = 1.0 - 4.0 * u**2
        den = torch.where(torch.abs(den) < 1e-7,
                          1e-7 * torch.sign(den + 1e-30), den)
        return (num / den) ** 2

    def beam_cube(self, pol="I"):
        x, y, nu = self._angle_freq_mesh()
        return self.beam_value(x, y, nu, pol=pol)


class KatBeamModel(BeamModel):
    """MeerKAT JimBeam via the optional katbeam package (beams.py:139-236)."""

    def __init__(self, box, model="L"):
        try:
            import katbeam
        except ImportError as exc:
            raise ImportError(
                "Unable to import `katbeam`; please install from "
                "https://github.com/ska-sa/katbeam"
            ) from exc
        super().__init__(box)
        self.avail_models = {"L": "MKAT-AA-L-JIM-2020",
                             "UHF": "MKAT-AA-UHF-JIM-2020"}
        if model not in self.avail_models:
            raise ValueError(
                f"model '{model}' not found. Options are: "
                f"{list(self.avail_models)}")
        self.model = model
        self.beam = katbeam.JimBeam(self.avail_models[model])

    def _eval(self, x, y, nu, pol):
        if pol not in ("I", "HH", "VV"):
            raise ValueError(f"Unknown polarisation '{pol}'")
        if pol == "HH":
            return self._tensor(self.beam.HH(x, y, nu))
        if pol == "VV":
            return self._tensor(self.beam.VV(x, y, nu))
        return self._tensor(self.beam.I(x, y, nu))

    def beam_cube(self, pol="I"):
        x, y, nu = self._angle_freq_mesh()
        return self._eval(x, y, nu, pol)

    def beam_value(self, x, y, freq, pol="I"):
        if not x.shape == y.shape == freq.shape:
            raise ValueError("x, y, and freq arrays should have the same "
                             "shape")
        return self._eval(x, y, freq, pol)


# ----------------------------------------------------------------------
# Zernike polynomials (closed form, any index)
# ----------------------------------------------------------------------
def _osa_to_nm(j: int):
    """OSA/ANSI single index -> (n, m)."""
    n = int((-3 + math.sqrt(9 + 8 * j)) // 2)
    m = 2 * j - n * (n + 2)
    return n, m


def zernike_eval(coeffs, x, y):
    """Sum of Zernike polynomials on the unit disc (OSA/ANSI ordering).

    Replaces the reference's hand-unrolled 66-term table
    (beams.py:308-946) with the closed-form radial sum
    R_n^|m|(rho) = sum_k (-1)^k (n-k)! / (k! ((n+|m|)/2-k)! ((n-|m|)/2-k)!)
    rho^(n-2k).  Points outside the unit disc evaluate to 0.  ``x`` and
    ``y`` are tensors (on their device) or host arrays.
    """
    x = torch.as_tensor(x)
    y = torch.as_tensor(y, device=x.device)
    rho = torch.sqrt(x**2 + y**2)
    theta = torch.atan2(y, x)
    out = torch.zeros_like(rho)
    for j, c in enumerate(np.atleast_1d(coeffs)):
        if c == 0.0:
            continue
        n, m = _osa_to_nm(j)
        am = abs(m)
        R = torch.zeros_like(rho)
        for k in range((n - am) // 2 + 1):
            coef = ((-1) ** k * math.factorial(n - k)
                    / (math.factorial(k)
                       * math.factorial((n + am) // 2 - k)
                       * math.factorial((n - am) // 2 - k)))
            R = R + coef * rho ** (n - 2 * k)
        if m > 0:
            Z = R * torch.cos(am * theta)
        elif m < 0:
            Z = R * torch.sin(am * theta)
        else:
            Z = R
        out = out + float(c) * Z
    return torch.where(rho <= 1.0, out, 0.0)


class ZernikeBeamModel(BeamModel):
    """Zernike-expansion beam (beams.py:239-946).  ``pol`` is accepted and
    ignored, as in fastbox_tpu (the reference reads an undefined ``pol``)."""

    def __init__(self, box, coeffs):
        super().__init__(box)
        self.coeffs = np.asarray(coeffs, dtype=np.float64)

    def beam_value(self, x, y, freq=None, pol=None):
        xcos = torch.sin(self._tensor(x) * math.pi / 180.0)
        ycos = torch.sin(self._tensor(y) * math.pi / 180.0)
        return self.zernike(self.coeffs, xcos, ycos)

    def beam_cube(self, pol=None):
        x, y, nu = self._angle_freq_mesh()
        return self.beam_value(x, y, nu, pol=pol)

    def zernike(self, coeffs, x, y):
        return zernike_eval(coeffs, x, y)
