"""Diffuse power-law foregrounds (counterpart of fastbox_tpu/models/foregrounds.py:48-161).

A 2D Gaussian random field with the Santos et al. (2005) angular power
law, a wrap-mode Gaussian smoothing that matches
``scipy.ndimage.gaussian_filter(mode='wrap')``, and the two spectral-cube
builders the pipeline uses ('poly' and its 'pow' fallback).
"""
from __future__ import annotations

import numpy as np
import torch

from ..fields.gaussian import complex_dtype

__all__ = ["gaussian_smooth_wrap", "ForegroundModel"]


def _scipy_gaussian_kernel1d(sigma: float, n: int) -> np.ndarray:
    """The truncated, normalised 1-D kernel scipy.ndimage uses (truncate=4)."""
    radius = int(4.0 * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 * (x / sigma) ** 2)
    phi /= phi.sum()
    # Embed circularly into length n (wrap mode == circular convolution)
    k = np.zeros(n, dtype=np.float64)
    for xi, p in zip(x.astype(int), phi):
        k[xi % n] += p
    return k


def gaussian_smooth_wrap(field2d: torch.Tensor, sigma_pix: float):
    """Separable wrap-mode Gaussian smoothing of a 2D field.

    Circular convolution with scipy's truncated kernel, applied by FFT.
    The kernel spectra are cast to the field's complex dtype (fastbox_tpu
    keeps them complex128 when x64 is enabled).
    """
    n0, n1 = field2d.shape
    cdt = complex_dtype(field2d.dtype)
    dev = field2d.device
    k0 = torch.as_tensor(np.fft.fft(_scipy_gaussian_kernel1d(sigma_pix, n0)),
                         dtype=cdt, device=dev)
    k1 = torch.as_tensor(np.fft.fft(_scipy_gaussian_kernel1d(sigma_pix, n1)),
                         dtype=cdt, device=dev)
    fk = torch.fft.fft2(field2d)
    out = torch.fft.ifft2(fk * k0[:, None] * k1[None, :]).real
    return out.to(field2d.dtype)


class ForegroundModel:
    """Functional core of the diffuse foreground model (foregrounds.py:34-174)."""

    @staticmethod
    def foreground_amp_from_whitenoise(white2d, grid, chi, amp, beta,
                                       monopole, smoothing_sigma_pix=None):
        """Colour 2D complex white noise by the Santos+2005 C_ell power law.

        C_ell = amp (l/1000)^beta with l = 0.5 k_perp chi
        (foregrounds.py:90), normalisation ``N^4/(Lx Ly)``
        (foregrounds.py:95), zero mode removed, real part kept, monopole
        added.
        """
        rdtype = white2d.real.dtype
        kx, ky, _ = grid.kvec(rdtype, white2d.device)
        k_perp = torch.sqrt(kx[:, None] ** 2 + ky[None, :] ** 2)
        ell = 0.5 * k_perp * chi / 1000.0
        C_ell = amp * torch.where(ell > 0.0, ell, torch.ones_like(ell)) ** beta
        C_ell = torch.where(ell > 0.0, C_ell, torch.zeros_like(C_ell))
        C_ell = C_ell * (grid.N**4 / (grid.Lx * grid.Ly))
        fg_k = white2d * torch.sqrt(C_ell)
        fg_x = torch.fft.ifftn(fg_k).real + monopole
        if smoothing_sigma_pix is not None:
            fg_x = gaussian_smooth_wrap(fg_x, smoothing_sigma_pix)
        return fg_x.to(rdtype)

    @staticmethod
    def construct_cube_fn(amps, spectral_idx, freqs, freq_ref):
        """cube = amps * (nu/nu_ref)^alpha (foregrounds.py:147-174)."""
        ffac_base = freqs / freq_ref
        if spectral_idx.dim() == 0:
            ffac = ffac_base[None, None, :] ** spectral_idx
        else:
            ffac = ffac_base[None, None, :] ** spectral_idx[:, :, None]
        return amps[:, :, None] * ffac

    @staticmethod
    def construct_cube_smallalpha_fn(amps, dalpha, ffac_mean, logf):
        """cube = amps * ffac_mean(nu) * exp(dalpha * logf(nu)) for
        |dalpha * logf| << 1, with exp(u) by a cubic Taylor polynomial.

        The accurate f32 form of ``construct_cube_fn``: every large factor
        is pixel-common, and the tiny pixel-varying part carries ~1 ulp of
        rounding (fastbox_tpu/models/foregrounds.py:137-161 gives the
        truth-gate finding behind it).  Callers precompute
        ffac_mean = (nu/ref)^mean and logf = log(nu/ref) in float64.
        """
        u = dalpha[:, :, None] * logf[None, None, :]
        expu = 1.0 + u * (1.0 + u * (0.5 + u * (1.0 / 6.0)))
        return amps[:, :, None] * (ffac_mean[None, None, :] * expu)
