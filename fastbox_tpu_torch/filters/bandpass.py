"""Angular bandpass and band-power PCA filters (counterpart of
fastbox_tpu/filters/bandpass.py).

Reference: ``angular_bandpass_filter`` (filters.py:58-90) and
``bandpower_pca_filter`` (filters.py:435-491, whose missing import is a
reference bug; this is the intended behaviour).  The transverse transforms
are ``torch.fft.fftn``/``ifftn`` over dims (0, 1).  ``bandpower_pca_filter``
cleans a float32 cube in float64, as ``pca_filter`` does.
"""
from __future__ import annotations

import numpy as np
import torch

from .pca import _work, mean_spectrum_filter, pca_filter

__all__ = ["angular_bandpass_filter", "bandpower_pca_filter"]


def _kperp_fftfreq(n0: int, n1: int, d: float):
    """|k_perp| grid in fft.fftfreq units (filters.py:84-87 convention)."""
    kx = np.fft.fftfreq(n0, d=d)
    ky = np.fft.fftfreq(n1, d=d)
    # Reference meshgrid(kx, kx) uses xy indexing; k is symmetric in (x, y)
    return np.sqrt(kx[:, None] ** 2 + ky[None, :] ** 2)


def angular_bandpass_filter(field, kmin: float, kmax: float, d: float = 1.0):
    """Top-hat |k_perp| bandpass per frequency slice (filters.py:58-90).

    Wavenumbers are in ``fft.fftfreq`` units with pixel width ``d``; modes
    with k_perp outside [kmin, kmax) are zeroed.  Returns the complex
    inverse transform, as the reference does.
    """
    field_k = torch.fft.fftn(field, dim=(0, 1))
    k = _kperp_fftfreq(field.shape[0], field.shape[1], d)
    keep = torch.as_tensor((k >= kmin) & (k < kmax), device=field.device)
    return torch.fft.ifftn(field_k * keep[:, :, None], dim=(0, 1))


def bandpower_pca_filter(field, nbands: int, modes):
    """Per-sub-band PCA cleaning (filters.py:435-491, intended behaviour).

    The |k_perp| range [min k, max k] is split into ``nbands`` contiguous
    bands, each half-open, so the corner modes at exactly max k fall in
    none; each bandpassed cube is PCA-cleaned with its own mode count and
    the results are summed.
    """
    if isinstance(modes, (int, np.integer)):
        modes = modes * np.ones(nbands, dtype=int)
    if nbands != len(modes):
        raise ValueError("len(modes) must equal nbands")

    k = _kperp_fftfreq(field.shape[0], field.shape[1], 1.0)
    band_edges = np.linspace(np.min(k), np.max(k), nbands + 1)

    x = mean_spectrum_filter(_work(field))
    cleaned = torch.zeros_like(x)
    for i in range(nbands):
        bpf = angular_bandpass_filter(x, kmin=band_edges[i],
                                      kmax=band_edges[i + 1]).real
        cleaned = cleaned + pca_filter(bpf, nmodes=int(modes[i]))
    return cleaned.to(field.dtype)
