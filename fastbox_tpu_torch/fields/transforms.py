"""Stateless field transforms (counterpart of fastbox_tpu/fields/transforms.py):
the log-normal transform, the anisotropic transfer function and top-hat
smoothing in Fourier space (box.py:356-381, 441-460, 595-655).  The
Fourier-space functions compute on their input's device and, like the
reference, return the complex ``ifftn``.
"""
from __future__ import annotations

import torch

from ..grid import GridSpec
from ..ops import fft_safe

__all__ = ["lognormal", "apply_transfer_fn", "window", "window1",
           "smooth_field"]


def lognormal(delta_x: torch.Tensor) -> torch.Tensor:
    """Log-normal transform exp(d)/<exp(d)> - 1 (box.py:441-460).

    nbodykit-style normalisation; see Eq. 3.1 of arXiv:1706.09195.
    """
    d = torch.exp(delta_x)
    return d / torch.mean(d) - 1.0


def apply_transfer_fn(field_k, grid: GridSpec, transfer_fn):
    """Apply an anisotropic (k_perp, k_par) transfer function (box.py:356-381).

    ``transfer_fn(k_perp, k_par)`` modulates the Fourier-space field, NaNs
    become 0, and the result is inverse-FFTed; like the reference, the
    returned field is complex.
    """
    k_perp, k_par = grid.kperp_kpar(field_k.real.dtype, field_k.device)
    return fft_safe.ifftn(torch.nan_to_num(field_k
                                           * transfer_fn(k_perp, k_par)))


def window1(k, R):
    """FT of the top-hat window (box.py:615-633)."""
    x = torch.as_tensor(k) * R
    safe = torch.where(x != 0.0, x, 1.0)
    return (3.0 / safe**3) * (torch.sin(safe) - safe * torch.cos(safe))


def window(k, R):
    """Squared FT of the top-hat window (box.py:595-613)."""
    return window1(k, R) ** 2


def smooth_field(field_k, grid: GridSpec, R, h):
    """Top-hat smooth a Fourier-space field, R in Mpc/h (box.py:635-655);
    returns the complex real-space field (the reference's raw ``ifftn``)."""
    kmag = grid.kmag(field_k.real.dtype, field_k.device)
    return fft_safe.ifftn(torch.nan_to_num(field_k * window1(kmag, R / h)))
