"""Gaussian random field draws.

Torch counterpart of ``fastbox_tpu/fields/gaussian.py``: the half-spectrum
draw of the pipeline (``_complex_normal``, ``hermitian_half_noise``,
``_herm_plane``, ``:40-102``) and the full-cube realisation the COLA engine
starts from (``white_noise``, ``hermitian_symmetrize``,
``gaussian_field_from_whitenoise``, ``realise_density``, ``:183-242``).
Every draw takes an explicit ``torch.Generator``; the streams differ from
``jax.random``, so tests hand both packages the same numbers instead.
"""
from __future__ import annotations

import numpy as np
import torch

from ..grid import GridSpec

__all__ = ["complex_dtype", "hermitian_half_noise", "white_noise",
           "hermitian_symmetrize", "gaussian_field_from_whitenoise",
           "realise_density"]


def complex_dtype(real_dtype: torch.dtype) -> torch.dtype:
    return torch.complex128 if real_dtype == torch.float64 else torch.complex64


def _complex_normal(generator: torch.Generator, shape, dtype: torch.dtype,
                    method: str = "erfinv"):
    """``re + i im`` with independent unit-normal parts.

    ``method='erfinv'`` names the fastbox_tpu stream family; here it is two
    plain normal draws.  ``'box_muller'`` is not ported yet.
    """
    if method == "box_muller":
        raise NotImplementedError(
            "draw_method='box_muller' is not ported yet (ROADMAP.md A2)")
    if method != "erfinv":
        raise ValueError(f"Unknown draw method '{method}'")
    device = generator.device
    re = torch.randn(shape, generator=generator, dtype=dtype, device=device)
    im = torch.randn(shape, generator=generator, dtype=dtype, device=device)
    return torch.complex(re, im)


def hermitian_half_noise(generator: torch.Generator, grid: GridSpec,
                         dtype: torch.dtype = torch.float32,
                         method: str = "erfinv"):
    """Complex white noise drawn directly on the rfft half-spectrum, with
    the statistics of a Hermitian-symmetrised full draw.

    Interior kz modes (0 < l < N/2) get independent CN parts of variance
    1/2; the kz=0 and (even N) kz=N/2 planes are realised as 2D Hermitian
    projections of unit-variance plane noise.  Draws happen on
    ``generator.device``.
    """
    N = grid.N
    H = N // 2 + 1
    half = _complex_normal(generator, (N, N, H), dtype, method) \
        * float(np.sqrt(0.5))
    half[:, :, 0] = _herm_plane(generator, N, dtype, method)
    if N % 2 == 0:
        half[:, :, H - 1] = _herm_plane(generator, N, dtype, method)
    return half


def _herm_plane(generator: torch.Generator, N: int, dtype: torch.dtype,
                method: str = "erfinv"):
    """(N, N) complex plane with internal 2D Hermitian pairing — the kz=0
    / kz=N/2 structure of a real cube's half-spectrum."""
    w = _complex_normal(generator, (N, N), dtype, method)
    return hermitian_symmetrize(w)


def white_noise(generator: torch.Generator, grid: GridSpec,
                dtype: torch.dtype = torch.float32):
    """Complex unit white noise (re + i im) on the full (N, N, N) cube, each
    part ~ N(0, 1) (box.py:174-176), drawn on ``generator.device``."""
    return _complex_normal(generator, grid.shape, dtype)


def hermitian_symmetrize(A):
    """Project a Fourier array onto Hermitian symmetry: (A + conj(A_-k))/2.

    fftn(Re(ifftn(A))) == hermitian_symmetrize(A), so the realisation saves
    the reference's second FFT (box.py:187-193)."""
    rev = A
    for axis in range(A.dim()):
        rev = torch.roll(torch.flip(rev, (axis,)), 1, axis)
    return 0.5 * (A + torch.conj(rev))


def gaussian_field_from_whitenoise(white, grid: GridSpec, pk_fn):
    """Colour complex white noise by a power spectrum.

    Parameters:
        white: complex (N, N, N) unit white noise.
        grid: geometry.
        pk_fn: callable k -> P(k) in Mpc^3 (a ``PowerSpectrumTable``).

    Returns:
        (delta_x, delta_k): the real-space field and its Hermitian FFT, in
        ``white``'s precision and on its device.
    """
    rdtype = white.real.dtype
    kmag = grid.kmag(rdtype, white.device)
    # in the table's precision, as fastbox_tpu does, then cast
    pk = torch.nan_to_num(pk_fn(kmag) * grid.boxfactor)
    amp = torch.sqrt(pk).to(device=white.device, dtype=rdtype)
    del kmag, pk
    delta_k = hermitian_symmetrize(white * amp).to(complex_dtype(rdtype))
    delta_x = torch.fft.ifftn(delta_k).real.to(rdtype).contiguous()
    return delta_x, delta_k


def realise_density(generator: torch.Generator, grid: GridSpec, cosmology,
                    linear: bool = False, dtype: torch.dtype = torch.float32):
    """Draw a Gaussian density field with the cosmology's P(k)
    (box.py:130-194); returns (delta_x, delta_k)."""
    pk_fn = cosmology.pk_lin if linear else cosmology.pk_nl
    return gaussian_field_from_whitenoise(white_noise(generator, grid, dtype),
                                          grid, pk_fn)
