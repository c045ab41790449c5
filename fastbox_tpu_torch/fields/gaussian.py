"""Gaussian random field draws on the rfft half-spectrum.

Torch counterpart of ``fastbox_tpu/fields/gaussian.py:40-102``
(``_complex_normal``, ``hermitian_half_noise``, ``_herm_plane``).  Every
draw takes an explicit ``torch.Generator``; the streams differ from
``jax.random``, so tests hand both packages the same numbers instead.
"""
from __future__ import annotations

import numpy as np
import torch

from ..grid import GridSpec

__all__ = ["complex_dtype", "hermitian_half_noise"]


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
    rev = w
    for axis in (0, 1):
        rev = torch.roll(torch.flip(rev, (axis,)), 1, axis)
    return 0.5 * (w + torch.conj(rev))
