"""The factored-DFT route of the rank-3 cube R2C/C2R transforms (K10).

Counterpart of the ``FASTBOX_PALLAS_DFT`` branch of
``fastbox_tpu/ops/mmfft.py`` (``rfftn_any``/``irfftn_any`` at :451-455 and
:479-485, reached through ``rfftn3``/``irfftn3``), and nothing more of
that file.  For a float32 cube (A, B, M):

  forward  the last axis as two real-matrix products into the half-spectrum
           planes (cr, ci), then K10 along axis 0 and axis 1, then
           ``torch.complex``;
  inverse  the (re, im) planes, K10 inverse (1/C folded in) along axes 0
           and 1, then ``ar @ Er - ai @ Ei`` (the last axis and the
           Hermitian fold in one real product).

An axis-0 length that K10 does not take runs as a dense planar product
(``_dense_w_planar``), as in fastbox_tpu; an axis-1 length it does not take
raises.  That is a rule on shapes, never a retry after a failed launch.

The route is opt-in: ``PALLAS_DFT`` is read from ``FASTBOX_PALLAS_DFT=1`` at
import and may be set afterwards; ``ops/fft_safe.py`` decides per call.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch

from .cuda import mmdft

__all__ = ["PALLAS_DFT", "rfftn3", "irfftn3"]

PALLAS_DFT = os.environ.get("FASTBOX_PALLAS_DFT", "0") == "1"


@functools.lru_cache(maxsize=32)
def _c2r_mats(n: int):
    """Real float32 matrices (Er, Ei) of shape (H, n) for the last-axis C2R
    stage: y[x] = Er.T @ Re(c) - Ei.T @ Im(c), the Hermitian tail folded
    into the mode multiplicities m = [1, 2, ..., 2, (1|2)]
    (fastbox_tpu/ops/mmfft.py:402-416)."""
    H = n // 2 + 1
    m = np.full(H, 2.0)
    m[0] = 1.0
    if n % 2 == 0:
        m[-1] = 1.0
    ph = 2.0 * np.pi * np.outer(np.arange(H), np.arange(n)) / n
    Er = (m[:, None] * np.cos(ph)) / n
    Ei = (m[:, None] * np.sin(ph)) / n
    return Er.astype(np.float32), Ei.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _r2c_mats(n: int):
    """Real float32 matrices (Cr, Ci) of shape (n, H) for the last-axis R2C
    stage: c[k] = x @ Cr + i (x @ Ci) (fastbox_tpu/ops/mmfft.py:419-426)."""
    H = n // 2 + 1
    ph = 2.0 * np.pi * np.outer(np.arange(n), np.arange(H)) / n
    return np.cos(ph).astype(np.float32), (-np.sin(ph)).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _dense_w_planar(n: int, sign: int, inverse_scale: bool):
    """Dense (n, n) DFT matrix as a float32 (cos, sin) pair
    (fastbox_tpu/ops/mmfft.py:171-177)."""
    ph = sign * 2.0 * np.pi * np.outer(np.arange(n), np.arange(n)) / n
    scale = (1.0 / n) if inverse_scale else 1.0
    return ((np.cos(ph) * scale).astype(np.float32),
            (np.sin(ph) * scale).astype(np.float32))


@functools.lru_cache(maxsize=64)
def _on_device(kind: str, args: tuple, device: torch.device):
    """A pair of host tables as tensors on ``device``, moved once."""
    make = {"r2c": _r2c_mats, "c2r": _c2r_mats,
            "dense": _dense_w_planar}[kind]
    return tuple(torch.as_tensor(a, device=device) for a in make(*args))


def _dft_pair_leading(cr, ci, ax: int, sign: int, inverse_scale: bool):
    """One leading-axis C2C DFT of a planar pair: K10 where it takes the
    length, else (axis 0 only) four dense "kj,jab->kab" products."""
    C = cr.shape[ax]
    if mmdft.supported_length(C):
        return mmdft.dft_c2c_axis(cr, ci, ax, sign, inverse_scale)
    if ax != 0:
        raise ValueError(f"mmfft: K10 does not take axis-{ax} length {C}")
    wr, wi = _on_device("dense", (C, sign, inverse_scale), cr.device)
    shape = cr.shape
    cr2, ci2 = cr.reshape(C, -1), ci.reshape(C, -1)
    yr = torch.matmul(wr, cr2) - torch.matmul(wi, ci2)
    yi = torch.matmul(wr, ci2) + torch.matmul(wi, cr2)
    return yr.reshape(shape), yi.reshape(shape)


def rfftn3(x):
    """``torch.fft.rfftn(x)`` of a float32 cube on the K10 route."""
    if x.dim() != 3:
        raise ValueError(f"rfftn3: a rank-3 cube is required, got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"rfftn3: the K10 route takes float32, got {x.dtype}")
    Cr, Ci = _on_device("r2c", (x.shape[-1],), x.device)
    cr = torch.matmul(x, Cr)
    ci = torch.matmul(x, Ci)
    for ax in (0, 1):
        cr, ci = _dft_pair_leading(cr, ci, ax, -1, False)
    return torch.complex(cr, ci)


def irfftn3(a, s):
    """``torch.fft.irfftn(a, s=s)`` of a complex64 half spectrum
    (s[0], s[1], s[2] // 2 + 1) on the K10 route."""
    s = tuple(int(v) for v in s)
    if a.dim() != 3 or len(s) != 3:
        raise ValueError(f"irfftn3: a rank-3 half spectrum and len(s) == 3 "
                         f"are required, got {tuple(a.shape)} and {s}")
    if a.dtype != torch.complex64:
        raise TypeError(f"irfftn3: the K10 route takes complex64, got "
                        f"{a.dtype}")
    if tuple(a.shape) != (s[0], s[1], s[2] // 2 + 1):
        raise ValueError(f"irfftn3: shape {tuple(a.shape)} is not the half "
                         f"spectrum of {s}")
    ar, ai = a.real.contiguous(), a.imag.contiguous()
    for ax in (0, 1):
        ar, ai = _dft_pair_leading(ar, ai, ax, +1, True)
    Er, Ei = _on_device("c2r", (s[2],), a.device)
    return torch.matmul(ar, Er) - torch.matmul(ai, Ei)
