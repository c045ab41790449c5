"""The rank-3 cube R2C/C2R facade: ``torch.fft``, or the K10 route.

Counterpart of ``fastbox_tpu/ops/fft_safe.py``'s ``rfftn``/``irfftn`` for
rank-3 cubes only.  The card has no broken native transform to probe for
(fastbox_tpu probes the TPU's C2R, which is wrong at 256^3 and 512^3), so
there is no probe and no ``matmul_only``: the route is fastbox_tpu's
``PREFER_MM = True`` with ``FASTBOX_PALLAS_DFT=1``, and both directions
take K10 (``ops/mmfft.py``) when

  * ``mmfft.PALLAS_DFT`` is set (``FASTBOX_PALLAS_DFT=1`` at import, or the
    attribute set at run time),
  * the real dtype is float32,
  * K10 takes the axis-1 length (``mmdft.supported_length``).

Otherwise the call is ``torch.fft.rfftn``/``irfftn``, unchanged.  The
rank-3 C2C pair ``fftn``/``ifftn`` of the estimators is ``torch.fft``
(cuFFT on the card) always.  On CPU
tensors the route runs with K10's plain twin (fastbox_tpu ignores the flag
on its CPU backend; the port does not, so that the tests can drive it).
"""
from __future__ import annotations

import torch

from . import mmfft
from .cuda import mmdft

__all__ = ["rfftn", "irfftn", "fftn", "ifftn"]


def _routed(shape, real_dtype) -> bool:
    return (mmfft.PALLAS_DFT and real_dtype == torch.float32
            and mmdft.supported_length(int(shape[1])))


def rfftn(x):
    """``torch.fft.rfftn(x)`` of a real rank-3 cube."""
    if x.dim() != 3:
        raise ValueError(f"fft_safe.rfftn: rank-3 cubes only, got "
                         f"{tuple(x.shape)}")
    if _routed(x.shape, x.dtype):
        return mmfft.rfftn3(x)
    return torch.fft.rfftn(x)


def irfftn(a, s):
    """``torch.fft.irfftn(a, s=s)`` of a rank-3 half spectrum."""
    s = tuple(int(v) for v in s)
    if a.dim() != 3 or len(s) != 3:
        raise ValueError(f"fft_safe.irfftn: rank-3 cubes only, got "
                         f"{tuple(a.shape)} and s={s}")
    if _routed(s, a.real.dtype):
        return mmfft.irfftn3(a, s)
    return torch.fft.irfftn(a, s=s)


def _rank3(name: str, x) -> None:
    if x.dim() != 3:
        raise ValueError(f"fft_safe.{name}: rank-3 cubes only, got "
                         f"{tuple(x.shape)}")


def fftn(x):
    """``torch.fft.fftn(x)`` of a rank-3 cube (real or complex)."""
    _rank3("fftn", x)
    return torch.fft.fftn(x)


def ifftn(x):
    """``torch.fft.ifftn(x)`` of a rank-3 cube."""
    _rank3("ifftn", x)
    return torch.fft.ifftn(x)
