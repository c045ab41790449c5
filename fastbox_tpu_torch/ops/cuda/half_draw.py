"""K9: the fused colored half-spectrum draw (csrc/half_draw.cu) and its
plain twins.

Counterparts of ``fastbox_tpu/ops/pallas/half_draw.py``:
``colored_half_draw`` of ``colored_complex_normal_pallas`` (K9a) and
``colored_half_draw_vz`` of ``colored_complex_normal_vz_pallas`` (K9b).
Both take the colour amplitudes as an (R, C) array, the (N, N, N/2+1)
half grid seen as (N, N*(N/2+1)), and return complex tensors:

    delta = white * amp,  white = (n1 + i n2) * sqrt(1/2)
    vz    = delta * i * w,  w = kznum / (kx2[row] + kyz2[col])  (0 where
            the denominator is 0)

``white`` is drawn by the kernel from a seed (generated mode), or supplied
(complex, already x sqrt(1/2)).  The twins draw ``white`` with
``torch.randn`` on the caller's generator; the kernel's Philox stream
differs from it, as the TPU kernel's differs from threefry.  In supplied
mode the kernel rounds exactly like the twins.  The kernel works in units
of four consecutive columns of a row, with 16-byte accesses where
``vector_path`` holds and mode by mode otherwise; a mode's normals depend
only on its row and column, so both paths draw the same bits.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build
from .noise import draw_seed

__all__ = ["colored_half_draw", "colored_half_draw_vz",
           "colored_half_draw_cuda", "colored_half_draw_vz_cuda",
           "colored_half_draw_plain", "colored_half_draw_vz_plain",
           "vector_path", "velocity_weight"]

NAME = "colored_half_draw"
NAME_VZ = "colored_half_draw_vz"
_SQRT_HALF = float(np.sqrt(0.5))


def vector_path(C: int, *tensors) -> bool:
    """Whether K9 reads and writes in 16-byte vectors: rows of a multiple
    of 4 modes, and every array starting on a 16-byte boundary.  Else it
    takes the element path; both draw the same bits."""
    return C % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def _complex(dtype):
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def _white(amp2d, generator):
    """(n1 + i n2) sqrt(1/2) drawn with torch.randn on ``generator``."""
    kw = dict(generator=generator, dtype=amp2d.dtype, device=amp2d.device)
    re = torch.randn(amp2d.shape, **kw)
    im = torch.randn(amp2d.shape, **kw)
    return torch.complex(re, im) * _SQRT_HALF


def velocity_weight(kx2col, kyz2row, kznumrow):
    """w[r, c] = kznum[c] / (kx2[r] + kyz2[c]), 0 where that is not > 0."""
    k2 = kx2col[:, None] + kyz2row[None, :]
    pos = k2 > 0.0
    return torch.where(pos, kznumrow[None, :] / torch.where(pos, k2, 1.0),
                       torch.zeros_like(k2))


def colored_half_draw_plain(amp2d, generator=None, white=None):
    """``white * amp2d`` with ``white`` supplied or drawn from
    ``generator``; each part rounded once, as the kernel does."""
    if white is None:
        white = _white(amp2d, generator)
    return torch.complex(white.real * amp2d, white.imag * amp2d)


def colored_half_draw_vz_plain(amp2d, kx2col, kyz2row, kznumrow,
                               generator=None, white=None):
    """(delta, vz) of :func:`colored_half_draw_plain` and its velocity
    weighting ``delta * i * w``."""
    delta = colored_half_draw_plain(amp2d, generator, white)
    w = velocity_weight(kx2col, kyz2row, kznumrow)
    return delta, torch.complex(-delta.imag * w, delta.real * w)


def _launch(name, amp2d, seed, white, vecs):
    if amp2d.dim() != 2:
        raise ValueError(f"{name}: amp2d must be 2-D, got {tuple(amp2d.shape)}")
    R, C = amp2d.shape
    _build.require_cuda(name, amp2d, *vecs, dtype=amp2d.dtype)
    if white is None:
        if seed is None:
            raise ValueError(f"{name}: need a seed or the supplied white noise")
        _build.require_cuda(name, amp2d, seed)
        if seed.dtype != torch.int64 or seed.numel() != 1:
            raise TypeError(f"{name}: seed must be one int64 element")
    else:
        if white.shape != amp2d.shape:
            raise ValueError(f"{name}: white must have amp2d's shape")
        _build.require_cuda(name, amp2d, white, dtype=None)
        if white.dtype != _complex(amp2d.dtype):
            raise TypeError(f"{name}: white must be {_complex(amp2d.dtype)}")
    if vecs and (vecs[0].shape != (R,) or vecs[1].shape != (C,)
                 or vecs[2].shape != (C,)):
        raise ValueError(f"{name}: kx2col ({R},), kyz2row and kznumrow ({C},)")
    cdt = _complex(amp2d.dtype)
    delta = torch.empty((R, C), dtype=cdt, device=amp2d.device)
    vz = torch.empty((R, C), dtype=cdt, device=amp2d.device) if vecs else None
    kx2, kyz2, kznum = vecs if vecs else (None, None, None)
    vec = vector_path(C, amp2d, delta, *(t for t in (white, kyz2, kznum, vz)
                                         if t is not None))
    fn = _build.kernel_fn("fbx_half_draw", amp2d.dtype)
    with torch.cuda.device(amp2d.device):
        err = fn(amp2d.data_ptr(), _build.ptr(white),
                 _build.ptr(seed if white is None else None), _build.ptr(kx2),
                 _build.ptr(kyz2), _build.ptr(kznum), delta.data_ptr(),
                 _build.ptr(vz), R, C, int(vec),
                 _build.stream_ptr(amp2d.device))
    _build.check(err, name)
    _build.count_launch(name)
    return delta if vz is None else (delta, vz)


def colored_half_draw_cuda(amp2d, seed=None, white=None):
    """Launch K9a.  ``seed``: (1,) int64 CUDA tensor, required when
    ``white`` is None; ``white``: (R, C) complex like the result."""
    return _launch(NAME, amp2d, seed, white, ())


def colored_half_draw_vz_cuda(amp2d, kx2col, kyz2row, kznumrow, seed=None,
                              white=None):
    """Launch K9b: K9a plus the velocity spectrum, same normals."""
    return _launch(NAME_VZ, amp2d, seed, white, (kx2col, kyz2row, kznumrow))


def _seed(amp2d, generator, white):
    """The kernel's seed, drawn on the card from ``generator`` (None when
    the white noise is supplied)."""
    return draw_seed(generator, amp2d.device) if white is None else None


def _need_source(name, generator, white):
    if white is None and generator is None:
        raise ValueError(f"{name}: pass a torch.Generator or the white noise")


def colored_half_draw(amp2d, generator=None, white=None):
    """K9a on a CUDA tensor, the plain twin on a CPU tensor."""
    _need_source(NAME, generator, white)
    if amp2d.device.type == "cuda":
        return colored_half_draw_cuda(amp2d, _seed(amp2d, generator, white),
                                      white)
    if amp2d.device.type == "cpu":
        return colored_half_draw_plain(amp2d, generator, white)
    raise ValueError(f"{NAME}: unsupported device {amp2d.device}")


def colored_half_draw_vz(amp2d, kx2col, kyz2row, kznumrow, generator=None,
                         white=None):
    """K9b on a CUDA tensor, the plain twin on a CPU tensor."""
    _need_source(NAME_VZ, generator, white)
    if amp2d.device.type == "cuda":
        return colored_half_draw_vz_cuda(amp2d, kx2col, kyz2row, kznumrow,
                                         _seed(amp2d, generator, white), white)
    if amp2d.device.type == "cpu":
        return colored_half_draw_vz_plain(amp2d, kx2col, kyz2row, kznumrow,
                                          generator, white)
    raise ValueError(f"{NAME_VZ}: unsupported device {amp2d.device}")
