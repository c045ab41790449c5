"""K10: C2C DFT along axis 0 or 1 of a planar rank-3 pair: a Stockham FFT
in shared memory (csrc/mmdft.cu) and its plain twin, the factored DFT.

Counterpart of ``fastbox_tpu/ops/pallas/mmdft.py::dft_c2c_axis_pallas``.
The kernel computes the transform by the mixed-radix plan of
``_fft_plan`` with the twiddle table of ``_fft_twiddles`` (both built
here, on the host, and tested on the CPU).  The twin keeps the TPU
kernel's algorithm: a length C = n1 * n2 transform (n1 in {2, 4}, n2 a
multiple of 128 up to 512) is, with j = j1*n2 + j2 and k = k1 + n1*k2
(decimation in time),

    A[k1, j2]     = sum_j1 x[j1*n2 + j2] W_n1^(s j1 k1)   (butterflies)
    B[k1, j2]     = A[k1, j2] * W_C^(s k1 j2)             (twiddle)
    X[k1 + n1 k2] = sum_j2 B[k1, j2] W_n2^(s j2 k2)       (stage-2 product)

with numpy's ``fft`` (s = -1) or ``ifft`` (s = +1, the 1/C folded into the
stage-2 matrix) as the reference semantics.  Complex data travels as
separate (re, im) planes.  The TPU kernel's limit of C <= 256 on axis 0
(``axis0_supported``, a VMEM budget) does not apply here: both axes take
the kernel at every supported length.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build

__all__ = ["dft_c2c_axis", "dft_c2c_axis_cuda", "dft_c2c_axis_plain",
           "supported_length"]

NAME = "dft_c2c_axis"


def _split(C: int):
    for n1 in (4, 2):
        n2, rem = divmod(C, n1)
        if rem == 0 and n2 % 128 == 0 and 128 <= n2 <= 512:
            return n1, n2
    return None


def supported_length(C: int) -> bool:
    """Lengths K10 takes: C = n1 * n2 with n1 in {4, 2} (tried in that
    order) and n2 % 128 == 0, 128 <= n2 <= 512."""
    return _split(C) is not None


@functools.lru_cache(maxsize=32)
def _consts(C: int, sign: int, inverse_scale: bool,
            dtype_name: str = "float32"):
    """Host stage constants ((n1, n2), W2 re/im (n2, n2), twiddle re/im
    (C, 1)), built in numpy float64 and rounded to ``dtype_name`` as
    fastbox_tpu/ops/pallas/mmdft.py:76-94 does; the 1/C of the inverse is
    folded into W2."""
    n1, n2 = _split(C)
    k = np.arange(n2)
    W2 = np.exp(sign * 2j * np.pi * np.outer(k, k) / n2)
    if inverse_scale:
        W2 = W2 / C
    T = np.exp(sign * 2j * np.pi
               * (np.repeat(np.arange(n1), n2) * np.tile(k, n1)) / C)
    dt = np.dtype(dtype_name)
    return ((n1, n2),
            W2.real.astype(dt), W2.imag.astype(dt),
            T.real.astype(dt).reshape(C, 1),
            T.imag.astype(dt).reshape(C, 1))


def _fft_plan(C: int):
    """(radices, E) of the kernel's Stockham passes for a supported length
    C: the radices' product is C, and each thread of the kernel holds E
    values, which every radix divides.  Powers of two take two radix-16
    passes and at most one of 2, 4 or 8 (E = 16; at 512 E = 32, the product
    of the last two radices, so the last pass runs in registers); 768 and
    1536 take 8, 8, 4 or 8 and a radix-3 pass with E = 24."""
    if C % 3 == 0:
        return (8, 8, C // 192, 3), 24
    rest = C // 256
    return ((16, 16) if rest == 1 else (16, 16, rest)), (32 if C == 512 else 16)


@functools.lru_cache(maxsize=32)
def _fft_twiddles(C: int, sign: int, dtype_name: str = "float32"):
    """(re, im) of exp(sign 2 pi i m / C), m in [0, C): the kernel's one
    twiddle table, built in numpy float64 and rounded to ``dtype_name``."""
    w = np.exp(sign * 2j * np.pi * np.arange(C) / C)
    dt = np.dtype(dtype_name)
    return w.real.astype(dt), w.imag.astype(dt)


@functools.lru_cache(maxsize=64)
def _device_twiddles(C: int, sign: int, dtype: torch.dtype,
                     device: torch.device):
    """The kernel's twiddle table on ``device``, moved once per (length,
    sign, dtype, device) and reused by every call."""
    re, im = _fft_twiddles(C, sign, str(dtype).removeprefix("torch."))
    return (torch.as_tensor(re, device=device).contiguous(),
            torch.as_tensor(im, device=device).contiguous())


@functools.lru_cache(maxsize=64)
def _device_consts(C: int, sign: int, inverse_scale: bool,
                   dtype: torch.dtype, device: torch.device):
    """The stage constants as contiguous tensors on ``device``, moved once
    per (length, sign, scale, dtype, device) and reused by every call."""
    (n1, n2), w2r, w2i, tr, ti = _consts(C, sign, inverse_scale,
                                         str(dtype).removeprefix("torch."))
    on = lambda a: torch.as_tensor(a.reshape(-1), device=device).contiguous()
    return n1, n2, on(w2r), on(w2i), on(tr), on(ti)


def _check(xr, xi, axis: int, sign: int) -> int:
    if xr.dim() != 3 or xi.shape != xr.shape:
        raise ValueError(f"{NAME}: xr and xi must be rank-3 and of one "
                         f"shape, got {tuple(xr.shape)} and {tuple(xi.shape)}")
    if xr.dtype not in (torch.float32, torch.float64) or xi.dtype != xr.dtype:
        raise TypeError(f"{NAME}: float32 or float64 planes of one dtype, "
                        f"got {xr.dtype} and {xi.dtype}")
    if axis not in (0, 1):
        raise ValueError(f"{NAME}: axis must be 0 or 1, got {axis}")
    if sign not in (-1, 1):
        raise ValueError(f"{NAME}: sign must be -1 or +1, got {sign}")
    C = xr.shape[axis]
    if not supported_length(C):
        raise ValueError(f"{NAME}: length {C} is not n1 * n2 with n1 in "
                         "{2, 4} and n2 in {128, 256, 384, 512}")
    return C


def _ocio(shape, axis: int):
    """(O, C, I): the rank-3 shape viewed with the transform axis in the
    middle."""
    A, B, M = shape
    return (1, A, B * M) if axis == 0 else (A, B, M)


def _butterfly(xs_r, xs_i, sign: int):
    """Radix-n1 DFT over the j1 blocks (fastbox_tpu/ops/pallas/mmdft.py
    :97-114)."""
    if len(xs_r) == 2:
        return ([xs_r[0] + xs_r[1], xs_r[0] - xs_r[1]],
                [xs_i[0] + xs_i[1], xs_i[0] - xs_i[1]])
    t0r, t0i = xs_r[0] + xs_r[2], xs_i[0] + xs_i[2]
    t1r, t1i = xs_r[0] - xs_r[2], xs_i[0] - xs_i[2]
    u0r, u0i = xs_r[1] + xs_r[3], xs_i[1] + xs_i[3]
    u1r, u1i = xs_r[1] - xs_r[3], xs_i[1] - xs_i[3]
    if sign < 0:        # forward: A1 = t1 - i u1, A3 = t1 + i u1
        ar = [t0r + u0r, t1r + u1i, t0r - u0r, t1r - u1i]
        ai = [t0i + u0i, t1i - u1r, t0i - u0i, t1i + u1r]
    else:               # inverse: conjugated mixing
        ar = [t0r + u0r, t1r - u1i, t0r - u0r, t1r + u1i]
        ai = [t0i + u0i, t1i + u1r, t0i - u0i, t1i - u1r]
    return ar, ai


def dft_c2c_axis_plain(xr, xi, axis: int, sign: int,
                       inverse_scale: bool = False):
    """The stages of fastbox_tpu/ops/pallas/mmdft.py:117-144 in PyTorch:
    butterflies, twiddle, then per k1 the four real products with W2 over
    the transform axis (``torch.matmul``), interleaved as out[k1 + n1 k2]."""
    C = _check(xr, xi, axis, sign)
    n1, n2, w2r, w2i, tr, ti = _device_consts(C, sign, inverse_scale,
                                              xr.dtype, xr.device)
    w2r, w2i = w2r.view(n2, n2), w2i.view(n2, n2)
    O, _, I = _ocio(xr.shape, axis)
    x_r, x_i = xr.reshape(O, C, I), xi.reshape(O, C, I)
    ar, ai = _butterfly([x_r[:, j * n2:(j + 1) * n2] for j in range(n1)],
                        [x_i[:, j * n2:(j + 1) * n2] for j in range(n1)],
                        sign)
    outs_r, outs_i = [], []
    for k1 in range(n1):
        t_r = tr[k1 * n2:(k1 + 1) * n2, None]
        t_i = ti[k1 * n2:(k1 + 1) * n2, None]
        br = ar[k1] * t_r - ai[k1] * t_i
        bi = ar[k1] * t_i + ai[k1] * t_r
        outs_r.append(torch.matmul(w2r, br) - torch.matmul(w2i, bi))
        outs_i.append(torch.matmul(w2r, bi) + torch.matmul(w2i, br))
    # out[k1 + n1*k2] = Y_k1[k2]: a k2-major stack
    yr = torch.stack(outs_r, dim=2).reshape(xr.shape)
    yi = torch.stack(outs_i, dim=2).reshape(xr.shape)
    return yr, yi


def dft_c2c_axis_cuda(xr, xi, axis: int, sign: int,
                      inverse_scale: bool = False):
    C = _check(xr, xi, axis, sign)
    _build.require_cuda(NAME, xr, xi, dtype=xr.dtype)
    twr, twi = _device_twiddles(C, sign, xr.dtype, xr.device)
    radices, E = _fft_plan(C)
    packed = sum(r << (8 * p) for p, r in enumerate(radices))
    O, _, I = _ocio(xr.shape, axis)
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xi)
    fn = _build.kernel_fn("fbx_dft_c2c_axis", xr.dtype)
    with torch.cuda.device(xr.device):
        err = fn(xr.data_ptr(), xi.data_ptr(), twr.data_ptr(),
                 twi.data_ptr(), yr.data_ptr(), yi.data_ptr(), O, C, I,
                 packed, E, int(sign), int(bool(inverse_scale)),
                 _build.stream_ptr(xr.device))
    _build.check(err, NAME)
    _build.count_launch(NAME)
    return yr, yi


def dft_c2c_axis(xr, xi, axis: int, sign: int, inverse_scale: bool = False):
    """K10 on CUDA tensors, the plain twin on CPU tensors."""
    if xr.device.type == "cuda":
        return dft_c2c_axis_cuda(xr, xi, axis, sign, inverse_scale)
    if xr.device.type == "cpu":
        return dft_c2c_axis_plain(xr, xi, axis, sign, inverse_scale)
    raise ValueError(f"{NAME}: unsupported device {xr.device}")
