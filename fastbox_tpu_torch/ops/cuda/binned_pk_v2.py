"""K4: dual binned-P(k) reduction with hoisted counts (csrc/binned_pk_v2.cu)
and its plain twin.

Counterpart of ``fastbox_tpu/ops/pallas/binned_pk_v2.py::
binned_pk_half_dual_pallas_v2`` (non-telescoped).  Classification is on
the exact integer lattice: ``kx2``, ``ky2``, ``kz2h`` are int32 squared
FFT indices and ``thr`` the int32 thresholds of
``ops.spectra.kbin_thresholds`` (the JAX kernel takes the same lattice as
integer-valued floats with edges ``thr - 0.5``).  Bin b holds the modes
with exactly b thresholds <= m; bins 0 .. nbins-1 are returned.
"""
from __future__ import annotations

import math

import torch

from ..reduce import binned_weighted_dual
from . import _build

__all__ = ["binned_pk_half_dual_v2", "binned_pk_half_dual_v2_cuda",
           "binned_pk_half_dual_v2_plain", "bin_index"]

NAME = "binned_pk_half_dual_v2"
_MAX_BINS = 120  # as binned_pk_half_dual_pallas_v2


def bin_index(kx2, ky2, kz2h, thr):
    """Flat int64 bin index of every (i, j, l) half-spectrum mode."""
    m = (kx2.long()[:, None, None] + ky2.long()[None, :, None]
         + kz2h.long()[None, None, :])
    return torch.searchsorted(thr.long(), m.reshape(-1), right=True)


def binned_pk_half_dual_v2_plain(p1, p2, kx2, ky2, kz2h, wz, thr):
    """(sum w p1, sum w p1^2, sum w p2) per bin via ``binned_weighted_dual``
    (float64 accumulation), in p1's dtype."""
    idx = bin_index(kx2, ky2, kz2h, thr)
    w = torch.broadcast_to(wz[None, None, :], p1.shape)
    s1, q1, s2, _, _ = binned_weighted_dual(
        p1.reshape(-1), p2.reshape(-1), w.reshape(-1), idx, thr.shape[0])
    return s1, q1, s2


def _launch_shape(n: int, nbins: int) -> tuple[int, int]:
    """(blocks, threads), a function of the shape only so that the
    summation order, and the result, never change between runs."""
    threads = 256
    while threads > 32 and 3 * nbins * (threads + 1) * 8 > 100 * 1024:
        threads //= 2
    blocks = min(1024, max(1, math.ceil(n / (threads * 32))))
    return blocks, threads


def binned_pk_half_dual_v2_cuda(p1, p2, kx2, ky2, kz2h, wz, thr):
    if p1.dim() != 3 or p2.shape != p1.shape:
        raise ValueError(f"{NAME}: p1, p2 must be (Nx, Ny, H) and equal")
    Nx, Ny, H = p1.shape
    nbins = thr.shape[0]
    if kx2.shape != (Nx,) or ky2.shape != (Ny,) or kz2h.shape != (H,) \
            or wz.shape != (H,) or thr.dim() != 1:
        raise ValueError(f"{NAME}: kx2 (Nx,), ky2 (Ny,), kz2h (H,), wz (H,), "
                         "thr (nbins,) required")
    if not 1 <= nbins <= _MAX_BINS:
        raise ValueError(f"{NAME}: 1..{_MAX_BINS} thresholds, got {nbins}")
    n = Nx * Ny * H
    if n >= 2**31:
        raise ValueError(f"{NAME}: {n} modes exceed the kernel's 2^31 limit")
    _build.require_cuda(NAME, p1, p2, wz, dtype=p1.dtype)
    _build.require_cuda(NAME, p1, kx2, ky2, kz2h, thr, dtype=None)
    for t in (kx2, ky2, kz2h, thr):
        if t.dtype != torch.int32:
            raise TypeError(f"{NAME}: index vectors and thr must be int32")
    blocks, threads = _launch_shape(n, nbins)
    partial = torch.empty((blocks, 3, nbins), dtype=torch.float64,
                          device=p1.device)
    out = torch.empty((3, nbins), dtype=torch.float64, device=p1.device)
    fn = _build.kernel_fn("fbx_binned_pk_v2", p1.dtype)
    with torch.cuda.device(p1.device):
        err = fn(p1.data_ptr(), p2.data_ptr(), kx2.data_ptr(), ky2.data_ptr(),
                 kz2h.data_ptr(), wz.data_ptr(), thr.data_ptr(),
                 partial.data_ptr(), out.data_ptr(), Nx, Ny, H, nbins, blocks,
                 threads, _build.stream_ptr(p1.device))
    _build.check(err, NAME)
    _build.count_launch(NAME)
    out = out.to(p1.dtype)
    return out[0], out[1], out[2]


def binned_pk_half_dual_v2(p1, p2, kx2, ky2, kz2h, wz, thr):
    """K4 on CUDA tensors, the plain twin on CPU tensors."""
    if p1.device.type == "cuda":
        return binned_pk_half_dual_v2_cuda(p1, p2, kx2, ky2, kz2h, wz, thr)
    if p1.device.type == "cpu":
        return binned_pk_half_dual_v2_plain(p1, p2, kx2, ky2, kz2h, wz, thr)
    raise ValueError(f"{NAME}: unsupported device {p1.device}")
