"""K5/K6: binned-P(k) reductions with a floating squared-space digitize
(csrc/binned_pk.cu) and their plain twins.

Counterparts of ``fastbox_tpu/ops/pallas/binned_pk.py``:
``binned_pk_half_dual`` of ``binned_pk_half_dual_pallas`` (K5, the dual
half-spectrum reduction with in-kernel weighted counts) and
``binned_pk_full`` of ``binned_pk_pallas`` (K6, one field on the full cube,
the same body with unit weights).  The squared wavenumbers and edges are in
the fields' dtype: physical (``kx*kx``, ``bins**2``) on boxes that are not
cubes, or the exact integer lattice with edges ``thr - 0.5`` on cubes
(``ops.spectra.kbin_plan``).  Bin b holds the modes with exactly b edges
<= k2, where k2 = kx2 + (ky2 + kz2) is formed in the dtype in that order,
as the Pallas body does; bins 0 .. nbins-1 are returned.
"""
from __future__ import annotations

import math

import torch

from ..reduce import binned_sum_sumsq_count, binned_weighted_dual
from . import _build

__all__ = ["binned_pk_half_dual", "binned_pk_half_dual_cuda",
           "binned_pk_half_dual_plain", "binned_pk_full", "binned_pk_full_cuda",
           "binned_pk_full_plain", "bin_index_sq"]

NAME = "binned_pk_half_dual"
NAME_FULL = "binned_pk_full"
_MAX_BINS = 120  # as binned_pk_half_dual_pallas and binned_pk_pallas


def bin_index_sq(kx2, ky2, kz2, edges2):
    """Flat int64 bin of every (i, j, l) mode: the number of ``edges2``
    <= kx2[i] + (ky2[j] + kz2[l]), summed in the inputs' dtype."""
    kyz2 = ky2[:, None] + kz2[None, :]
    k2 = kx2[:, None, None] + kyz2[None, :, :]
    return torch.searchsorted(edges2, k2.reshape(-1), right=True)


def binned_pk_half_dual_plain(p1, p2, kx2, ky2, kz2h, wz, edges2):
    """(sum w p1, sum w p1^2, sum w p2, sum w) per bin via
    ``binned_weighted_dual`` (float64 accumulation), in p1's dtype."""
    idx = bin_index_sq(kx2, ky2, kz2h, edges2)
    w = torch.broadcast_to(wz[None, None, :], p1.shape)
    s1, q1, s2, _, cw = binned_weighted_dual(
        p1.reshape(-1), p2.reshape(-1), w.reshape(-1), idx, edges2.shape[0])
    return s1, q1, s2, cw


def binned_pk_full_plain(pk, kx2, ky2, kz2, edges2):
    """(sum p, sum p^2, count) per bin via ``binned_sum_sumsq_count``."""
    idx = bin_index_sq(kx2, ky2, kz2, edges2)
    return binned_sum_sumsq_count(pk, idx, edges2.shape[0])


def _launch_shape(n: int, nbins: int, nstats: int) -> tuple[int, int]:
    """(blocks, threads), a function of the shape only so that the
    summation order, and the result, never change between runs."""
    threads = 256
    while threads > 32 and nstats * nbins * (threads + 1) * 8 > 100 * 1024:
        threads //= 2
    blocks = min(1024, max(1, math.ceil(n / (threads * 32))))
    return blocks, threads


def _check(name, fields, vecs, edges2):
    """Shape, device and dtype checks shared by K5 and K6."""
    nbins = edges2.shape[0]
    if edges2.dim() != 1 or not 1 <= nbins <= _MAX_BINS:
        raise ValueError(f"{name}: 1..{_MAX_BINS} edges, got {tuple(edges2.shape)}")
    shape = fields[0].shape
    if fields[0].dim() != 3 or any(f.shape != shape for f in fields):
        raise ValueError(f"{name}: the fields must be 3-D and of one shape")
    if tuple(v.shape for v in vecs[:3]) != tuple((s,) for s in shape):
        raise ValueError(f"{name}: kx2, ky2, kz2 must match the field's axes "
                         f"{tuple(shape)}")
    n = math.prod(shape)
    if n >= 2**31:
        raise ValueError(f"{name}: {n} modes exceed the kernel's 2^31 limit")
    _build.require_cuda(name, *fields, *vecs, edges2, dtype=fields[0].dtype)
    return nbins, n


def _run(name, stem, nstats, ptrs, dev, dtype, shape, nbins, n):
    blocks, threads = _launch_shape(n, nbins, nstats)
    partial = torch.empty((blocks, nstats, nbins), dtype=torch.float64,
                          device=dev)
    out = torch.empty((nstats, nbins), dtype=torch.float64, device=dev)
    fn = _build.kernel_fn(stem, dtype)
    with torch.cuda.device(dev):
        err = fn(*ptrs, partial.data_ptr(), out.data_ptr(), *shape, nbins,
                 blocks, threads, _build.stream_ptr(dev))
    _build.check(err, name)
    _build.count_launch(name)
    return tuple(out.to(dtype))


def binned_pk_half_dual_cuda(p1, p2, kx2, ky2, kz2h, wz, edges2):
    """Launch K5."""
    nbins, n = _check(NAME, (p1, p2), (kx2, ky2, kz2h, wz), edges2)
    if wz.shape != kz2h.shape:
        raise ValueError(f"{NAME}: wz must have kz2h's shape")
    ptrs = [t.data_ptr() for t in (p1, p2, kx2, ky2, kz2h, wz, edges2)]
    return _run(NAME, "fbx_binned_pk_half_dual", 4, ptrs, p1.device,
                p1.dtype, p1.shape, nbins, n)


def binned_pk_full_cuda(pk, kx2, ky2, kz2, edges2):
    """Launch K6."""
    nbins, n = _check(NAME_FULL, (pk,), (kx2, ky2, kz2), edges2)
    ptrs = [t.data_ptr() for t in (pk, kx2, ky2, kz2, edges2)]
    return _run(NAME_FULL, "fbx_binned_pk_full", 3, ptrs, pk.device,
                pk.dtype, pk.shape, nbins, n)


def binned_pk_half_dual(p1, p2, kx2, ky2, kz2h, wz, edges2):
    """K5 on CUDA tensors, the plain twin on CPU tensors."""
    if p1.device.type == "cuda":
        return binned_pk_half_dual_cuda(p1, p2, kx2, ky2, kz2h, wz, edges2)
    if p1.device.type == "cpu":
        return binned_pk_half_dual_plain(p1, p2, kx2, ky2, kz2h, wz, edges2)
    raise ValueError(f"{NAME}: unsupported device {p1.device}")


def binned_pk_full(pk, kx2, ky2, kz2, edges2):
    """K6 on CUDA tensors, the plain twin on CPU tensors."""
    if pk.device.type == "cuda":
        return binned_pk_full_cuda(pk, kx2, ky2, kz2, edges2)
    if pk.device.type == "cpu":
        return binned_pk_full_plain(pk, kx2, ky2, kz2, edges2)
    raise ValueError(f"{NAME_FULL}: unsupported device {pk.device}")
