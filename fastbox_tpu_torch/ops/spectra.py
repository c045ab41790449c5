"""P(k) binning: the host helpers (copies of fastbox_tpu/ops/spectra.py:43-84,
and the K5/K6 digitize plan ``kbin_plan``) and the reference-convention
estimator ``binned_power_spectrum`` with its two cores
(fastbox_tpu/ops/spectra.py:88-191); the full-grid core reduces on K6."""
from __future__ import annotations

import numpy as np
import torch

from ..grid import GridSpec
from . import fft_safe
from .cuda.binned_pk import binned_pk_full
from .reduce import binned_weighted_sum_sumsq_count

__all__ = ["default_kbins", "kbin_thresholds", "kbin_plan", "hoisted_counts",
           "binned_power_spectrum"]


def default_kbins(grid: GridSpec, nbins: int = 20) -> np.ndarray:
    """Log-spaced bin edges on [kmin, kmax] (box.py:749)."""
    return np.logspace(np.log10(grid.kmin), np.log10(grid.kmax), nbins)


def kbin_thresholds(grid: GridSpec, bins) -> np.ndarray | None:
    """Integer-lattice bin-classification thresholds for cubic grids.

    On a cubic grid every mode's |k| is ``kappa*sqrt(m)`` with
    ``kappa = 2 pi / L`` and ``m = i^2 + j^2 + l^2`` an exact integer, so
    the digitize test ``bins[b] <= |k|`` is exactly ``T_b <= m`` with
    ``T_b = ceil((bins[b]/kappa)^2)`` computed in f64 on the host (a
    1e-12 relative inclusion tolerance classifies an edge within f64
    rounding of a lattice value into the bin it bounds).  The binning is
    then exact and identical across dtypes, devices and kernels; see
    fastbox_tpu/ops/spectra.py:48-79 for why it exists.

    Returns None for anisotropic boxes (no common integer lattice).
    """
    if not (grid.Lx == grid.Ly == grid.Lz):
        return None
    kappa = 2.0 * np.pi / grid.Lx
    E = (np.asarray(bins, np.float64) / kappa) ** 2
    return np.ceil(E * (1.0 - 1e-12)).astype(np.int32)


def kbin_plan(grid: GridSpec, bins, dtype: torch.dtype, device="cpu"):
    """The squared-space digitize operands (kx2, ky2, kz2, edges2) of the
    K5/K6 reductions, in ``dtype`` (fastbox_tpu/pipeline.py:363-372,
    :418-421).

    On a cubic grid: the squared integer FFT indices and the edges
    ``kbin_thresholds - 0.5``, which classify exactly as the integer
    lattice does.  Otherwise the floating plan: ``k*k`` of ``grid.kvec``
    in ``dtype`` per axis, and the physical edges squared in float64 and
    then cast.  kz2 covers the full axis; a half spectrum takes its first
    N/2+1 entries.
    """
    thr = kbin_thresholds(grid, bins)
    if thr is not None:
        fi2 = torch.as_tensor(_index_sq(grid), dtype=dtype, device=device)
        edges2 = thr.astype(np.float64) - 0.5
        return fi2, fi2, fi2, torch.as_tensor(edges2, dtype=dtype,
                                              device=device)
    kx, ky, kz = grid.kvec(dtype, device)
    edges2 = np.asarray(bins, np.float64) ** 2
    return kx * kx, ky * ky, kz * kz, torch.as_tensor(edges2, dtype=dtype,
                                                      device=device)


def _index_sq(grid: GridSpec) -> np.ndarray:
    """Squared integer FFT indices (host, exact)."""
    fi = np.asarray(grid.fft_index, np.int64)
    return (fi * fi).astype(np.int32)


def hoisted_counts(grid: GridSpec, thr: np.ndarray,
                   kz_weight: np.ndarray) -> np.ndarray:
    """Weighted mode count of each of the ``thr.size`` bins on the
    half-spectrum lattice, exact in float64 (fastbox_tpu/pipeline.py:402-412).
    One (N, H) plane at a time keeps the host memory at O(N^2)."""
    N = grid.N
    H = N // 2 + 1
    nb = thr.size
    fi2 = _index_sq(grid).astype(np.int64)
    w_plane = np.broadcast_to(kz_weight[None, :], (N, H)).ravel()
    cnt = np.zeros(nb + 1, np.float64)
    for i in range(N):
        m = fi2[i] + fi2[:, None] + fi2[:H][None, :]
        idx = np.searchsorted(thr, m.ravel(), side="right")
        cnt += np.bincount(idx, weights=w_plane, minlength=nb + 1)[:nb + 1]
    return cnt[:nb]


def _finish(sums, sumsqs, counts):
    vals = sums / counts  # count == 0 -> NaN, matching mean-of-empty
    var = torch.clamp(sumsqs / counts - vals**2, min=0.0)
    # a single-element bin has exactly zero std
    var = torch.where(counts > 1, var, torch.zeros_like(var))
    return vals, torch.sqrt(var) / torch.sqrt(counts)


def _bin_index(grid: GridSpec, bins, thr, nz: int, dtype, device):
    """Bin of every mode of an (N, N, nz) spectrum: integer-lattice
    thresholds when ``thr`` is given, else floating |k| against ``bins``."""
    if thr is not None:
        fi2 = torch.as_tensor(_index_sq(grid), device=device)
        m = fi2[:, None, None] + fi2[None, :, None] + fi2[:nz][None, None, :]
        return torch.searchsorted(torch.as_tensor(thr, device=device),
                                  m.reshape(-1).contiguous(), right=True)
    kx, ky, kz = grid.kvec(dtype, device)
    kmag = torch.sqrt(kx[:, None, None] ** 2 + ky[None, :, None] ** 2
                      + kz[:nz][None, None, :] ** 2)
    return torch.searchsorted(torch.as_tensor(bins, dtype=dtype, device=device),
                              kmag.reshape(-1).contiguous(), right=True)


def _binned_pk_half_core(grid: GridSpec, delta_x, bins, thr=None):
    """One rank-3 R2C plus a kz-multiplicity-weighted histogram: interior
    kz planes count twice, the kz=0 and Nyquist planes once, which equals
    the full-grid sums exactly."""
    rdtype = delta_x.dtype
    N = grid.N
    H = N // 2 + 1
    half = fft_safe.rfftn(delta_x)
    pk = (half * torch.conj(half)).real / grid.boxfactor
    idx = _bin_index(grid, bins, thr, H, rdtype, delta_x.device)
    w = np.full(H, 2.0)
    w[0] = 1.0
    if N % 2 == 0:
        w[-1] = 1.0
    wf = torch.as_tensor(w, dtype=rdtype,
                         device=delta_x.device)[None, None, :].expand(pk.shape)
    return _finish(*binned_weighted_sum_sumsq_count(pk, wf, idx, len(bins)))


def _binned_pk_core(grid: GridSpec, delta_k, bins):
    """The full-grid (sum, sumsq, count) on K6 (the twin on the CPU), with
    K6's squared-space digitize: the exact lattice on cubic grids, squared
    physical wavenumbers elsewhere (where fastbox_tpu's XLA core compares
    |k|; the two agree unless a mode sits within rounding of an edge)."""
    rdtype = delta_k.real.dtype
    pk = ((delta_k * torch.conj(delta_k)).real / grid.boxfactor).contiguous()
    kx2, ky2, kz2, edges2 = kbin_plan(grid, bins, rdtype, delta_k.device)
    return _finish(*binned_pk_full(pk, kx2, ky2, kz2, edges2))


def binned_power_spectrum(grid: GridSpec, delta_k=None, delta_x=None,
                          nbins: int = 20, kbins=None):
    """Binned 1D P(k) with the reference's binning semantics (box.py:696-768):
    ``|delta_k|^2 / boxfactor``, ``digitize`` against ``nbins`` log-spaced
    edges (exact integer-lattice classification on cubic grids), midpoint
    bin centres, per-bin mean and ``std/sqrt(N)``, the first (sub-kmin) bin
    dropped, NaN for empty bins.  ``delta_x`` takes the half-spectrum core,
    ``delta_k`` (the full spectrum) the full-grid one.

    Returns:
        (kc, pk, sigma_pk), each of length ``len(kbins) - 1``.
    """
    if delta_x is not None and delta_k is not None:
        raise ValueError("delta_x and delta_k specified; can only specify one")
    bins = np.asarray(kbins if kbins is not None
                      else default_kbins(grid, nbins), dtype=np.float64)
    _bins = np.concatenate([[0.0], bins])
    cent = 0.5 * (_bins[1:] + _bins[:-1])
    thr = kbin_thresholds(grid, bins)
    if delta_k is None:
        ref = delta_x
        vals, stddev = _binned_pk_half_core(grid, delta_x, bins, thr)
    else:
        ref = delta_k.real
        vals, stddev = _binned_pk_core(grid, delta_k, bins)
    # the first value holds the k < kmin modes (k=0 included): dropped
    kc = torch.as_tensor(cent[1:], dtype=ref.dtype, device=ref.device)
    return kc, vals[1:], stddev[1:]
