"""P(k) binning helpers (host numpy; copies of fastbox_tpu/ops/spectra.py:43-84)."""
from __future__ import annotations

import numpy as np

from ..grid import GridSpec

__all__ = ["default_kbins", "kbin_thresholds", "hoisted_counts"]


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
