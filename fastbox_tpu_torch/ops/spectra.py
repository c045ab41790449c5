"""Power-spectrum and correlation-function estimators.

Two families, as in ``fastbox_tpu/ops/spectra.py``:

1. ``binned_power_spectrum``: the host helpers (copies of
   fastbox_tpu/ops/spectra.py:43-84, and the K5/K6 digitize plan
   ``kbin_plan``) and the reference-convention estimator with its two cores
   (:88-191); the full-grid core reduces on K6.
2. ``power_spectrum``, ``power_multipoles``, ``correlation_function`` and
   ``correlation_multipoles`` (:197-454), the replacement for nbodykit's
   ``FFTPower``/``FFTCorr``: auto and cross spectra on linear k bins,
   P(k, mu), Legendre multipoles and xi(r), on the full C2C grid as the
   single-device JAX functions compute them.  fastbox_tpu histograms with
   one-hot matmuls; here the bins are ``index_add_`` sums in float64
   (``ops/reduce.py``), divided in the input's dtype, and the transforms are
   ``torch.fft`` (cuFFT on the card).  |k| and |r| are correctly rounded
   (``grid.sqrt_rn``), so a mode that sits on a bin edge falls into the same
   bin on every device in a given dtype (``modes`` equal fastbox_tpu's in
   float32 and float64).  The functions compute on their input's device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..grid import GridSpec, sqrt_rn
from . import fft_safe
from .cuda.binned_pk import binned_pk_full
from .reduce import _binned, binned_weighted_sum_sumsq_count

__all__ = ["default_kbins", "kbin_thresholds", "kbin_plan", "hoisted_counts",
           "binned_power_spectrum", "power_spectrum", "power_multipoles",
           "correlation_function", "correlation_multipoles"]


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


# ----------------------------------------------------------------------
# nbodykit-replacement estimators
# ----------------------------------------------------------------------
def _power_3d(grid: GridSpec, delta_x, second=None):
    """Raw 3D (cross-)power Re(d1_k conj d2_k) / boxfactor on the full
    grid, and its real dtype."""
    d1k = fft_safe.fftn(delta_x)
    d2k = d1k if second is None else fft_safe.fftn(second)
    return (d1k * torch.conj(d2k)).real / grid.boxfactor, delta_x.real.dtype


def _linear_kbins(grid: GridSpec, dk=None, kmin=0.0, kmax=None):
    """nbodykit-style linear k bins: default dk = twice the fundamental
    2 pi / max(L), up to about the Nyquist scale."""
    kf = 2.0 * np.pi / max(grid.Lx, grid.Ly, grid.Lz)
    if dk is None:
        dk = 2.0 * kf
    if kmax is None:
        kmax = np.pi * grid.N / min(grid.Lx, grid.Ly, grid.Lz) + dk / 2
    return np.arange(kmin, kmax + dk, dk, dtype=np.float64)


def _norm_los(los) -> tuple[float, float, float]:
    """Normalise a line-of-sight 3-vector (nbodykit accepts any)."""
    lx, ly, lz = (float(v) for v in los)
    n = (lx * lx + ly * ly + lz * lz) ** 0.5
    if n == 0.0:
        raise ValueError("los must be a nonzero 3-vector")
    return (lx / n, ly / n, lz / n)


def _dot_los(vx, vy, vz, los, dtype, device):
    """(v . los) on the broadcast grid of three 1-D vectors, flattened; the
    normalised los is rounded to ``dtype`` first."""
    lx, ly, lz = torch.tensor(_norm_los(los), dtype=dtype, device=device)
    return (vx[:, None, None] * lx + vy[None, :, None] * ly
            + vz[None, None, :] * lz).reshape(-1)


def _cosine(dot, mag):
    """dot / mag where mag > 0, else 0."""
    pos = mag > 0.0
    return torch.where(pos, dot / torch.where(pos, mag, 1.0), 0.0)


def _mu_k(grid: GridSpec, rdtype, los, device="cpu"):
    """mu = (k . los)/|k| on the flattened full k grid (0 at k = 0)."""
    return _cosine(_dot_los(*grid.kvec(rdtype, device), los, rdtype, device),
                   grid.kmag(rdtype, device).reshape(-1))


def _bin_of(x, edges: np.ndarray, n: int):
    """Linear bin of each x among the ``n`` bins of ``edges`` (cast to x's
    dtype, searchsorted side='right'); x below the first edge or at or past
    the last goes to the dropped bin ``n``."""
    idx = torch.searchsorted(torch.as_tensor(edges, dtype=x.dtype,
                                             device=x.device), x,
                             right=True) - 1
    return torch.where((idx < 0) | (idx >= n), n, idx)


def _sums(stats, idx, n: int):
    """Per-bin float64 sums of each statistic (any real dtype); ``None``
    stands for 1, the mode count."""
    ones = torch.ones(1, dtype=torch.float64, device=idx.device) \
        .expand(idx.numel())
    return _binned([ones if t is None else t.reshape(-1).to(torch.float64)
                    for t in stats], idx, n, torch.float64)


def power_spectrum(grid: GridSpec, delta_x, second=None, dk=None,
                   kmin: float = 0.0, kmax=None, nmu: int = 1,
                   exclude_zero: bool = True, los: tuple = (0, 0, 1)):
    """Mode-averaged P(k) or P(k, mu) on linear k bins (FFTPower 1d/2d).

    Parameters:
        delta_x: real-space overdensity cube.
        second: optional second field for a cross-spectrum.
        dk, kmin, kmax: linear k-bin edges (default: twice the fundamental
            frequency up to the Nyquist scale, like nbodykit).
        nmu: number of |mu| bins on [0, 1] (mu = (k . los)/|k|).
        exclude_zero: drop the k=0 mode from the averages.
        los: line-of-sight 3-vector (default the z axis, the only one the
            reference examples use).

    Returns:
        dict with 'k_edges', 'k' (mean k per bin), 'power', 'modes' and,
        for nmu > 1, 'mu' (mean |mu|); shapes (nk,), or (nk, nmu).
    """
    p3d, rdtype = _power_3d(grid, delta_x, second)
    dev = delta_x.device
    edges = _linear_kbins(grid, dk, kmin, kmax)
    nk = edges.size - 1
    kmag = grid.kmag(rdtype, dev).reshape(-1)
    kidx = _bin_of(kmag, edges, nk)
    if exclude_zero:
        kidx = torch.where(kmag == 0.0, nk, kidx)
    stats = [p3d, kmag, None]
    if nmu > 1:
        mu = torch.abs(_mu_k(grid, rdtype, los, dev))
        muidx = torch.clamp((mu * nmu).to(torch.int64), 0, nmu - 1)
        kidx = torch.where(kidx >= nk, nk * nmu, kidx * nmu + muidx)
        stats.append(mu)
    ntot = nk * nmu
    return _power_out(edges, _sums(stats, kidx, ntot), nk, nmu, rdtype)


def _power_out(edges, sums, nk: int, nmu: int, rdtype) -> dict:
    """power_spectrum's dict from the float64 sums of (power, k, count[,
    mu]), each divided in ``rdtype`` by the count."""
    psum, ksum, count = (s.to(rdtype) for s in sums[:3])
    out = {"k_edges": torch.as_tensor(edges, dtype=rdtype,
                                      device=count.device),
           "power": psum / count, "k": ksum / count, "modes": count}
    if nmu > 1:
        out["mu"] = sums[3].to(rdtype) / count
        for key in ("power", "k", "modes", "mu"):
            out[key] = out[key].reshape(nk, nmu)
    return out


def _legendre(ell: int, mu):
    if ell == 0:
        return torch.ones_like(mu)
    if ell == 1:
        return mu
    if ell == 2:
        return 1.5 * mu**2 - 0.5
    if ell == 3:
        return 2.5 * mu**3 - 1.5 * mu
    if ell == 4:
        return (35.0 * mu**4 - 30.0 * mu**2 + 3.0) / 8.0
    raise NotImplementedError(f"Legendre ell={ell} not implemented")


def _poles_out(out: dict, prefix: str, poles, sums, count) -> dict:
    """Add (2l+1) sum_l / count under f"{prefix}_{l}" for each pole."""
    for ell, s in zip(poles, sums):
        out[f"{prefix}_{ell}"] = (2 * ell + 1) * s.to(count.dtype) / count
    return out


def power_multipoles(grid: GridSpec, delta_x, second=None, poles=(0, 2, 4),
                     dk=None, kmin: float = 0.0, kmax=None,
                     los: tuple = (0, 0, 1)):
    """Power-spectrum multipoles P_l(k) = (2l+1) <P(k) L_l(mu)> per k bin,
    k = 0 excluded; ``los`` is any 3-vector (default the z axis)."""
    p3d, rdtype = _power_3d(grid, delta_x, second)
    dev = delta_x.device
    edges = _linear_kbins(grid, dk, kmin, kmax)
    nk = edges.size - 1
    kmag = grid.kmag(rdtype, dev).reshape(-1)
    mu = _mu_k(grid, rdtype, los, dev)
    kidx = torch.where(kmag == 0.0, nk, _bin_of(kmag, edges, nk))
    p = p3d.reshape(-1)
    count, ksum, *wp = _sums([None, kmag] + [p * _legendre(ell, mu)
                                             for ell in poles], kidx, nk)
    count = count.to(rdtype)
    out = {"k_edges": torch.as_tensor(edges, dtype=rdtype, device=dev),
           "k": ksum.to(rdtype) / count, "modes": count}
    return _poles_out(out, "power", poles, wp, count)


def _rvec(grid: GridSpec, rdtype, device="cpu"):
    """Minimum-image separation vectors (rx, ry, rz) along each axis."""
    nx = np.fft.fftfreq(grid.N, 1.0) * grid.N
    return tuple(torch.as_tensor(nx * (L / grid.N), dtype=rdtype,
                                 device=device)
                 for L in (grid.Lx, grid.Ly, grid.Lz))


def _rgrid(grid: GridSpec, rdtype, device="cpu"):
    """Minimum-image |r| on the full grid for the FFT-based xi estimator,
    and the 1-D rz."""
    rx, ry, rz = _rvec(grid, rdtype, device)
    rmag = sqrt_rn(rx[:, None, None] ** 2 + ry[None, :, None] ** 2
                   + rz[None, None, :] ** 2)
    return rmag, rz


def _xi_3d(grid: GridSpec, delta_x, second):
    """xi(r) on the grid: ifftn(d1_k conj d2_k).real / N^3."""
    d1k = fft_safe.fftn(delta_x)
    d2k = d1k if second is None else fft_safe.fftn(second)
    return fft_safe.ifftn(d1k * torch.conj(d2k)).real / grid.N**3


def _rbins(grid: GridSpec, dr, rmin, rmax) -> np.ndarray:
    if rmax is None:
        rmax = 0.5 * min(grid.Lx, grid.Ly, grid.Lz)
    return np.arange(rmin, rmax + dr, dr, dtype=np.float64)


def correlation_function(grid: GridSpec, delta_x, second=None,
                         dr: float = 2.0, rmin: float = 0.0, rmax=None):
    """Two-point correlation xi(r) by inverse FFT of the 3D power (FFTCorr):
    xi(r) = ifftn(|delta_k|^2).real / N^3, binned in minimum-image |r|."""
    xi3d = _xi_3d(grid, delta_x, second)
    rdtype, dev = xi3d.dtype, xi3d.device
    edges = _rbins(grid, dr, rmin, rmax)
    nr = edges.size - 1
    rmag = _rgrid(grid, rdtype, dev)[0].reshape(-1)
    count, rsum, xsum = (s.to(rdtype) for s in _sums(
        [None, rmag, xi3d], _bin_of(rmag, edges, nr), nr))
    return {"r_edges": torch.as_tensor(edges, dtype=rdtype, device=dev),
            "r": rsum / count, "corr": xsum / count, "modes": count}


def correlation_multipoles(grid: GridSpec, delta_x, second=None,
                           poles=(0, 2, 4), dr: float = 2.0,
                           rmin: float = 0.0, rmax=None,
                           los: tuple = (0, 0, 1)):
    """Correlation-function multipoles xi_l(r) along ``los`` (default the
    z axis, as in every reference example)."""
    xi3d = _xi_3d(grid, delta_x, second)
    rdtype, dev = xi3d.dtype, xi3d.device
    edges = _rbins(grid, dr, rmin, rmax)
    nr = edges.size - 1
    rmag = _rgrid(grid, rdtype, dev)[0].reshape(-1)
    mu = _cosine(_dot_los(*_rvec(grid, rdtype, dev), los, rdtype, dev), rmag)
    x = xi3d.reshape(-1)
    count, rsum, *wx = _sums([None, rmag] + [x * _legendre(ell, mu)
                                             for ell in poles],
                             _bin_of(rmag, edges, nr), nr)
    count = count.to(rdtype)
    out = {"r_edges": torch.as_tensor(edges, dtype=rdtype, device=dev),
           "r": rsum.to(rdtype) / count, "modes": count}
    return _poles_out(out, "corr", poles, wx, count)
