"""Distributed spectrum estimators for slab-sharded cubes.

Counterpart of ``fastbox_tpu/parallel/spectra.py``, the analog of
nbodykit's FFTPower and FFTCorr over MPI, for cubes that live as row slabs
over the mesh's 'space' group (each rank holds rows [r N/P, (r+1) N/P) of
the leading axis) and are never gathered:

  * one distributed rfft half spectrum (``parallel/fft.prfft3_local``),
    never the full C2C grid;
  * kz-multiplicity weights w (2 for interior kz planes, 1 for kz = 0 and
    the Nyquist plane) make the half-grid sums equal to the full-grid sums
    of the single-device estimators (``ops/spectra.py``), odd Legendre
    multipoles included through the pairing rule ``L(mu) + (w - 1)
    L(mu_partner)``: an interior half-grid mode stands for the +-k pair;
  * per-bin float64 sums all-reduced over 'space'; every rank returns the
    whole result.

Each factory computes the bin indices, weights and the field-independent
sums (mode counts, mean k, mean mu) once, collectively, and returns
``fn(delta_x[, second])`` taking this rank's slab (N/P, N, N) and computing
in ``dtype``.  Ranks of one 'ens' index form one 'space' group; each group
estimates its own slabs.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve
from ..grid import GridSpec, sqrt_rn
from ..ops.spectra import (_bin_of, _cosine, _dot_los, _legendre,
                           _linear_kbins, _poles_out, _power_out, _rbins,
                           _sums)
from .fft import pirfft3_local, prfft3_local
from .mesh import axis_group, collective

__all__ = ["make_sharded_power_spectrum", "make_sharded_power_multipoles",
           "make_sharded_correlation"]


def _slab_geometry(mesh, grid: GridSpec):
    """(space group, this rank's first row, rows per slab Np, N//2 + 1)."""
    group, nshards, rank = axis_group(mesh, "space")
    N = grid.N
    if N % nshards != 0:
        raise ValueError(f"N={N} must divide over space={nshards}")
    Np = N // nshards
    return group, rank * Np, Np, N // 2 + 1


def _k_consts(grid: GridSpec):
    """1-D spectral constants (host numpy): k vectors, kz multiplicity, and
    the PARTNER-mode vectors.

    A half-grid mode with interior kz (multiplicity 2) stands for the +-k
    pair.  The partner's frequency vector negates every component, except
    on the x/y Nyquist planes, where index N/2 is its own negation (the
    fftfreq convention keeps it at -N/2), so the partner's kx/ky stay put.
    mu-dependent statistics evaluate the partner at these vectors, not at
    -k.
    """
    N = grid.N
    H = N // 2 + 1
    kx = 2.0 * np.pi * np.fft.fftfreq(N, d=1.0 / N) / grid.Lx
    ky = 2.0 * np.pi * np.fft.fftfreq(N, d=1.0 / N) / grid.Ly
    kz = (2.0 * np.pi * np.fft.fftfreq(N, d=1.0 / N) / grid.Lz)[:H].copy()
    nyq = np.zeros(N, bool)
    if N % 2 == 0:
        nyq[N // 2] = True
    kxp = np.where(nyq, kx, -kx)
    kyp = np.where(nyq, ky, -ky)
    w = np.full(H, 2.0)
    w[0] = 1.0
    if N % 2 == 0:
        w[-1] = 1.0
    return kx, ky, kz, w, kxp, kyp


def _local_kgrid(kx_np, ky_np, kz_np, dtype, row0: int, Np: int, device):
    """This slab's (kx, ky, kz) vectors and |k| (Np, N, H), as
    ``grid.kmag`` computes it."""
    kx, ky, kz = (torch.as_tensor(v, dtype=dtype, device=device)
                  for v in (kx_np[row0:row0 + Np], ky_np, kz_np))
    kmag = sqrt_rn(kx[:, None, None] ** 2 + ky[None, :, None] ** 2
                   + kz[None, None, :] ** 2)
    return kx, ky, kz, kmag


def _mu(vx, vy, vz, los, mag, dtype, device):
    """(v . los)/|v| on the slab grid, flattened (0 where |v| = 0)."""
    return _cosine(_dot_los(vx, vy, vz, los, dtype, device), mag)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    collective(t)
    dist.all_reduce(t, group=group)
    return t


def _check(fields, cross: bool, shape) -> None:
    if len(fields) != (2 if cross else 1):
        raise ValueError(f"expected {2 if cross else 1} field(s), got "
                         f"{len(fields)}")
    for f in fields:
        if tuple(f.shape) != shape:
            raise ValueError(f"expected this rank's slab {shape}, got "
                             f"{tuple(f.shape)}")


def _half_power(fields, group, boxfactor: float, dtype):
    """Re(d1_k conj d2_k)/boxfactor on the local half-spectrum slab
    (Np, N, H), flattened; one field gives the auto power."""
    d = prfft3_local(torch.stack([f.to(dtype) for f in fields]), group)
    return ((d[0] * torch.conj(d[-1])).real / boxfactor).reshape(-1)


def make_sharded_power_spectrum(mesh, grid: GridSpec, dk=None,
                                kmin: float = 0.0, kmax=None, nmu: int = 1,
                                exclude_zero: bool = True,
                                los: tuple = (0, 0, 1), cross: bool = False,
                                dtype=torch.float64, device=None):
    """Distributed P(k) / P(k, mu): ``fn(delta_x[, second]) -> dict`` with
    the keys and values of ``ops.spectra.power_spectrum`` on the gathered
    cube (equal to rounding), ``delta_x`` this rank's (N/P, N, N) slab."""
    device = resolve(device)
    group, row0, Np, H = _slab_geometry(mesh, grid)
    N = grid.N
    edges = _linear_kbins(grid, dk, kmin, kmax)
    nk = edges.size - 1
    kx_np, ky_np, kz_np, w_np, kxp_np, kyp_np = _k_consts(grid)
    kx, ky, kz, kmag = _local_kgrid(kx_np, ky_np, kz_np, dtype, row0, Np,
                                    device)
    km = kmag.reshape(-1)
    w = torch.as_tensor(w_np, dtype=dtype, device=device)[None, None, :] \
        .expand(Np, N, H).reshape(-1)
    kidx = _bin_of(km, edges, nk)
    if exclude_zero:
        kidx = torch.where(km == 0.0, nk, kidx)

    if nmu > 1:
        # each half-grid mode at its own mu, and its pair partner (weight
        # w - 1) at the partner's mu, which is not -mu on the x/y Nyquist
        # planes (_k_consts)
        def mu_bins(kxv, kyv, kzv):
            mu = torch.abs(_mu(kxv, kyv, kzv, los, km, dtype, device))
            muidx = torch.clamp((mu * nmu).to(torch.int64), 0, nmu - 1)
            return mu, torch.where(kidx >= nk, nk * nmu, kidx * nmu + muidx)

        kxp = torch.as_tensor(kxp_np[row0:row0 + Np], dtype=dtype,
                              device=device)
        kyp = torch.as_tensor(kyp_np, dtype=dtype, device=device)
        mu1, flat1 = mu_bins(kx, ky, kz)
        mu2, flat2 = mu_bins(kxp, kyp, -kz)
        ntot = nk * nmu
        wp = w - 1.0
        const = torch.stack(_sums([km, None, mu1], flat1, ntot)) \
            + torch.stack(_sums([km * wp, wp, mu2 * wp], flat2, ntot))
        del mu1, mu2

        def psum(p):
            return _sums([p], flat1, ntot)[0] + _sums([p * wp], flat2,
                                                       ntot)[0]
    else:
        const = torch.stack(_sums([km * w, w], kidx, nk))

        def psum(p):
            return _sums([p * w], kidx, nk)[0]

    ksum, count, *musum = _all_reduce(const, group).unbind(0)
    boxfactor = grid.boxfactor

    def fn(*fields):
        _check(fields, cross, (Np, N, N))
        p = _half_power(fields, group, boxfactor, dtype)
        sums = [_all_reduce(psum(p), group), ksum, count] + musum
        return _power_out(edges, sums, nk, nmu, dtype)

    return fn


def make_sharded_power_multipoles(mesh, grid: GridSpec, poles=(0, 2, 4),
                                  dk=None, kmin: float = 0.0, kmax=None,
                                  los: tuple = (0, 0, 1),
                                  cross: bool = False, dtype=torch.float64,
                                  device=None):
    """Distributed P_l(k), equal to rounding to
    ``ops.spectra.power_multipoles`` on the gathered cube.

    An interior half-grid mode carries the +-k pair, whose mu's are
    opposite (away from the x/y Nyquist planes), so its Legendre weight is
    ``L(mu) + L(mu_partner)`` (zero for odd l), while the self-conjugate kz
    planes (w = 1) keep ``L(mu)``: the rule ``L(mu) + (w - 1)
    L(mu_partner)``.
    """
    device = resolve(device)
    group, row0, Np, H = _slab_geometry(mesh, grid)
    N = grid.N
    edges = _linear_kbins(grid, dk, kmin, kmax)
    nk = edges.size - 1
    kx_np, ky_np, kz_np, w_np, kxp_np, kyp_np = _k_consts(grid)
    kx, ky, kz, kmag = _local_kgrid(kx_np, ky_np, kz_np, dtype, row0, Np,
                                    device)
    km = kmag.reshape(-1)
    w = torch.as_tensor(w_np, dtype=dtype, device=device)[None, None, :] \
        .expand(Np, N, H).reshape(-1)
    mu1 = _mu(kx, ky, kz, los, km, dtype, device)
    kxp = torch.as_tensor(kxp_np[row0:row0 + Np], dtype=dtype, device=device)
    kyp = torch.as_tensor(kyp_np, dtype=dtype, device=device)
    mu2 = _mu(kxp, kyp, -kz, los, km, dtype, device)
    kidx = torch.where(km == 0.0, nk, _bin_of(km, edges, nk))
    lw = [_legendre(ell, mu1) + (w - 1.0) * _legendre(ell, mu2)
          for ell in poles]
    del mu1, mu2
    count, ksum = _all_reduce(torch.stack(_sums([w, km * w], kidx, nk)),
                              group).to(dtype).unbind(0)
    boxfactor = grid.boxfactor

    def fn(*fields):
        _check(fields, cross, (Np, N, N))
        p = _half_power(fields, group, boxfactor, dtype)
        wp = _all_reduce(torch.stack(_sums([p * l for l in lw], kidx, nk)),
                         group)
        out = {"k_edges": torch.as_tensor(edges, dtype=dtype, device=device),
               "k": ksum / count, "modes": count}
        return _poles_out(out, "power", poles, wp, count)

    return fn


def make_sharded_correlation(mesh, grid: GridSpec, dr: float = 2.0,
                             rmin: float = 0.0, rmax=None, poles=None,
                             los: tuple = (0, 0, 1), cross: bool = False,
                             dtype=torch.float64, device=None):
    """Distributed xi(r) (and xi_l(r) with ``poles``), equal to rounding to
    ``ops.spectra.correlation_function`` / ``correlation_multipoles`` on the
    gathered cube.

    xi3d = irfft(d1_k conj d2_k)/N^3 on the slab (the product of Hermitian
    spectra is Hermitian, so the half-spectrum inverse is exact), binned by
    minimum-image |r| with the x coordinate sliced per slab.
    """
    device = resolve(device)
    group, row0, Np, H = _slab_geometry(mesh, grid)
    N = grid.N
    edges = _rbins(grid, dr, rmin, rmax)
    nr = edges.size - 1
    nidx = np.fft.fftfreq(N, 1.0) * N
    rx, ry, rz = (torch.as_tensor(v, dtype=dtype, device=device) for v in
                  ((nidx * (grid.Lx / N))[row0:row0 + Np],
                   nidx * (grid.Ly / N), nidx * (grid.Lz / N)))
    rmag = sqrt_rn(rx[:, None, None] ** 2 + ry[None, :, None] ** 2
                   + rz[None, None, :] ** 2).reshape(-1)
    ridx = _bin_of(rmag, edges, nr)
    count, rsum = _all_reduce(torch.stack(_sums([None, rmag], ridx, nr)),
                              group).to(dtype).unbind(0)
    lw = None
    if poles is not None:
        mu = _mu(rx, ry, rz, los, rmag, dtype, device)
        lw = [_legendre(ell, mu) for ell in poles]
        del mu

    def fn(*fields):
        _check(fields, cross, (Np, N, N))
        d = prfft3_local(torch.stack([f.to(dtype) for f in fields]), group)
        ph = d[0] * torch.conj(d[-1])
        x = (pirfft3_local(ph[None], N, group)[0] / N**3).reshape(-1)
        out = {"r_edges": torch.as_tensor(edges, dtype=dtype, device=device),
               "r": rsum / count, "modes": count}
        if lw is None:
            out["corr"] = _all_reduce(_sums([x], ridx, nr)[0], group) \
                .to(dtype) / count
            return out
        wx = _all_reduce(torch.stack(_sums([x * l for l in lw], ridx, nr)),
                         group)
        return _poles_out(out, "corr", poles, wx, count)

    return fn
