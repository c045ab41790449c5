"""Slab-sharded COLA engine: the multi-rank approximate N-body path.

Counterpart of ``fastbox_tpu/parallel/cola.py:52-345``.  The leading (x)
axis of the lattice-ordered particles is cut into row slabs over the
mesh's 'space' group, one per rank, and a realisation is

  * row-keyed white noise (``parallel/rng.py``): each slab draws exactly
    its own rows, so a realisation does not depend on the rank count;
  * 2LPT initial conditions from distributed half-spectrum solves
    (``parallel/fft.py``);
  * per step: the halo paint (K11a in slab mode), a distributed Poisson
    solve (one forward and one three-component inverse transform), the
    halo force gather (K11c in slab mode), and local kick, drift and COLA
    compensation arithmetic (``parallel/lattice.py``);
  * a final halo paint and CIC window deconvolution, and the CIC momentum
    averages for the velocities (the three-channel weighted paint).

The lattice form is exact while every wrapped displacement stays within
``lattice_B`` cells.  There is no scatter fallback: the returned
``max_disp`` (all-reduced MAX over 'space', kept on the device through the
step loop) lets the caller check the bound afterwards.  The step loop
reads nothing back to the host.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..cosmology import background as bg
from ..device import resolve
from ..fields.cola import _growth_scalars, _step_schedule
from ..fields.gaussian import complex_dtype
from ..grid import GridSpec
from ..ops.reduce import binned_weighted_sum_sumsq_count
from ..ops.spectra import _index_sq, default_kbins, kbin_thresholds
from .fft import pirfft3_local, prfft3_local
from .lattice import halo_gather_many, halo_paint, halo_paint_many
from .mesh import axis_group, collective, ens_share, gather_ens
from .rng import TAGS, row_normal

__all__ = ["make_sharded_cola"]


def make_sharded_cola(mesh, grid: GridSpec, cosmology, redshift=None,
                      redshift_init: float = 15.0, n_steps: int | None = None,
                      dtype=torch.float32, lattice_B: int = 3,
                      keep_velocities: bool = True,
                      pk_nbins: int | None = None, fields: bool = True,
                      ensemble: bool = False, device=None):
    """Build the slab-sharded COLA realisation for this rank of ``mesh``
    (``parallel.make_mesh``).

    Returns ``fn(seed=None, white=None) -> dict``.  ``seed`` draws this
    rank's rows of the white noise (``rng.row_normal`` with
    ``TAGS["density"]``, one R1 launch: fastbox_tpu's white field for
    ``jax.random.PRNGKey(seed)``); ``white`` instead supplies the full (N, N, N) real
    white field (a numpy array or tensor), of which each rank takes its
    rows.  The dict holds ``delta_x`` (this rank's (N/P, N, N) rows of the
    window-deconvolved density contrast), ``vel`` ((3, N/P, N, N)
    CIC-averaged peculiar velocities in km/s, with ``keep_velocities``),
    ``max_disp`` (a 0-d tensor: the largest wrapped displacement in cells
    over the evolution and the ranks, which the caller should check is
    ``<= lattice_B``) and, with ``pk_nbins``, ``k``/``pk``/``pk_err``
    (nbins-1,): the binned P(k) of the evolved field, its sums all-reduced
    over 'space'.

    Parameters mirror ``fields.cola.realise_density_cola`` without
    ``force_factor`` (the force mesh is the particle grid) and the scatter
    fallback.  ``fields=False`` (needs ``pk_nbins``) keeps only the spectra
    and ``max_disp``.

    With ``ensemble=True`` the call is ``fn(seeds=None, whites=None)`` over
    B realisations (B a multiple of the 'ens' size): this rank's 'ens'
    share runs one after another, and the outputs, stacked along a leading
    B axis, are gathered over 'ens' (``k`` is not stacked).

    ``device``: this rank's device (None: the CUDA card).
    """
    device = resolve(device)
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dtype must be float32 or float64, got {dtype}")
    if not fields:
        if pk_nbins is None:
            raise ValueError("fields=False requires pk_nbins")
        keep_velocities = False
    if not grid.Lx == grid.Ly == grid.Lz:
        raise ValueError("COLA requires a cubic box")
    dt = np.float32 if dtype == torch.float32 else np.float64
    cdtype = complex_dtype(dtype)
    params = cosmology.params
    z_final = grid.redshift if redshift is None else redshift
    if not redshift_init > z_final:
        raise ValueError("Must have redshift_init > redshift")
    a_init = 1.0 / (1.0 + redshift_init)
    a_final = 1.0 / (1.0 + z_final)
    if n_steps is None:
        n_steps = int(1 + redshift_init)

    N = grid.N
    group, nshards, s_rank = axis_group(mesh, "space")
    if N % nshards != 0:
        raise ValueError(f"N={N} must divide over space={nshards}")
    Np = N // nshards
    B = int(lattice_B)
    if Np < B + 1:
        raise ValueError(f"slab height {Np} < lattice_B+1 = {B + 1}: use "
                         "fewer ranks on 'space' or a smaller band")
    row0 = s_rank * Np
    rows = slice(row0, row0 + Np)
    cell = grid.Lx / N
    H0 = 100.0 * params.h

    def s(v) -> float:
        """A host scalar rounded to the engine's dtype."""
        return float(dt(v))

    # --- host step schedule and scalars (the single engine's), in dtype
    steps = [tuple(s(v) for v in row) for row in
             _step_schedule(params, a_init, a_final, n_steps)]
    d1_init, _, d2_init, _ = _growth_scalars(params, a_init)
    D1_f, f1_f, D2_f, f2_f = _growth_scalars(params, a_final)
    a2H = a_final**2 * H0 * float(bg.e_of_a(params, a_final))
    d1i, d2i = s(d1_init), s(d2_init)
    fac = s(1.5 * params.Omega_m * H0**2)
    pfac1, pfac2 = s(a2H * f1_f * D1_f), s(a2H * f2_f * D2_f)
    inv_af = s(1.0 / a_final)
    cell_t, half, Nf = s(cell), s(N / 2.0), s(N)

    # --- spectral constants: k vectors, the Nyquist-zeroed derivative
    # vectors, the separable CIC compensation 1/W (ops/painting.py)
    Hh = N // 2 + 1
    kf = 2.0 * np.pi * np.fft.fftfreq(N, d=1.0 / N) / grid.Lx
    nyq_full = np.zeros(N, bool)
    nyq_half = np.zeros(Hh, bool)
    if N % 2 == 0:
        nyq_full[N // 2] = True
        nyq_half[-1] = True
    k_d = np.where(nyq_full, 0.0, kf)
    with np.errstate(invalid="ignore"):
        sinc = np.sinc(kf * cell / (2.0 * np.pi))
    w1 = np.where(kf == 0.0, 1.0, sinc) ** 2

    def vec(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    kx, ky, kz = vec(kf[rows]), vec(kf), vec(kf[:Hh])
    kx_d, ky_d, kz_d = (vec(k_d[rows]), vec(k_d),
                        vec(np.where(nyq_half, 0.0, kf[:Hh])))
    k2 = (kx[:, None, None] ** 2 + ky[None, :, None] ** 2
          + kz[None, None, :] ** 2)
    inv_k2 = torch.where(k2 > 0.0, 1.0 / torch.where(k2 > 0.0, k2, 1.0), 0.0)
    compk = (vec(w1[rows])[:, None, None] * vec(w1)[None, :, None]
             * vec(w1[:Hh])[None, None, :])
    # sqrt(P_lin(k, z=0) boxfactor), P in the table's precision
    boxfactor = s(grid.boxfactor)
    pk0 = cosmology.pk_lin_z0(torch.sqrt(k2)).to(device)
    amp = torch.sqrt(torch.nan_to_num(pk0) * boxfactor)
    del pk0
    dvecs = (kx_d[:, None, None], ky_d[None, :, None], kz_d[None, None, :])

    if pk_nbins is not None:
        kbins = default_kbins(grid, pk_nbins)
        edges = np.concatenate([[0.0], kbins])
        k_out = vec(0.5 * (edges[1:] + edges[:-1])[1:])
        # exact integer-lattice classification (a cubic grid)
        thr = torch.as_tensor(kbin_thresholds(grid, kbins), device=device)
        fi2 = torch.as_tensor(_index_sq(grid), device=device)
        m_loc = (fi2[rows][:, None, None] + fi2[None, :, None]
                 + fi2[:Hh][None, None, :])
        bin_idx = torch.searchsorted(thr, m_loc.reshape(-1), right=True)
        del m_loc
        kz_weight = np.full(Hh, 2.0)
        kz_weight[0] = 1.0
        if N % 2 == 0:
            kz_weight[-1] = 1.0
        wgt = vec(kz_weight)[None, None, :].expand(Np, N, Hh).reshape(-1)

    def rfft(x):
        return prfft3_local(x[None], group)[0]

    def irfft(xk):
        """(C, Np, N, Hh) complex -> (C, Np, N, N) real."""
        return pirfft3_local(xk, N, group).to(dtype)

    def gradient(phik):
        return irfft(torch.stack([(1j * kv) * phik for kv in dvecs]))

    def wrap(x):
        return torch.remainder(x + half, Nf) - half

    def pm_force(disp, a: float):
        rho = halo_paint(disp.unbind(0), B, group)
        base = (1j * s(dt(fac) / dt(a))) * rfft(rho - 1.0) * inv_k2
        del rho
        F3 = irfft(torch.stack([base * kv for kv in dvecs]))
        return halo_gather_many(F3, disp.unbind(0), B, group)

    def white_rows(seed, white):
        if (seed is None) == (white is None):
            raise ValueError("pass a seed or the white field, not both")
        if white is None:
            return row_normal(seed, TAGS["density"], row0, Np, (N, N), dtype,
                              device)
        if not isinstance(white, torch.Tensor):
            white = torch.from_numpy(np.array(white))
        if tuple(white.shape) != (N, N, N):
            raise ValueError(f"white must be {(N, N, N)}, got "
                             f"{tuple(white.shape)}")
        return white[rows].to(device=device, dtype=dtype).contiguous()

    def one(seed=None, white=None) -> dict:
        # --- initial conditions: the row-keyed linear field and 2LPT
        white_h = rfft(white_rows(seed, white)) * s(N**-1.5)
        delta_k0 = (white_h * amp).to(cdtype)
        del white_h
        phi1_k = delta_k0 * inv_k2
        del delta_k0
        p1 = gradient(phi1_k)
        # Second derivatives phi1_ij = irfft(-k_i k_j phi1_k).  The diagonal
        # uses the raw k (k_i^2 is even under index negation, Nyquist
        # included); the cross terms the Nyquist-zeroed vectors, as one
        # factor at the self-negating Nyquist frequency makes k_i k_j odd
        # (fastbox_tpu/parallel/cola.py:191-205).
        ones = torch.ones_like(k2)
        kk = torch.stack([
            kx[:, None, None] * kx[:, None, None] * ones,
            ky[None, :, None] * ky[None, :, None] * ones,
            kz[None, None, :] * kz[None, None, :] * ones,
            dvecs[0] * dvecs[1] * ones,
            dvecs[0] * dvecs[2] * ones,
            dvecs[1] * dvecs[2] * ones,
        ])
        d = irfft(-kk * phi1_k[None])
        del kk, phi1_k
        S2 = (d[0] * d[1] - d[3] ** 2 + d[0] * d[2] - d[4] ** 2
              + d[1] * d[2] - d[5] ** 2)
        del d
        p2 = gradient(rfft(S2) * inv_k2)
        del S2

        # --- the evolution: state (3, Np, N, N), displacements in cells
        disp = wrap((d1i * p1 + d2i * p2) / cell_t)
        v = torch.zeros_like(disp)
        maxd = torch.zeros((), dtype=dtype, device=device)
        for K1, K2, Dr, D1, D2, dD1, dD2, a_f in steps:
            maxd = torch.maximum(maxd, disp.abs().max())
            F = pm_force(disp, a_f)
            comp = s(dt(fac) / dt(a_f)) * (
                D1 * p1 + s(dt(D2) - dt(D1) * dt(D1)) * p2)
            v = v + (F - comp) * s(dt(K1) + dt(K2))
            del F, comp
            disp = wrap(disp + (v * Dr + dD1 * p1 + dD2 * p2) / cell_t)
        maxd = torch.maximum(maxd, disp.abs().max())
        collective(maxd)
        dist.all_reduce(maxd, op=dist.ReduceOp.MAX, group=group)

        # --- the final paint, window deconvolution, spectra, velocities
        rho = halo_paint(disp.unbind(0), B, group)
        rk = torch.view_as_complex(torch.view_as_real(rfft(rho - 1.0))
                                   / compk[..., None])
        out = {"max_disp": maxd}
        if fields:
            out["delta_x"] = irfft(rk[None])[0]
        if pk_nbins is not None:
            p = (rk * torch.conj(rk)).real / boxfactor
            sums = torch.stack(binned_weighted_sum_sumsq_count(
                p, wgt, bin_idx, pk_nbins))
            collective(sums)
            dist.all_reduce(sums, group=group)
            total, sumsq, counts = sums
            pk_mean = total / counts
            var = torch.clamp(sumsq / counts - pk_mean**2, min=0.0)
            var = torch.where(counts > 1, var, 0.0)
            out["k"] = k_out
            out["pk"] = pk_mean[1:]
            out["pk_err"] = (torch.sqrt(var) / torch.sqrt(counts))[1:]
        del rk
        if keep_velocities:
            p_tot = v + pfac1 * p1 + pfac2 * p2
            mom = halo_paint_many(disp.unbind(0), B, group, p_tot)
            out["vel"] = torch.where(
                rho[None] > 0, mom / torch.clamp(rho, min=s(1e-10))[None],
                0.0) * inv_af
        return out

    if not ensemble:
        return one

    def many(seeds=None, whites=None) -> dict:
        given = seeds if seeds is not None else whites
        if given is None or (seeds is not None and whites is not None):
            raise ValueError("pass seeds or whites, not both")
        lo, hi = ens_share(mesh, len(given))
        outs = [one(seed=None if seeds is None else seeds[b],
                    white=None if whites is None else whites[b])
                for b in range(lo, hi)]
        res = {key: gather_ens(mesh, torch.stack([o[key] for o in outs]))
               for key in outs[0] if key != "k"}
        if pk_nbins is not None:
            res["k"] = outs[0]["k"]
        return res

    return many
