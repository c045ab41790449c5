"""The sharded ensemble step on an ('ens', 'space') mesh.

Counterpart of ``fastbox_tpu/parallel/sharded.py:63-375``: the whole
realise -> bias/lognormal -> velocity -> RSD -> foregrounds -> noise ->
beam/kpar response -> PCA clean -> binned P(k) step, one process per rank.

  * 'ens'   — data parallelism over realisations: rank e of 'ens' runs
              realisations [e B/ens, (e+1) B/ens) as one batch;
  * 'space' — slab decomposition of the leading spatial axis: each rank
              holds rows [s N/P, (s+1) N/P) of every cube, the 3D and 2D
              FFTs transpose with all-to-alls (``parallel.fft``), and every
              ``lax.psum(..., 'space')`` of fastbox_tpu is a
              ``dist.all_reduce`` over the 'space' group (the lognormal
              mean, the PCA mean and covariance, the P(k) sums, sigma_data).
              The z (LOS) axis is never sharded, so the RSD remap and the
              k_par filter stay local.

Every field is drawn with the row-keyed scheme (``parallel.rng``), so a
realisation is a function of its seed alone, and the single pipeline in
``noise_scheme='rows'`` draws the same fields.  The kernels on the card:
K8 (K3 beyond the band) in the RSD remap, K1 in supplied-normals mode for
the radiometer noise, and K4 per slab for P(k) on cubic grids (K4t with
``pallas_pk='v2t'``; K5 off them), with the per-slab sums all-reduced and
the counts hoisted.  ``pk_debias`` is subtracted from the retained cleaned
bins, as the single pipeline does.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .. import timing
from ..constants import C_MS
from ..device import resolve
from ..fields.gaussian import complex_dtype
from ..filters.pca import _work, top_eigvecs, topk_eigvecs_subspace
from ..grid import GridSpec
from ..models import noise as noise_mod
from ..models.foregrounds import _scipy_gaussian_kernel1d
from ..ops import spectra as spectra_ops
from ..ops.cuda.binned_pk import binned_pk_half_dual
from ..ops.cuda.binned_pk_v2 import binned_pk_half_dual_v2
from ..ops.reduce import binned_weighted_dual
from ..ops.rsd import add_scaled_normal, remap_los_batched
from ..pipeline import (PipelineConfig, _hi_bias, _hi_tb, _pk_debias,
                        _pk_route, amp_half_table)
from .fft import pfft2_local, pifft2_local, pirfft3_local, prfft3_local
from .mesh import axis_group, collective, ens_share, gather_ens
from .rng import TAGS, row_normal

__all__ = ["make_sharded_ensemble_step"]

OUTPUTS = ("pk_cleaned", "pk_cleaned_err", "pk_density", "sigma_data")


def make_sharded_ensemble_step(mesh, grid: GridSpec, cosmology,
                               config: PipelineConfig = PipelineConfig(),
                               device=None, amp_half=None):
    """Build the step for this rank of ``mesh`` (``parallel.make_mesh``).

    Returns ``fn(seeds=None, draws=None, clock=None) -> dict``.  ``seeds``
    is a sequence of B integer seeds (``jax.random.PRNGKey(seed)``'s
    streams, ``parallel.rng``) or a (B, 2) key tensor, B a multiple of the
    'ens' size, and each field of the batch is one R1 launch;
    ``draws`` instead gives B dicts of the full-field rows under the
    ``TAGS`` names the configuration uses (``density``, ``sigma_nl``,
    ``fg_re``, ``fg_im``, ``alpha``, ``noise``; numpy arrays or tensors),
    of which each rank takes its slab.  Every rank returns the whole
    batch: ``k`` (nbins-1,), and ``pk_cleaned``, ``pk_cleaned_err``,
    ``pk_density`` (B, nbins-1) and ``sigma_data`` (B,).  ``clock`` (a
    ``timing.StageClock``, the call's active clock) marks draw, density,
    lognormal, velocity, rsd, foregrounds, noise, instrument, pca and pk,
    and takes the call's counts (its collectives among them).

    ``device``: this rank's device (None: the CUDA card).  ``amp_half``
    (N, N, N/2+1) replaces the sqrt(P boxfactor) table built from
    ``cosmology``, as in ``make_pipeline``.
    """
    device = resolve(device)
    dtype = getattr(torch, config.dtype)
    cdtype = complex_dtype(dtype)
    N = grid.N
    H = N // 2 + 1
    space_group, P, s_rank = axis_group(mesh, "space")
    if N % P != 0:
        raise ValueError(f"N={N} must be divisible by the 'space' axis {P}")
    Np = N // P
    rows = slice(s_rank * Np, (s_rank + 1) * Np)
    row0 = s_rank * Np

    z = grid.redshift
    bias = float(config.bias if config.bias is not None else _hi_bias(z))
    Tb = float(_hi_tb(z))
    Hz = 100.0 * cosmology.h * cosmology.Ea
    vel_fac = float(100.0 * cosmology.h * cosmology.Ea
                    * cosmology.growth_rate * cosmology.scale_factor)

    def dev_tensor(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    kx, ky, kz = grid.kvec(dtype, device)
    kx_loc = kx[rows]
    kzh = kz[:H]
    if amp_half is None:
        amp_half = amp_half_table(grid, cosmology, config.linear_pk)
    if amp_half.shape != (N, N, H):
        raise ValueError(f"amp_half must be {(N, N, H)}")
    amp_loc = amp_half[rows].to(device=device, dtype=dtype).contiguous()
    # LOS velocity weight vel_fac kz / k^2, zero on the Nyquist plane
    k2 = (kx_loc[:, None, None] ** 2 + ky[None, :, None] ** 2
          + kzh[None, None, :] ** 2)
    inv_k2 = torch.where(k2 > 0.0, 1.0 / torch.where(k2 > 0.0, k2, 1.0),
                         torch.zeros_like(k2))
    vz_w = (torch.tensor(vel_fac, dtype=dtype) * kzh)[None, None, :] * inv_k2
    nyq_z = grid.nyquist_mask(2, device)[:H]
    vz_w = torch.where(nyq_z[None, None, :], torch.zeros_like(vz_w), vz_w)
    del k2, inv_k2

    zgrid = np.asarray(grid.z)
    z_t = dev_tensor(zgrid)
    z0 = float(zgrid[0])
    L_z = float(zgrid[-1] - zgrid[0])
    hz_t = torch.tensor(Hz, dtype=dtype, device=device)

    freqs = grid.freq_array(cosmology)
    ang_x, _ = grid.pixel_array(cosmology)
    dang = ang_x[1] - ang_x[0]
    sigma_c = dev_tensor(noise_mod.radiometer_sigma(
        freqs, ang_x, config.Tinst, config.tp_hours, config.fov_deg2,
        config.Ndish))

    # Foregrounds (sharded.py:124-144, :231-263): the smoothing kernels'
    # spectra, the C_ell amplitude of this slab's rows, and the spectral
    # factors in host f64
    if config.include_foregrounds:
        fg_kern = dev_tensor(np.fft.fft(_scipy_gaussian_kernel1d(
            config.fg_smoothing_deg / dang, N)), cdtype)
        al_kern = dev_tensor(np.fft.fft(_scipy_gaussian_kernel1d(
            config.spec_idx_smoothing_deg / dang, N)), cdtype)
        k_perp = torch.sqrt(kx_loc[:, None] ** 2 + ky[None, :] ** 2)
        ell = 0.5 * k_perp * cosmology.chi / 1000.0
        C_ell = torch.where(
            ell > 0, config.fg_amp * torch.where(
                ell > 0, ell, torch.ones_like(ell)) ** config.fg_beta,
            torch.zeros_like(ell)) * (N ** 4 / (grid.Lx * grid.Ly))
        sqrt_cell = torch.sqrt(C_ell)
        logf = np.log(np.asarray(freqs, np.float64) / config.freq_ref)
        use_fg_poly = (config.fg_spectral == "poly"
                       and 8.0 * config.spec_idx_std * np.abs(logf).max()
                       < 1e-2)
        ffac_mean_c = dev_tensor(np.power(np.asarray(freqs, np.float64)
                                          / config.freq_ref,
                                          config.spec_idx_mean))
        logf_c = dev_tensor(logf)
        freqs_c = dev_tensor(freqs.copy())

    # Instrument response (sharded.py:115-122, :272-282)
    beam_fac = kpar_filter = None
    if config.beam_dish_m is not None:
        lam = C_MS / (freqs * 1e6)
        fwhm = 1.22 * lam / config.beam_dish_m                  # rad
        sig2 = dev_tensor((fwhm / np.sqrt(8.0 * np.log(2.0)))
                          * cosmology.chi) ** 2
        kperp2 = kx_loc[:, None] ** 2 + ky[None, :] ** 2
        beam_fac = torch.exp(-0.5 * kperp2[:, :, None] * sig2[None, None, :])
    if config.kpar_min is not None:
        kpar_filter = 1.0 - torch.exp(-0.5 * (kzh / config.kpar_min) ** 2)

    # The bin plan of step (8), this slab's rows of it
    kz_weight = np.full(H, 2.0)
    kz_weight[0] = 1.0
    if N % 2 == 0:
        kz_weight[-1] = 1.0
    kzw_j = dev_tensor(kz_weight)
    kbins = np.asarray(spectra_ops.default_kbins(grid, config.nbins))
    nb = kbins.size
    debias = _pk_debias(config, nb, device, dtype)
    e_ = np.concatenate([[0.0], kbins])
    kcent = dev_tensor(0.5 * (e_[1:] + e_[:-1])[1:])
    thr = spectra_ops.kbin_thresholds(grid, kbins)
    pk_route = _pk_route(config.pallas_pk, thr is not None)
    hoisted = pk_route in ("v2", "v2t")
    if hoisted:
        fi2 = spectra_ops._index_sq(grid)
        fi2_j = dev_tensor(fi2, torch.int32)
        fi2_loc = fi2_j[rows].contiguous()
        fi2h_j = dev_tensor(fi2[:H], torch.int32)
        thr_j = dev_tensor(thr, torch.int32)
        cnt_j = dev_tensor(spectra_ops.hoisted_counts(grid, thr, kz_weight))
    elif pk_route == "v1":
        kx2_b, ky2_b, kz2_b, edges2_j = spectra_ops.kbin_plan(
            grid, kbins, dtype, device)
        kx2_loc = kx2_b[rows].contiguous()
        kz2h_b = kz2_b[:H].contiguous()
    else:
        bin_idx = spectra_ops._bin_index(grid, kbins, thr, H, dtype, device) \
            .reshape(N, N, H)[rows].reshape(-1)
        w_flat = torch.broadcast_to(kzw_j[None, None, :], (Np, N, H)) \
            .reshape(-1)
    boxf = torch.tensor(grid.boxfactor, dtype=dtype, device=device)

    def bin_slab(p1, p2):
        """(sum w p1, sum w p1^2, sum w p2, count) per bin over this slab;
        the count is the full cube's where it is hoisted (None).  K4t's
        differences are linear, so this slab's share of each bin sums with
        the other slabs' as K4's does."""
        if hoisted:
            return (*binned_pk_half_dual_v2(
                p1, p2, fi2_loc, fi2_j, fi2h_j, kzw_j, thr_j,
                telescoped=pk_route == "v2t"), None)
        if pk_route == "v1":
            return binned_pk_half_dual(p1, p2, kx2_loc, ky2_b, kz2h_b, kzw_j,
                                       edges2_j)
        s1, q1, s2, _, cnt = binned_weighted_dual(
            p1.reshape(-1), p2.reshape(-1), w_flat, bin_idx, nb)
        return s1, q1, s2, cnt

    def all_reduce(t):
        collective(t)
        dist.all_reduce(t, group=space_group)
        return t

    def fn(seeds=None, draws=None, clock=None) -> dict:
        with timing.active(clock) as clock:
            return step(seeds, draws, clock)

    def step(seeds, draws, clock) -> dict:
        runs = draws if draws is not None else seeds
        if runs is None:
            raise ValueError("pass the realisations' seeds or their draws")
        lo, hi = ens_share(mesh, len(runs))
        B_loc = hi - lo

        def draw(name, row_shape):
            """This slab's rows of field ``name`` for the local batch: one
            R1 launch over the batch's seeds, or the supplied draws."""
            out = torch.empty((B_loc, Np, *row_shape), dtype=dtype,
                              device=device)
            if draws is None:
                row_normal(seeds[lo:hi], TAGS[name], row0, Np, row_shape,
                           out=out)
            else:
                for j, i in enumerate(range(lo, hi)):
                    a = draws[i][name][rows]
                    out[j] = a if torch.is_tensor(a) else torch.from_numpy(
                        np.array(a))
            clock.mark("draw")
            return out

        # (1) Gaussian realisation: real white rows, one half-spectrum FFT
        white = draw("density", (N, N))
        delta_k = prfft3_local(white, space_group) * (N ** -1.5) * amp_loc
        del white
        delta_x = pirfft3_local(delta_k, N, space_group)
        clock.mark("density")

        # (2) bias + lognormal, the mean over the whole cube
        e = torch.exp(delta_x * bias)
        del delta_x
        mean_e = all_reduce(torch.sum(e, dim=(1, 2, 3))) / N ** 3
        delta_ln = e / mean_e[:, None, None, None] - 1.0
        del e
        clock.mark("lognormal")

        # (3) LOS velocity
        vz_k = torch.complex(-delta_k.imag * vz_w, delta_k.real * vz_w)
        vel = pirfft3_local(vz_k, N, space_group)
        del vz_k
        clock.mark("velocity")

        # (4) RSD remap, local along the LOS (K8, K3 beyond the band)
        if config.sigma_nl > 0.0:
            vel = vel + config.sigma_nl * draw("sigma_nl", (N, N))
        svals = z_t - vel / hz_t
        del vel
        svals = torch.remainder(svals - z0, L_z) + z0
        fill = 0.5 * (delta_ln[..., 0] + delta_ln[..., -1])
        delta_s = remap_los_batched(
            delta_ln.reshape(-1, N), svals.reshape(-1, N), z_t,
            fill.reshape(-1), method=config.rsd_method, ztarget_np=zgrid,
        ).reshape(delta_ln.shape)
        del svals, delta_ln, fill
        data = Tb * (1.0 + delta_s)
        del delta_s
        clock.mark("rsd")

        # (5) foregrounds: distributed 2D FFTs of the pixel plane
        if config.include_foregrounds:
            white2d = torch.complex(draw("fg_re", (N,)), draw("fg_im", (N,)))
            alpha_w = draw("alpha", (N,))
            fg_k = (white2d * sqrt_cell[None] * fg_kern[rows][None, :, None]
                    * fg_kern[None, None, :])
            fg_x = pifft2_local(fg_k, space_group).real \
                + config.fg_monopole
            alpha_k = pfft2_local((config.spec_idx_std * alpha_w).to(cdtype),
                                  space_group)
            dalpha = pifft2_local(alpha_k * al_kern[rows][None, :, None]
                                  * al_kern[None, None, :], space_group).real
            if use_fg_poly:
                u = dalpha[..., None] * logf_c
                expu = 1.0 + u * (1.0 + u * (0.5 + u * (1.0 / 6.0)))
                ffac = ffac_mean_c * expu
            else:
                alpha = dalpha + config.spec_idx_mean
                ffac = (freqs_c / config.freq_ref) ** alpha[..., None]
            data = data + fg_x[..., None] * ffac
            del ffac
            clock.mark("foregrounds")

        # (6) radiometer noise (K1, supplied normals)
        if config.include_noise:
            data = add_scaled_normal(data, sigma_c,
                                     normals=draw("noise", (N, N)))
            clock.mark("noise")

        # (6b) instrument response: the beam in k_perp (distributed 2D FFT),
        # the k_par high-pass (local z)
        if beam_fac is not None:
            dk2 = pfft2_local(data.to(cdtype), space_group)
            data = pifft2_local(dk2 * beam_fac, space_group).real
            del dk2
        if kpar_filter is not None:
            data = torch.fft.irfft(torch.fft.rfft(data, dim=3) * kpar_filter,
                                   n=N, dim=3)
        if beam_fac is not None or kpar_filter is not None:
            clock.mark("instrument")

        # (7) PCA clean, the mean spectrum and covariance all-reduced; a
        # float32 cube is cleaned in float64 as pca_filter cleans it, and
        # only the cleaned cube is rounded (ROADMAP C3)
        npix = N * N
        d2 = _work(data.reshape(B_loc, Np * N, N))
        mean_spec = all_reduce(torch.sum(d2, dim=1)) / npix
        x = d2 - mean_spec[:, None, :]
        cov = all_reduce(torch.matmul(x.transpose(1, 2), x)) / (npix - 1)
        if config.pca_exact:
            U = top_eigvecs(cov, config.pca_nmodes)
        else:
            U = torch.stack([topk_eigvecs_subspace(c, config.pca_nmodes)
                             for c in cov])
        fg_fit = torch.matmul(torch.matmul(x, U), U.transpose(1, 2)) \
            + mean_spec[:, None, :]
        del x
        cleaned = (d2 - fg_fit).to(dtype).reshape(B_loc, Np, N, N)
        del d2, fg_fit
        clock.mark("pca")

        # (8) binned P(k) of the cleaned cube and of the density, per slab;
        # the sums all-reduced
        ck = prfft3_local(cleaned, space_group)
        del cleaned
        p_clean = (ck.real.square() + ck.imag.square()) / boxf
        del ck
        p_dens = (delta_k.real.square() + delta_k.imag.square()) / boxf
        del delta_k
        sums, cnts = [], []
        for b in range(B_loc):
            s1, q1, s2, cnt = bin_slab(p_clean[b].contiguous(),
                                       p_dens[b].contiguous())
            sums.append(torch.stack([s1, q1, s2]))
            cnts.append(cnt)
        sums = all_reduce(torch.stack(sums))                 # (B_loc, 3, nb)
        cnt = cnt_j if hoisted else all_reduce(torch.stack(cnts))
        s1, q1, s2 = sums.unbind(1)
        pk_mean = s1 / cnt
        var = torch.clamp(q1 / cnt - pk_mean ** 2, min=0.0)
        var = torch.where(cnt > 1, var, torch.zeros_like(var))
        pk_err = torch.sqrt(var) / torch.sqrt(cnt)

        # sigma of the data cube over all N^3 voxels (ddof=0), summed in f64
        dsum = all_reduce(torch.sum(data, dim=(1, 2, 3), dtype=torch.float64))
        dsq = all_reduce(torch.sum(data.square(), dim=(1, 2, 3),
                                   dtype=torch.float64))
        dmean = dsum / N ** 3
        sigma = torch.sqrt(torch.clamp(dsq / N ** 3 - dmean ** 2, min=0.0))
        clock.mark("pk")

        pk_clean = pk_mean[:, 1:]
        if debias is not None:
            pk_clean = pk_clean - debias
        local = {"pk_cleaned": pk_clean, "pk_cleaned_err": pk_err[:, 1:],
                 "pk_density": (s2 / cnt)[:, 1:], "sigma_data": sigma.to(dtype)}
        out = {k: gather_ens(mesh, v) for k, v in local.items()}
        out["k"] = kcent
        return out

    return fn
