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
the counts hoisted.  The host constants and the bin plan are the single
pipeline's (``mock_plan.MockPlan``, on this slab's rows), so ``pk_debias``
is subtracted from the retained cleaned bins as there.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .. import timing
from ..device import resolve
from ..fields.gaussian import complex_dtype
from ..filters.pca import _work, top_eigvecs, topk_eigvecs_subspace
from ..grid import GridSpec
from ..mock_plan import MockPlan
from ..models.foregrounds import _scipy_gaussian_kernel1d
from ..ops.rsd import add_scaled_normal, remap_los_batched
from ..pipeline import PipelineConfig
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
    space_group, P, s_rank = axis_group(mesh, "space")
    if N % P != 0:
        raise ValueError(f"N={N} must be divisible by the 'space' axis {P}")
    Np = N // P
    rows = slice(s_rank * Np, (s_rank + 1) * Np)
    row0 = s_rank * Np

    plan = MockPlan(grid, cosmology, config, device, rows, amp_half)
    vz_w = plan.vz_weight()

    def dev_tensor(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    zgrid = np.asarray(grid.z)
    z_t = dev_tensor(zgrid)
    z0 = float(zgrid[0])
    L_z = float(zgrid[-1] - zgrid[0])
    hz_t = torch.tensor(plan.Hz, dtype=dtype, device=device)

    # Foregrounds (sharded.py:124-144, :231-263): the smoothing kernels'
    # spectra and the C_ell amplitude of this slab's rows
    if config.include_foregrounds:
        fg_kern = dev_tensor(np.fft.fft(_scipy_gaussian_kernel1d(
            plan.fg_sigma_pix, N)), cdtype)
        al_kern = dev_tensor(np.fft.fft(_scipy_gaussian_kernel1d(
            plan.alpha_sigma_pix, N)), cdtype)
        kx, ky, _ = plan.kvec()
        k_perp = torch.sqrt(kx[:, None] ** 2 + ky[None, :] ** 2)
        ell = 0.5 * k_perp * cosmology.chi / 1000.0
        C_ell = torch.where(
            ell > 0, config.fg_amp * torch.where(
                ell > 0, ell, torch.ones_like(ell)) ** config.fg_beta,
            torch.zeros_like(ell)) * (N ** 4 / (grid.Lx * grid.Ly))
        sqrt_cell = torch.sqrt(C_ell)

    # Instrument response (sharded.py:115-122, :272-282): the beam on the
    # full 2D FFT grid of this slab's rows
    beam_fac = plan.beam(N)

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
        delta_k = prfft3_local(white, space_group) * (N ** -1.5) \
            * plan.amp_half
        del white
        delta_x = pirfft3_local(delta_k, N, space_group)
        clock.mark("density")

        # (2) bias + lognormal, the mean over the whole cube
        e = torch.exp(delta_x * plan.bias)
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
        data = plan.Tb * (1.0 + delta_s)
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
            if plan.fg_poly:
                u = dalpha[..., None] * plan.logf
                expu = 1.0 + u * (1.0 + u * (0.5 + u * (1.0 / 6.0)))
                ffac = plan.ffac_mean * expu
            else:
                alpha = dalpha + config.spec_idx_mean
                ffac = (plan.freqs / config.freq_ref) ** alpha[..., None]
            data = data + fg_x[..., None] * ffac
            del ffac
            clock.mark("foregrounds")

        # (6) radiometer noise (K1, supplied normals)
        if config.include_noise:
            data = add_scaled_normal(data, plan.sigma,
                                     normals=draw("noise", (N, N)))
            clock.mark("noise")

        # (6b) instrument response: the beam in k_perp (distributed 2D FFT),
        # the k_par high-pass (local z)
        if beam_fac is not None:
            dk2 = pfft2_local(data.to(cdtype), space_group)
            data = pifft2_local(dk2 * beam_fac, space_group).real
            del dk2
        if plan.kpar_filter is not None:
            data = torch.fft.irfft(
                torch.fft.rfft(data, dim=3) * plan.kpar_filter, n=N, dim=3)
        if beam_fac is not None or plan.kpar_filter is not None:
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
        p_clean = (ck.real.square() + ck.imag.square()) / plan.boxfactor
        del ck
        p_dens = (delta_k.real.square() + delta_k.imag.square()) \
            / plan.boxfactor
        del delta_k
        sums, cnts = [], []
        for b in range(B_loc):
            s1, q1, s2, cnt = plan.bins.sums(p_clean[b], p_dens[b])
            sums.append(torch.stack([s1, q1, s2]))
            cnts.append(cnt)
        sums = all_reduce(torch.stack(sums))                 # (B_loc, 3, nb)
        cnt = None if plan.bins.hoisted else all_reduce(torch.stack(cnts))
        local = plan.bins.finish(*sums.unbind(1), cnt)

        # sigma of the data cube over all N^3 voxels (ddof=0), summed in f64
        dsum = all_reduce(torch.sum(data, dim=(1, 2, 3), dtype=torch.float64))
        dsq = all_reduce(torch.sum(data.square(), dim=(1, 2, 3),
                                   dtype=torch.float64))
        dmean = dsum / N ** 3
        sigma = torch.sqrt(torch.clamp(dsq / N ** 3 - dmean ** 2, min=0.0))
        clock.mark("pk")

        local["sigma_data"] = sigma.to(dtype)
        out = {k: gather_ens(mesh, v) for k, v in local.items()}
        out["k"] = plan.bins.k
        return out

    return fn
