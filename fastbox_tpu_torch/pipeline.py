"""The end-to-end 21cm mock pipeline in PyTorch.

Counterpart of ``fastbox_tpu/pipeline.py`` (``PipelineConfig``,
``_build_pipeline``, ``make_pipeline``) on its default path: f32,
``noise_scheme='half'``, ``rsd_method='linear'``, ``fg_spectral='poly'``,
exact PCA, 20 bins, cubic grid.  The stages:

  1. Gaussian density realisation on the rfft half-spectrum x sqrt(P)
  2. HI bias scaling and log-normal transform
  3. linear LOS velocity from the Gaussian delta_k
  4. redshift-space remap, after the sigma_NL dispersion      (K1, K2 | K3)
  5. brightness-temperature scaling Tb (1 + delta_s)
  6. diffuse foreground cube (2D GRF amplitude x spectral-index law)
  7. radiometer noise                                          (K1)
  8. PCA foreground clean (FP32 GEMMs, eigh)
  9. binned P(k) of the cleaned cube and of the density       (K4)

The host set-up (cosmology, instrument scalars, sqrt(P) on the half grid,
the exact integer-lattice bin plan and its counts) runs once in
``make_pipeline``; the returned function runs stages 1-9 on ``device``.

Random draws.  ``jax.random`` streams cannot be reproduced in torch, so
the pipeline function takes an optional ``draws`` dict with the five
arrays fastbox_tpu's ``fn_pre`` draws from its five keys
(fastbox_tpu/pipeline.py:492), under the names of those keys:

  ``dens``  (N, N, N/2+1) complex half-spectrum white noise (:517-521)
  ``rsd``   (N, N, N) sigma_NL velocity normals              (:570-571)
  ``fg``    (N, N) complex foreground white noise            (:594-598)
  ``alpha`` (N, N) spectral-index white noise                (:599-600)
  ``noise`` (N, N, N) radiometer normals                     (:630-631)

This is the port's counterpart of fastbox_tpu's ``threefry_noise`` and
``draw_dtype`` truth-gate knobs.  Without ``draws`` the function draws
them itself from the ``torch.Generator`` it is given; the two normal
draws then happen inside K1 on a GPU.

Precision.  The TPU-only knobs ``mm3d_precision``, ``vel_precision``,
``dx_precision``, ``fwd_precision`` and ``pca_precision`` select MXU pass
counts and have no meaning on cuFFT or a FP32 GEMM: they are accepted and
ignored.  The port always computes in full FP32 (TF32 off, PyTorch's
default), or in float64 for a float64 config.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .cosmology import Cosmology
from .fields import gaussian, transforms
from .filters import pca_filter
from .grid import GridSpec
from .models import noise as noise_mod
from .models.foregrounds import ForegroundModel, gaussian_smooth_wrap
from .ops import rsd as rsd_ops
from .ops import spectra as spectra_ops
from .ops.cuda.binned_pk_v2 import binned_pk_half_dual_v2

__all__ = ["PipelineConfig", "make_pipeline", "draw_inputs", "amp_half_table",
           "make_chained_pipeline", "make_ensemble_pipeline"]

DRAW_NAMES = ("dens", "rsd", "fg", "alpha", "noise")

# Knobs whose non-default values select parts of fastbox_tpu's pipeline
# that are not ported yet: field -> (default, ROADMAP.md item).
_UNPORTED = {
    "noise_scheme": ("half", "A2g: the row-keyed 'rows' draw"),
    "pallas_draw": ("off", "B9: colored_complex_normal_pallas"),
    "fft_pair": (False, "A (do-not-port list): matmul DFT pair"),
    "eigh_hoist": ("off", "A2g: make_chained_pipeline"),
    "pca_exact": (True, "A5: pca_filter_subspace"),
    "draw_method": ("erfinv", "A2g: the box_muller draw"),
    "pk_debias": (None, "A2g: pk_debias"),
    "beam_dish_m": (None, "A2g: the instrument response"),
    "kpar_min": (None, "A2g: the instrument response"),
    "rsd_method": ("linear", "A3: method='nearest'"),
    "threefry_noise": (False, "pass the pipeline function `draws` instead"),
    "draw_dtype": (None, "pass the pipeline function `draws` instead"),
}


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static configuration of the end-to-end mock pipeline.

    The fields and defaults are fastbox_tpu's (example_endtoend.py's
    parameter choices); the docstrings there explain each.  A non-default
    value of a knob whose path is not ported raises NotImplementedError;
    the precision knobs are accepted and have no effect (module docstring).
    """

    # Signal
    linear_pk: bool = False
    bias: float | None = None        # None -> HI bias fit at box redshift
    sigma_nl: float = 120.0          # km/s (example_endtoend.py:44)
    rsd_method: str = "linear"
    # Foregrounds (example_endtoend.py:59-68)
    fg_amp: float = 57.0
    fg_beta: float = 1.1
    fg_monopole: float = 10.0
    fg_smoothing_deg: float = 4.0
    spec_idx_mean: float = 2.07
    spec_idx_std: float = 2e-4
    spec_idx_smoothing_deg: float = 15.0
    freq_ref: float = 130.0
    # Noise (example_endtoend.py:82-84)
    Tinst: float = 18.0              # K
    tp_hours: float = 2.0
    fov_deg2: float = 1.0
    Ndish: int = 64
    # Instrument response (not ported)
    beam_dish_m: float | None = None
    kpar_min: float | None = None
    # Cleaning + estimation
    pca_nmodes: int = 4
    pca_exact: bool = True
    nbins: int = 20
    include_foregrounds: bool = True
    include_noise: bool = True
    dtype: str = "float32"
    noise_scheme: str = "half"
    fft_pair: bool = False
    # TPU-only precision knobs: accepted, no effect
    mm3d_precision: str | None = "HIGH"
    vel_precision: str | None = "HIGH"
    dx_precision: str | None = None
    fwd_precision: str | None = None
    pca_precision: str | None = "HIGH"
    # Truth-gate knobs: the port takes `draws` instead
    draw_dtype: str | None = None
    threefry_noise: bool = False
    # 'auto' and 'v2' take the K4 kernel on a GPU (the plain twin on CPU)
    pallas_pk: str = "auto"
    pallas_draw: str = "off"
    fg_spectral: str = "poly"
    debug_stages: bool = False
    eigh_hoist: str = "off"
    draw_method: str = "erfinv"
    pk_debias: tuple | None = None

    def __post_init__(self):
        if self.eigh_hoist not in ("auto", "on", "off"):
            raise ValueError(f"Unknown eigh_hoist '{self.eigh_hoist}'")
        if self.pallas_pk not in ("auto", "on", "off", "v2", "v2t"):
            raise ValueError(f"Unknown pallas_pk '{self.pallas_pk}'")
        if self.fg_spectral not in ("poly", "pow"):
            raise ValueError(f"Unknown fg_spectral '{self.fg_spectral}'")
        if self.dtype not in ("float32", "float64"):
            raise ValueError(f"Unknown dtype '{self.dtype}'")
        for name, (default, item) in _UNPORTED.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r} is not ported "
                    f"(ROADMAP.md {item})")
        if self.pallas_pk not in ("auto", "v2"):
            raise NotImplementedError(
                f"pallas_pk={self.pallas_pk!r} is not ported: the port bins "
                "with the v2 kernel K4 ('auto' or 'v2'); ROADMAP.md B4/B5")


def _hi_bias(z):
    """Bull et al. (2015) b_HI(z) fit (reference tracers.py:129-144)."""
    return 6.6655e-01 + 1.7765e-01 * z + 5.0223e-02 * z**2


def _hi_tb(z):
    """Tb(z) power-law fit in mK (reference tracers.py:115-117)."""
    return 5.5919e-02 + 2.3242e-01 * z - 2.4136e-02 * z**2


class _NoClock:
    def mark(self, stage: str) -> None:
        pass


def draw_inputs(grid: GridSpec, generator: torch.Generator,
                dtype=torch.float32) -> dict:
    """The five ``draws`` arrays, drawn on ``generator.device`` in the
    order the pipeline function consumes them."""
    N = grid.N
    dev = generator.device
    out = {"dens": gaussian.hermitian_half_noise(generator, grid, dtype)}
    out["rsd"] = torch.randn(grid.shape, generator=generator, dtype=dtype,
                             device=dev)
    out["fg"] = gaussian._complex_normal(generator, (N, N), dtype)
    out["alpha"] = torch.randn((N, N), generator=generator, dtype=dtype,
                               device=dev)
    out["noise"] = torch.randn(grid.shape, generator=generator, dtype=dtype,
                               device=dev)
    return out


def amp_half_table(grid: GridSpec, cosmology: Cosmology,
                   linear_pk: bool = False) -> torch.Tensor:
    """sqrt(P(k) boxfactor) on the rfft half grid, tabulated once at build
    time in the P(k) tables' dtype and device
    (fastbox_tpu/pipeline.py:334-340)."""
    pk_fn = cosmology.pk_lin if linear_pk else cosmology.pk_nl
    H = grid.N // 2 + 1
    kx, ky, kz = grid.kvec(pk_fn.lnk.dtype, pk_fn.lnk.device)
    kmag = torch.sqrt(kx[:, None, None] ** 2 + ky[None, :, None] ** 2
                      + kz[:H][None, None, :] ** 2)
    pk = torch.nan_to_num(pk_fn(kmag))
    return torch.sqrt(pk * torch.tensor(grid.boxfactor, dtype=pk.dtype,
                                        device=pk.device))


def make_pipeline(grid: GridSpec, cosmology: Cosmology,
                  config: PipelineConfig = PipelineConfig(), device="cpu",
                  amp_half: torch.Tensor | None = None):
    """Build the pipeline: host set-up now, stages 1-9 in the returned
    ``fn(generator=None, draws=None, clock=None) -> dict``.

    ``amp_half`` (N, N, N/2+1) replaces the sqrt(P boxfactor) table built
    from ``cosmology`` (e.g. fastbox_tpu's own, via
    ``convert.from_jax_state``).  ``clock`` is a ``timing.StageClock``.
    The output dict has fastbox_tpu's keys: ``k``, ``pk_cleaned``,
    ``pk_cleaned_err``, ``pk_density``, ``sigma_data``, and with
    ``debug_stages`` the intermediate cubes.  ``vel_z`` there includes the
    sigma_NL dispersion, as on fastbox_tpu's ``threefry_noise`` path.
    """
    if not grid.is_cubic:
        raise NotImplementedError(
            "non-cubic grids bin with the v1 kernel binned_pk_half_dual_pallas "
            "on the TPU, which is not ported yet (ROADMAP.md B5)")
    device = torch.device(device)
    dtype = getattr(torch, config.dtype)
    N = grid.N
    H = N // 2 + 1
    z = grid.redshift
    bias = float(config.bias if config.bias is not None else _hi_bias(z))
    Tb = float(_hi_tb(z))
    Hz = 100.0 * cosmology.h * cosmology.Ea
    vel_fac = float(100.0 * cosmology.h * cosmology.Ea
                    * cosmology.growth_rate * cosmology.scale_factor)

    def dev_tensor(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    # Host-side instrument constants
    freqs = grid.freq_array(cosmology)
    ang_x, _ = grid.pixel_array(cosmology)
    dang = ang_x[1] - ang_x[0]
    fg_sigma_pix = config.fg_smoothing_deg / dang
    alpha_sigma_pix = config.spec_idx_smoothing_deg / dang
    sigma_j = dev_tensor(noise_mod.radiometer_sigma(
        freqs, ang_x, config.Tinst, config.tp_hours, config.fov_deg2,
        config.Ndish))
    freqs_j = dev_tensor(freqs.copy())
    # Foreground spectral factors in f64 on the host; the poly path needs
    # |dalpha * logf| << 1 (fastbox_tpu/pipeline.py:303-316).
    logf = np.log(np.asarray(freqs, np.float64) / config.freq_ref)
    use_fg_poly = (config.fg_spectral == "poly"
                   and 8.0 * config.spec_idx_std * np.abs(logf).max() < 1e-2)
    ffac_mean_j = dev_tensor(np.power(np.asarray(freqs, np.float64)
                                      / config.freq_ref, config.spec_idx_mean))
    logf_j = dev_tensor(logf)

    if amp_half is None:
        amp_half = amp_half_table(grid, cosmology, config.linear_pk)
    if amp_half.shape != (N, N, H):
        raise ValueError(f"amp_half must be {(N, N, H)}")
    amp_half = amp_half.to(device=device, dtype=dtype).contiguous()

    # LOS velocity weight vel_fac * kz / k^2 on the half grid, zero on the
    # Nyquist plane (fastbox_tpu/pipeline.py:526-533)
    kxv, kyv, kzv = grid.kvec(dtype, device)
    kz_half = kzv[:H]
    k2 = (kxv[:, None, None] ** 2 + kyv[None, :, None] ** 2
          + kz_half[None, None, :] ** 2)
    inv_k2 = torch.where(k2 > 0.0, 1.0 / torch.where(k2 > 0.0, k2, 1.0),
                         torch.zeros_like(k2))
    vz_w = (torch.tensor(vel_fac, dtype=dtype) * kz_half)[None, None, :] \
        * inv_k2
    nyq_z = grid.nyquist_mask(2, device)[:H]
    vz_w = torch.where(nyq_z[None, None, :], torch.zeros_like(vz_w), vz_w)
    del k2, inv_k2

    # Half-spectrum kz multiplicity and the exact integer-lattice bin plan
    kz_weight = np.full(H, 2.0, dtype=np.float64)
    kz_weight[0] = 1.0
    if N % 2 == 0:
        kz_weight[-1] = 1.0
    kzw_j = dev_tensor(kz_weight)
    kbins_edges = np.asarray(spectra_ops.default_kbins(grid, config.nbins))
    e_ = np.concatenate([[0.0], kbins_edges])
    kcent_j = dev_tensor(0.5 * (e_[1:] + e_[:-1])[1:])
    thr = spectra_ops.kbin_thresholds(grid, kbins_edges)
    fi2 = spectra_ops._index_sq(grid)
    fi2_j = dev_tensor(fi2, torch.int32)
    fi2h_j = dev_tensor(fi2[:H], torch.int32)
    thr_j = dev_tensor(thr, torch.int32)
    cnt_j = dev_tensor(spectra_ops.hoisted_counts(grid, thr, kz_weight))
    boxf = torch.tensor(grid.boxfactor, dtype=dtype, device=device)
    sigma_nl_row = torch.full((N,), config.sigma_nl, dtype=dtype,
                              device=device)

    cdtype = gaussian.complex_dtype(dtype)

    def draw(draws, name, make=None):
        """Supplied array ``name`` on the device in the working dtype, or
        ``make()`` (None when the draw happens inside K1)."""
        if draws is None:
            return None if make is None else make()
        dt = cdtype if name in ("dens", "fg") else dtype
        return draws[name].to(device=device, dtype=dt)

    def fn(generator: torch.Generator | None = None,
           draws: dict | None = None, clock=None) -> dict:
        if draws is None and generator is None:
            raise ValueError("pass a torch.Generator or the `draws` dict")
        if draws is not None:
            missing = [k for k in DRAW_NAMES if k not in draws]
            if missing:
                raise ValueError(f"draws is missing {missing}")
        clock = clock or _NoClock()

        # (1) density half-spectrum x sqrt(P)
        white_h = draw(draws, "dens", lambda: gaussian.hermitian_half_noise(
            generator, grid, dtype))
        delta_k = white_h * amp_half
        clock.mark("draw")

        # (3, hoisted) LOS velocity spectrum i vel_fac kz / k^2 delta_k,
        # and the two inverse transforms
        vz_k = torch.complex(-delta_k.imag * vz_w, delta_k.real * vz_w)
        delta_x = torch.fft.irfftn(delta_k, s=grid.shape)
        vel_z = torch.fft.irfftn(vz_k, s=grid.shape)
        del vz_k
        clock.mark("velocity_irfft")

        # (2) bias + log-normal
        delta_ln = transforms.lognormal(delta_x * bias)
        clock.mark("lognormal")

        # (4) sigma_NL dispersion (K1, with max|v|), then the remap (K2/K3)
        vmax = None
        if config.sigma_nl > 0.0:
            vel_z, vmax = rsd_ops.add_scaled_normal(
                vel_z, sigma_nl_row, generator, draw(draws, "rsd"),
                return_max=True)
        delta_s = rsd_ops.redshift_space_density(
            delta_ln, vel_z, grid, Hz, vmax=vmax)
        del delta_ln
        clock.mark("rsd")

        # (5) signal cube in mK, (6) foregrounds
        data = Tb * (1.0 + delta_s)
        fg_cube = fg_map = alpha_map = None
        if config.include_foregrounds:
            white2d = draw(draws, "fg", lambda: gaussian._complex_normal(
                generator, (N, N), dtype))
            alpha_w = draw(draws, "alpha", lambda: torch.randn(
                (N, N), generator=generator, dtype=dtype, device=device))
            fg_map = ForegroundModel.foreground_amp_from_whitenoise(
                white2d, grid, cosmology.chi, config.fg_amp, config.fg_beta,
                config.fg_monopole, fg_sigma_pix)
            if use_fg_poly:
                dalpha = config.spec_idx_std * gaussian_smooth_wrap(
                    alpha_w, alpha_sigma_pix)
                alpha_map = config.spec_idx_mean + dalpha
                fg_cube = ForegroundModel.construct_cube_smallalpha_fn(
                    fg_map, dalpha, ffac_mean_j, logf_j)
            else:
                alpha_map = gaussian_smooth_wrap(
                    config.spec_idx_mean + config.spec_idx_std * alpha_w,
                    alpha_sigma_pix)
                fg_cube = ForegroundModel.construct_cube_fn(
                    fg_map, alpha_map, freqs_j, config.freq_ref)
            data = data + fg_cube
        clock.mark("foregrounds")

        # (7) radiometer noise (K1)
        if config.include_noise:
            data = rsd_ops.add_scaled_normal(
                data, sigma_j, generator, draw(draws, "noise"))
        p_dens = (delta_k.real.square() + delta_k.imag.square()) / boxf
        sigma_data = torch.std(data, correction=0)
        clock.mark("noise")

        # (8) PCA clean
        cleaned = pca_filter(data, config.pca_nmodes)
        clock.mark("pca")

        # (9) binned P(k) of the cleaned cube and the density (K4)
        ck = torch.fft.rfftn(cleaned)
        p_clean = (ck.real.square() + ck.imag.square()) / boxf
        del ck
        # (cuFFT may hand back permuted strides; the kernel reads C order)
        s1, q1, s2 = binned_pk_half_dual_v2(
            p_clean.contiguous(), p_dens.contiguous(), fi2_j, fi2_j, fi2h_j,
            kzw_j, thr_j)
        mean1 = s1 / cnt_j
        var = torch.clamp(q1 / cnt_j - mean1 ** 2, min=0.0)
        var = torch.where(cnt_j > 1, var, torch.zeros_like(var))
        out = {
            "k": kcent_j,
            "pk_cleaned": mean1[1:],
            "pk_cleaned_err": (torch.sqrt(var) / torch.sqrt(cnt_j))[1:],
            "pk_density": (s2 / cnt_j)[1:],
            "sigma_data": sigma_data,
        }
        clock.mark("pk")
        if config.debug_stages:
            out.update(delta_x=delta_x, vel_z=vel_z, delta_s=delta_s,
                       data=data, cleaned=cleaned, ck_power=p_clean)
            if config.include_foregrounds:
                out.update(fg_cube=fg_cube, fg_map=fg_map,
                           alpha_map=alpha_map)
        return out

    return fn


def make_chained_pipeline(*args, **kwargs):
    """Not ported yet (ROADMAP.md A2g); on a GPU its role is CUDA-graph
    capture of ``make_pipeline``'s function."""
    raise NotImplementedError("make_chained_pipeline is not ported yet "
                              "(ROADMAP.md A2g)")


def make_ensemble_pipeline(*args, **kwargs):
    """Not ported yet (ROADMAP.md A2g)."""
    raise NotImplementedError("make_ensemble_pipeline is not ported yet "
                              "(ROADMAP.md A2g)")
