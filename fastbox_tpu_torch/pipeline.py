"""The end-to-end 21cm mock pipeline in PyTorch.

Counterpart of ``fastbox_tpu/pipeline.py`` (``PipelineConfig``,
``_build_pipeline``, ``make_pipeline``, ``make_chained_pipeline``,
``make_ensemble_pipeline``, ``calibrate_pk_debias``) on one device, for
cubic and anisotropic boxes.  The stages:

  1. Gaussian density realisation on the rfft half-spectrum x sqrt(P)  (K9)
  2. HI bias scaling and log-normal transform
  3. linear LOS velocity from the Gaussian delta_k                    (K9)
  4. redshift-space remap, after the sigma_NL dispersion      (K1, K2 | K3)
     ('nearest': the sort and the nearest-node rule)
  5. brightness-temperature scaling Tb (1 + delta_s)
  6. diffuse foreground cube (2D GRF amplitude x spectral-index law)
  7. radiometer noise                                          (K1)
  7b. instrument response: Gaussian beam in k_perp, k_par high-pass
  8. PCA foreground clean (FP32 GEMMs, eigh or subspace iteration)
  9. binned P(k) of the cleaned cube and of the density  (K4 | K4t | K5)

The host set-up (cosmology, instrument scalars, sqrt(P) on the half grid,
the bin plan: ``mock_plan.MockPlan``) runs once in ``make_pipeline``; the
returned function runs stages 1-9 on ``device``, split as fastbox_tpu's
``fn_pre`` (1-7b, its ``pre`` attribute) and ``fn_post`` (8-9, ``post``).

Random draws.  The pipeline function takes a key, a ``torch.Generator``
or the ``draws`` dict.  A key (an int seed, ``jax.random.PRNGKey(seed)``,
or (2,) key words; ``keys``) gives fastbox_tpu's realisation of that key
off the TPU: ``split(key, 5)`` (fastbox_tpu/pipeline.py:492) and the
whole-array ``jax.random`` draws of each of the five arrays, under the
names of those keys:

  ``dens``  (N, N, N/2+1) complex half-spectrum white noise (:517-521)
  ``rsd``   (N, N, N) sigma_NL velocity normals              (:570-579)
  ``fg``    (N, N) complex foreground white noise            (:594-598)
  ``alpha`` (N, N) spectral-index white noise                (:599-600)
  ``noise`` (N, N, N) radiometer normals                     (:629-633)

each drawn when the stage needs it (R1w on a GPU, its twin on the CPU) and
then used as ``draws`` would be: K1 adds the two normal fields in its
supplied mode, and with ``pallas_draw`` on K9 colours ``dens`` in its
supplied mode (fastbox_tpu ignores ``pallas_draw`` off the TPU, where its
draws are the same threefry ones).  fastbox_tpu's truth-gate knobs are
read as it reads them: ``draw_dtype='float32'`` draws ``dens``, ``fg``
and ``alpha`` in float32 and casts them to a float64 pipeline, and the two
normal fields too only with ``threefry_noise`` (else they are
``add_scaled_normal``'s draws, in the pipeline's dtype); for a key the
default path supplies them whole already.  A ``torch.Generator`` draws
torch's streams instead: the density draw (with ``pallas_draw``) and the
two normal draws happen inside K9 and K1 on a GPU.  The gate knobs need a
key, and raise with a generator.  ``draws`` supplies the five arrays.  With ``noise_scheme='rows'`` every field is drawn per
leading-axis row instead (``parallel.rng``), keyed by a seed (or key) and
the row index alone, as the sharded ensemble step draws it; ``draws``
then holds the full-field rows under the ``parallel.rng.TAGS`` names
(``ROWS_DRAW_NAMES``).

Precision.  The TPU-only knobs ``mm3d_precision``, ``vel_precision``,
``dx_precision``, ``fwd_precision`` and ``pca_precision`` select MXU pass
counts and have no meaning on cuFFT or a FP32 GEMM: they are accepted and
ignored.  The port always computes in full FP32 (TF32 off, PyTorch's
default), or in float64 for a float64 config; the one exception is the
PCA clean, which always runs in float64 and rounds the cleaned cube to
the config's dtype (``filters.pca``).
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from . import keys, timing
from .cosmology import Cosmology
from .device import resolve
from .fields import gaussian, transforms
from .filters import pca
from .grid import GridSpec
from .mock_plan import MockPlan, amp_half_table
from .models.foregrounds import ForegroundModel, gaussian_smooth_wrap
from .ops import fft_safe
from .ops import rsd as rsd_ops
from .ops.cuda import half_draw
from .parallel import rng

__all__ = ["PipelineConfig", "make_pipeline", "draw_inputs", "amp_half_table",
           "vz_vectors", "make_chained_pipeline", "make_ensemble_pipeline",
           "calibrate_pk_debias"]

DRAW_NAMES = ("dens", "rsd", "fg", "alpha", "noise")
# noise_scheme='rows': the full-field rows of each stream, by its TAGS name
ROWS_DRAW_NAMES = tuple(rng.ROW_NDIM)

# Knobs whose non-default values select parts of fastbox_tpu's pipeline
# that are not ported: field -> (default, ROADMAP.md item).
_UNPORTED = {
    "fft_pair": (False, "A (do-not-port list): matmul DFT pair"),
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
    # Instrument response: Gaussian beam FWHM = 1.22 lambda / D, and a
    # k_par foreground-avoidance high-pass (1/Mpc)
    beam_dish_m: float | None = None
    kpar_min: float | None = None
    # Cleaning + estimation
    pca_nmodes: int = 4
    pca_exact: bool = True           # False: subspace iteration
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
    # Truth-gate knobs (module docstring): the dtype of the draws, cast to
    # `dtype`, and the two normal fields drawn whole and supplied to K1
    draw_dtype: str | None = None
    threefry_noise: bool = False
    # P(k) reduction: 'auto' takes K4 on cubic grids and K5 elsewhere, 'v2'
    # K4 and 'v2t' its telescoped mode K4t (both K5 with a warning off
    # cubes), 'on' K5, 'off' the plain reduction (on any device); kernels on
    # a GPU, their twins on the CPU
    pallas_pk: str = "auto"
    # Density draw: 'auto'/'on' the fused colored draw K9a, 'vz' K9b (the
    # velocity spectrum from the same pass), 'off' the plain draw
    pallas_draw: str = "off"
    fg_spectral: str = "poly"
    debug_stages: bool = False
    # make_chained_pipeline: 'on' runs one batched eigh over the chain's
    # covariances; 'auto' resolves to 'off', as in fastbox_tpu
    eigh_hoist: str = "off"
    draw_method: str = "erfinv"
    # subtracted from the retained pk_cleaned bins (length nbins - 1)
    pk_debias: tuple | None = None

    def __post_init__(self):
        if self.eigh_hoist not in ("auto", "on", "off"):
            raise ValueError(f"Unknown eigh_hoist '{self.eigh_hoist}'")
        if self.pallas_pk not in ("auto", "on", "off", "v2", "v2t"):
            raise ValueError(f"Unknown pallas_pk '{self.pallas_pk}'")
        if self.pallas_draw not in ("auto", "on", "off", "vz"):
            raise ValueError(f"Unknown pallas_draw '{self.pallas_draw}'")
        if self.draw_method not in ("erfinv", "box_muller"):
            raise ValueError(f"Unknown draw method '{self.draw_method}'")
        if self.fg_spectral not in ("poly", "pow"):
            raise ValueError(f"Unknown fg_spectral '{self.fg_spectral}'")
        if self.dtype not in ("float32", "float64"):
            raise ValueError(f"Unknown dtype '{self.dtype}'")
        if self.draw_dtype not in (None, "float32", "float64"):
            raise ValueError(f"Unknown draw_dtype '{self.draw_dtype}'")
        if self.noise_scheme not in ("half", "rows"):
            raise ValueError(f"Unknown noise_scheme '{self.noise_scheme}'")
        if self.rsd_method not in rsd_ops.METHODS:
            raise ValueError(f"Unknown rsd_method '{self.rsd_method}'")
        for name, (default, item) in _UNPORTED.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r} is not ported "
                    f"(ROADMAP.md {item})")


class _KeyDraws(Mapping):
    """The five ``draws`` arrays of a key, each drawn on first access:
    ``split(key, 5)`` in ``DRAW_NAMES`` order, then fastbox_tpu's
    whole-array draws (fastbox_tpu/pipeline.py:492-633) on ``device``.
    The sub-keys (the five, the density's three in place of its own) are
    hashed on the host in one pass and reach the device in one copy.
    ``dens``, ``fg`` and ``alpha`` are drawn in ``dtype``; ``rsd`` and
    ``noise`` in ``noise_dtype``: fastbox_tpu draws them in the draw dtype
    only under ``threefry_noise``, and else in the pipeline's, through
    ``add_scaled_normal``."""

    def __init__(self, grid: GridSpec, key, dtype, noise_dtype, method: str,
                 device):
        five = keys.split_words(key, len(DRAW_NAMES))
        words = keys.to_device(torch.tensor(
            keys.split_words(five[0], 3) + five[1:], dtype=torch.int64),
            device)
        self._keys = dict(zip(DRAW_NAMES, (words[:3], *words[3:])))
        self._grid, self._method, self._device = grid, method, device
        self._dtypes = dict(dens=dtype, fg=dtype, alpha=dtype,
                            rsd=noise_dtype, noise=noise_dtype)

    def __getitem__(self, name):
        k, g, dt, dev = self._keys[name], self._grid, self._dtypes[name], \
            self._device
        if name == "dens":
            return gaussian._half_noise(k, g, dt, self._method, dev)
        if name == "fg":
            return keys.complex_normal(k, (g.N, g.N), dt, device=dev)
        shape = (g.N, g.N) if name == "alpha" else g.shape
        return keys.normal(k, shape, dt, dev)

    def __contains__(self, name) -> bool:
        return name in self._keys

    def __iter__(self):
        return iter(DRAW_NAMES)

    def __len__(self) -> int:
        return len(DRAW_NAMES)


def draw_inputs(grid: GridSpec, generator, dtype=torch.float32,
                method: str = "erfinv", device=None) -> dict:
    """The five ``draws`` arrays in ``dtype``; ``method`` is the density
    draw's (``PipelineConfig.draw_method``).  A key gives fastbox_tpu's
    arrays for that key, on ``device`` (None: the card); a
    ``torch.Generator`` draws on its device in the order the pipeline
    function consumes them."""
    if keys.is_key(generator):
        return dict(_KeyDraws(grid, generator, dtype, dtype, method,
                              resolve(device)))
    N = grid.N
    dev = generator.device
    out = {"dens": gaussian.hermitian_half_noise(generator, grid, dtype,
                                                 method=method)}
    out["rsd"] = torch.randn(grid.shape, generator=generator, dtype=dtype,
                             device=dev)
    out["fg"] = gaussian._complex_normal(generator, (N, N), dtype)
    out["alpha"] = torch.randn((N, N), generator=generator, dtype=dtype,
                               device=dev)
    out["noise"] = torch.randn(grid.shape, generator=generator, dtype=dtype,
                               device=dev)
    return out


def vz_vectors(grid: GridSpec, vel_fac: float, dtype=torch.float32,
               device="cpu"):
    """K9b's velocity-weight operands (kx2col (N,), kyz2row and kznumrow
    (N*H,)) for ``pallas_draw='vz'``: built in f64 from ``dtype``'s
    wavenumbers, kznum zero on the Nyquist plane, then cast
    (fastbox_tpu/pipeline.py:462-472)."""
    N, H = grid.N, grid.N // 2 + 1
    kx, ky, kz = (v.double().cpu().numpy() for v in grid.kvec(dtype))
    kzh = kz[:H]
    kznum = np.where(grid.nyquist_mask(2)[:H].numpy(), 0.0, vel_fac * kzh)
    return tuple(torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                 device=device) for a in (
        kx ** 2, (ky[:, None] ** 2 + kzh[None, :] ** 2).reshape(N * H),
        np.broadcast_to(kznum[None, :], (N, H)).reshape(N * H)))


def make_pipeline(grid: GridSpec, cosmology: Cosmology,
                  config: PipelineConfig = PipelineConfig(), device=None,
                  amp_half: torch.Tensor | None = None):
    """Build the pipeline: host set-up now, stages 1-9 in the returned
    ``fn(generator=None, draws=None, clock=None, seed=None) -> dict`` on
    ``device`` (None: the CUDA card; pass ``"cpu"`` for the CPU), where
    ``generator`` is a key (fastbox_tpu's ``fn(key)``) or a
    ``torch.Generator`` (module docstring).

    ``amp_half`` (N, N, N/2+1) replaces the sqrt(P boxfactor) table built
    from ``cosmology`` (e.g. fastbox_tpu's own, via
    ``convert.from_jax_state``).  ``clock`` is a ``timing.StageClock``,
    the active clock of ``pre`` and ``post`` (``timing.active``): it marks
    the stages and takes the call's counts.  The output dict has fastbox_tpu's keys: ``k``, ``pk_cleaned``,
    ``pk_cleaned_err``, ``pk_density``, ``sigma_data``, and with
    ``debug_stages`` the intermediate cubes.  ``vel_z`` there includes the
    sigma_NL dispersion, as on fastbox_tpu's ``threefry_noise`` path.

    With ``noise_scheme='rows'`` the fields are the row-keyed draws of
    ``seed`` (default: the key given, else ``generator.initial_seed()``),
    fastbox_tpu's fields for ``jax.random.PRNGKey(seed)`` (one R1 launch a
    field on the card), or ``draws`` holds them (``ROWS_DRAW_NAMES``).

    ``fn.pre(generator=None, draws=None, clock=None, want_cov=False,
    seed=None)`` runs
    stages 1-7b and returns the data cube, the density power and
    ``sigma_data`` (with ``want_cov`` also the PCA covariance);
    ``fn.post(pre, U=None, clock=None)`` runs 8-9, with the clean's
    eigenvectors ``U`` (Nfreq, pca_nmodes) given or found inline.
    """
    device = resolve(device)
    dtype = getattr(torch, config.dtype)
    ddt = getattr(torch, config.draw_dtype) if config.draw_dtype else dtype
    N = grid.N
    H = N // 2 + 1
    plan = MockPlan(grid, cosmology, config, device, amp_half=amp_half)
    amp_half = plan.amp_half
    amp2d = amp_half.reshape(N, N * H)
    rows_mode = config.noise_scheme == "rows"
    # the row-keyed draws are white rows in x-space: K9 has no part in them
    use_k9 = not rows_mode and config.pallas_draw in ("auto", "on", "vz")
    vz_mode = use_k9 and config.pallas_draw == "vz"
    if vz_mode:
        kx2col_j, kyz2row_j, kznumrow_j = vz_vectors(grid, plan.vel_fac,
                                                     dtype, device)
    else:
        vz_w = plan.vz_weight()
    # the beam on the rfft2 grid of the (x, y) plane
    beam = plan.beam(H)
    kpar_filter = plan.kpar_filter
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

    def row_fields(generator, draws, seed) -> dict:
        """noise_scheme='rows': the full-field rows of every stream the
        configuration uses, supplied or drawn from ``seed``
        (fastbox_tpu/pipeline.py:498-504, :559-562, :587-592, :625-628),
        with ``fg`` combined from its two real streams."""
        names = ["density"]
        if config.sigma_nl > 0.0:
            names.append("sigma_nl")
        if config.include_foregrounds:
            names += ["fg_re", "fg_im", "alpha"]
        if config.include_noise:
            names.append("noise")
        if draws is not None:
            missing = [n for n in names if n not in draws]
            if missing:
                raise ValueError(f"draws is missing {missing}")
            out = {n: draws[n].to(device=device, dtype=dtype) for n in names}
        else:
            if seed is None:
                if generator is None:
                    raise ValueError("noise_scheme='rows' needs a seed, a "
                                     "torch.Generator or the `draws` dict")
                seed = generator.initial_seed()
            if torch.is_tensor(seed) and seed.dim() == 1:   # one key's words
                out = {n: v[0] for n, v in rng.row_draws(
                    keys.key_data(seed)[None], names, N, dtype=dtype,
                    device=device).items()}
            else:
                out = rng.row_draws(seed, names, N, dtype=dtype,
                                    device=device)
        if config.include_foregrounds:
            out["fg"] = torch.complex(out.pop("fg_re"), out.pop("fg_im"))
        return out

    def density(generator, draws):
        """(delta_k, vz_k or None): stage (1), and (3)'s spectrum in 'vz'."""
        if draws is not None:
            white = draw(draws, "dens")
            if not use_k9:
                return white * amp_half, None
            white = white.reshape(N, N * H).contiguous()
            if vz_mode:
                d, v = half_draw.colored_half_draw_vz(
                    amp2d, kx2col_j, kyz2row_j, kznumrow_j, white=white)
                return d.reshape(N, N, H), v.reshape(N, N, H)
            d = half_draw.colored_half_draw(amp2d, white=white)
            return d.reshape(N, N, H), None
        if vz_mode:
            return gaussian.colored_half_noise_vz(
                generator, grid, amp_half, kx2col_j, kyz2row_j, kznumrow_j,
                dtype)
        if use_k9:
            return gaussian.colored_half_noise(generator, grid, amp_half,
                                               dtype), None
        white = gaussian.hermitian_half_noise(generator, grid, dtype,
                                              method=config.draw_method)
        return white * amp_half, None

    def instrument(data):
        """Stage (7b): the per-channel beam, then the k_par high-pass."""
        if beam is not None:
            dk2 = torch.fft.rfftn(data, dim=(0, 1))
            data = torch.fft.irfftn(dk2 * beam, s=(N, N), dim=(0, 1))
        if kpar_filter is not None:
            dkz = torch.fft.rfft(data, dim=2)
            data = torch.fft.irfft(dkz * kpar_filter, n=N, dim=2)
        return data.contiguous()

    def pre(generator: torch.Generator | None = None,
            draws: dict | None = None, clock=None,
            want_cov: bool = False, seed: int | None = None) -> dict:
        with timing.active(clock) as clock:
            if keys.is_key(generator):
                if rows_mode:
                    if seed is not None:
                        raise ValueError("pass a key or seed=, not both")
                    seed = generator if isinstance(generator, int) \
                        else keys.key_data(generator)
                    generator = None
                elif draws is None:
                    # fastbox_tpu's five arrays of the key, drawn on access
                    draws, generator = _KeyDraws(
                        grid, generator, ddt,
                        ddt if config.threefry_noise else dtype,
                        config.draw_method, device), None
            elif (generator is not None and draws is None and not rows_mode
                  and (config.threefry_noise or config.draw_dtype)):
                raise ValueError("threefry_noise and draw_dtype select "
                                 "fastbox_tpu's threefry draws: pass a key")
            if rows_mode:
                # (1) real white rows, one half-spectrum FFT, x sqrt(P)
                rows = row_fields(generator, draws, seed)
                delta_k = fft_safe.rfftn(rows.pop("density")) \
                    * (N ** -1.5) * amp_half
                vz_k = None
                draws = rows
            else:
                if seed is not None:
                    raise ValueError("seed= selects the row-keyed draws of "
                                     "noise_scheme='rows'")
                if draws is None and generator is None:
                    raise ValueError("pass a key, a torch.Generator or the "
                                     "`draws` dict")
                if draws is not None:
                    missing = [k for k in DRAW_NAMES if k not in draws]
                    if missing:
                        raise ValueError(f"draws is missing {missing}")
                # (1) density half-spectrum x sqrt(P)
                delta_k, vz_k = density(generator, draws)
            clock.mark("draw")

            # (3, hoisted) LOS velocity spectrum i vel_fac kz / k^2 delta_k,
            # and the two inverse transforms
            if vz_k is None:
                vz_k = torch.complex(-delta_k.imag * vz_w, delta_k.real * vz_w)
            delta_x = fft_safe.irfftn(delta_k, grid.shape)
            vel_z = fft_safe.irfftn(vz_k, grid.shape)
            del vz_k
            clock.mark("velocity_irfft")

            # (2) bias + log-normal
            delta_ln = transforms.lognormal(delta_x * plan.bias)
            clock.mark("lognormal")

            # (4) sigma_NL dispersion (K1, with max|v|), then the remap (K2/K3;
            # 'nearest' sorts); rows mode adds its sigma_NL rows to vel_z first
            # (fastbox_tpu/pipeline.py:559-566)
            vmax = None
            if rows_mode and config.sigma_nl > 0.0:
                vel_z = vel_z + config.sigma_nl * draws["sigma_nl"]
            elif config.sigma_nl > 0.0:
                vel_z, vmax = rsd_ops.add_scaled_normal(
                    vel_z, sigma_nl_row, generator, draw(draws, "rsd"),
                    return_max=True)
            delta_s = rsd_ops.redshift_space_density(
                delta_ln, vel_z, grid, plan.Hz, vmax=vmax,
                method=config.rsd_method)
            del delta_ln
            clock.mark("rsd")

            # (5) signal cube in mK, (6) foregrounds
            data = plan.Tb * (1.0 + delta_s)
            fg_cube = fg_map = alpha_map = None
            if config.include_foregrounds:
                white2d = draw(draws, "fg", lambda: gaussian._complex_normal(
                    generator, (N, N), dtype))
                alpha_w = draw(draws, "alpha", lambda: torch.randn(
                    (N, N), generator=generator, dtype=dtype, device=device))
                fg_map = ForegroundModel.foreground_amp_from_whitenoise(
                    white2d, grid, cosmology.chi, config.fg_amp,
                    config.fg_beta, config.fg_monopole, plan.fg_sigma_pix)
                if plan.fg_poly:
                    dalpha = config.spec_idx_std * gaussian_smooth_wrap(
                        alpha_w, plan.alpha_sigma_pix)
                    alpha_map = config.spec_idx_mean + dalpha
                    fg_cube = ForegroundModel.construct_cube_smallalpha_fn(
                        fg_map, dalpha, plan.ffac_mean, plan.logf)
                else:
                    alpha_map = gaussian_smooth_wrap(
                        config.spec_idx_mean + config.spec_idx_std * alpha_w,
                        plan.alpha_sigma_pix)
                    fg_cube = ForegroundModel.construct_cube_fn(
                        fg_map, alpha_map, plan.freqs, config.freq_ref)
                data = data + fg_cube
            clock.mark("foregrounds")

            # (7) radiometer noise (K1), (7b) instrument response
            if config.include_noise:
                data = rsd_ops.add_scaled_normal(
                    data, plan.sigma, generator, draw(draws, "noise"))
            if beam is not None or kpar_filter is not None:
                clock.mark("noise")
                data = instrument(data)
            out = {
                "data": data,
                "p_dens": (delta_k.real.square()
                           + delta_k.imag.square()) / plan.boxfactor,
                "sigma_data": torch.std(data, correction=0),
            }
            if want_cov:
                out["cov"] = pca.covariance(data)
            if config.debug_stages:
                out.update(delta_x=delta_x, vel_z=vel_z, delta_s=delta_s)
                if config.include_foregrounds:
                    out.update(fg_cube=fg_cube, fg_map=fg_map,
                               alpha_map=alpha_map)
            clock.mark("noise" if beam is None and kpar_filter is None
                       else "instrument")
            return out

    def post(pre_out: dict, U: torch.Tensor | None = None,
             clock=None) -> dict:
        with timing.active(clock) as clock:
            data = pre_out["data"]

            # (8) PCA clean: given eigenvectors, exact eigh, or subspace
            if U is not None:
                cleaned = pca.pca_project(data, U)
            elif config.pca_exact:
                cleaned = pca.pca_filter(data, config.pca_nmodes)
            else:
                cleaned = pca.pca_filter_subspace(data, config.pca_nmodes)
            clock.mark("pca")

            # (9) binned P(k) of the cleaned cube and the density
            ck = fft_safe.rfftn(cleaned)
            p_clean = (ck.real.square() + ck.imag.square()) / plan.boxfactor
            del ck
            bins = plan.bins
            out = {"k": bins.k,
                   **bins.finish(*bins.sums(p_clean, pre_out["p_dens"])),
                   "sigma_data": pre_out["sigma_data"]}
            clock.mark("pk")
            if config.debug_stages:
                out.update({n: pre_out[n] for n in ("delta_x", "vel_z",
                                                    "delta_s")},
                           data=data, cleaned=cleaned, ck_power=p_clean)
                if config.include_foregrounds:
                    out.update({n: pre_out[n] for n in ("fg_cube", "fg_map",
                                                        "alpha_map")})
            return out

    def fn(generator: torch.Generator | None = None,
           draws: dict | None = None, clock=None,
           seed: int | None = None) -> dict:
        return post(pre(generator, draws, clock, seed=seed), None, clock)

    fn.pre = pre
    fn.post = post
    return fn


def _realisations(generators, draws) -> list:
    """(generator, draws) of each realisation of a stacked run."""
    if draws is not None:
        gens = [None] * len(draws) if generators is None else list(generators)
        if len(gens) != len(draws):
            raise ValueError("generators and draws differ in length")
        return list(zip(gens, draws))
    if generators is None:
        raise ValueError("pass a sequence of keys (seeds, or a (K, 2) key "
                         "tensor), of torch.Generators or of `draws` dicts")
    return [(g, None) for g in generators]


def _stack(outs: list) -> dict:
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def make_chained_pipeline(grid: GridSpec, cosmology: Cosmology,
                          config: PipelineConfig = PipelineConfig(),
                          device=None, amp_half: torch.Tensor | None = None):
    """``fn(generators=None, draws=None) -> dict``: K realisations, one
    after another, with the outputs stacked on a leading axis (K is the
    length of ``generators`` or ``draws``, sequences of what
    ``make_pipeline``'s function takes: a (K, 2) key tensor or a list of
    seeds gives fastbox_tpu's scan over those keys).

    fastbox_tpu scans its single pipeline in one program to amortise the
    TPU's dispatch cost; here the chain is a Python loop over the same
    function (CUDA-graph capture is later work, ROADMAP.md).  With
    ``eigh_hoist='on'`` (and exact PCA, no ``debug_stages``) it runs two
    passes around ONE batched ``torch.linalg.eigh`` of the K stacked
    covariances (fastbox_tpu/pipeline.py:812-839): the same estimator, the
    eigenvectors merely found together.
    """
    single = make_pipeline(grid, cosmology, config, device, amp_half)
    use_hoist = (config.pca_exact and not config.debug_stages
                 and config.eigh_hoist == "on")

    def fn(generators=None, draws=None) -> dict:
        runs = _realisations(generators, draws)
        if not use_hoist:
            return _stack([single(g, d) for g, d in runs])
        pres = [single.pre(g, d, want_cov=True) for g, d in runs]
        U = pca.top_eigvecs(torch.stack([p.pop("cov") for p in pres]),
                            config.pca_nmodes)
        return _stack([single.post(p, U[i]) for i, p in enumerate(pres)])

    return fn


def make_ensemble_pipeline(grid: GridSpec, cosmology: Cosmology,
                           config: PipelineConfig = PipelineConfig(),
                           device=None, mesh=None,
                           amp_half: torch.Tensor | None = None):
    """Monte-Carlo ensemble: ``fn(generators=None, draws=None) -> dict`` of
    B realisations with stacked outputs, each equal to its single call
    (fastbox_tpu vmaps its pipeline over a (B, 2) key batch, which
    ``generators`` takes as it is; here it is a loop on one device).

    With ``mesh`` (a ``parallel.make_mesh`` DeviceMesh), pure data
    parallelism over its 'ens' group (fastbox_tpu/pipeline.py:888-911):
    rank e of 'ens' runs realisations [e B/ens, (e+1) B/ens) and the
    stacked outputs are all-gathered, so every rank returns all B.  B must
    be a multiple of the 'ens' size; the 'space' ranks of one 'ens' index
    repeat the same work, as fastbox_tpu's replicated keys do.
    """
    if mesh is not None and not (
            isinstance(mesh, DeviceMesh)
            and "ens" in (mesh.mesh_dim_names or ())):
        raise TypeError("mesh must be a DeviceMesh with an 'ens' axis "
                        "(parallel.make_mesh)")
    chain = make_chained_pipeline(
        grid, cosmology, dataclasses.replace(config, eigh_hoist="off"),
        device, amp_half)
    if mesh is None:
        return chain
    from .parallel.mesh import ens_share, gather_ens

    def fn(generators=None, draws=None) -> dict:
        runs = _realisations(generators, draws)
        lo, hi = ens_share(mesh, len(runs))
        gens, ds = zip(*runs[lo:hi])
        local = chain(list(gens), list(ds))
        return {k: gather_ens(mesh, v) for k, v in local.items()}

    return fn


def calibrate_pk_debias(grid: GridSpec, cosmology: Cosmology,
                        config_fast: PipelineConfig,
                        config_ref: PipelineConfig | None = None,
                        seeds=(5000, 5001, 5002, 5003, 5004, 5005, 5006,
                               5007),
                        device=None, amp_half: torch.Tensor | None = None):
    """The additive per-bin bias of ``config_fast``'s cleaned P(k) against
    ``config_ref``'s: ``mean(pk_fast - pk_ref)`` over realisations drawn
    from ``jax.random.PRNGKey`` of each of ``seeds`` (keep them disjoint
    from science seeds), as a tuple for ``dataclasses.replace(config_fast,
    pk_debias=...)`` (fastbox_tpu/pipeline.py:852-885).

    fastbox_tpu's default reference restores its DFT precision tiers; the
    port ignores those knobs, so ``config_ref`` defaults to ``config_fast``
    with ``pk_debias=None``, and the default calibration is all zeros.
    """
    device = resolve(device)
    if config_ref is None:
        config_ref = dataclasses.replace(config_fast, pk_debias=None)
    config_fast = dataclasses.replace(config_fast, pk_debias=None)
    fn_fast = make_pipeline(grid, cosmology, config_fast, device, amp_half)
    fn_ref = make_pipeline(grid, cosmology, config_ref, device, amp_half)
    diffs = []
    for seed in seeds:
        pf, pr = (f(int(seed))["pk_cleaned"].double().cpu().numpy()
                  for f in (fn_fast, fn_ref))
        diffs.append(pf - pr)
    return tuple(float(v) for v in np.mean(diffs, axis=0))
