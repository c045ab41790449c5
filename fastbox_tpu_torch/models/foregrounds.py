"""Foreground emission models (counterpart of fastbox_tpu/models/foregrounds.py).

* ``ForegroundModel``: the diffuse power-law foreground (reference
  foregrounds.py:34-174). A 2D Gaussian random field with the Santos et
  al. (2005) angular power law, a smoothed Gaussian spectral-index map, a
  wrap-mode Gaussian smoothing that matches
  ``scipy.ndimage.gaussian_filter(mode='wrap')``, and the (nu/nu_ref)^alpha
  cube; the static builders are the ones the pipeline uses ('poly' and its
  'pow' fallback).
* ``PointSourceModel``: the Battye et al. (2013) recipe on the flat-sky box
  patch (foregrounds.py:268-434), with the empirical flux counts integrated
  by ``scipy.integrate.quad`` on the host and the bright-source shot map
  drawn by numpy's generator, as in fastbox_tpu.
* ``GlobalSkyModel`` / ``PlanckSkyModel``: host-side ingest models that need
  pygdsm/healpy and external data files, gated on their imports as in the
  reference; ``planck_corr`` and ``assemble_cube`` need neither.

Every random method draws from the box's next key (or ``PRNGKey`` of the
given seed), fastbox_tpu's ``jax.random`` fields on the box's device, or
takes its numbers supplied (``white=``, ``normals=``, ``white_clustering=``,
``white_poisson=``, ``spidx_normals=``).
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.integrate import quad

from .. import keys, timing
from ..constants import C_MS, CMB_TEMP, H_PLANCK, KBOLTZ
from ..fields.gaussian import complex_dtype

__all__ = ["complex_white_noise", "gaussian_smooth_wrap", "ForegroundModel",
           "PointSourceModel", "GlobalSkyModel", "PlanckSkyModel"]


def _scipy_gaussian_kernel1d(sigma: float, n: int) -> np.ndarray:
    """The truncated, normalised 1-D kernel scipy.ndimage uses (truncate=4)."""
    radius = int(4.0 * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 * (x / sigma) ** 2)
    phi /= phi.sum()
    # Embed circularly into length n (wrap mode == circular convolution)
    k = np.zeros(n, dtype=np.float64)
    for xi, p in zip(x.astype(int), phi):
        k[xi % n] += p
    return k


def complex_white_noise(generator, shape, dtype=torch.float32, device=None):
    """Complex unit white noise re + i im (foregrounds.py:62-72): for a key,
    ``split(key)`` and two ``jax.random.normal`` draws on ``device``
    (fastbox_tpu/models/foregrounds.py:62-70); else two normal draws of the
    ``torch.Generator``."""
    if keys.is_key(generator):
        return keys.complex_normal(generator, shape, dtype, device=device)
    re = torch.randn(shape, generator=generator, dtype=dtype, device=device)
    im = torch.randn(shape, generator=generator, dtype=dtype, device=device)
    return torch.complex(re, im)


def gaussian_smooth_wrap(field2d: torch.Tensor, sigma_pix: float):
    """Separable wrap-mode Gaussian smoothing of a 2D field.

    Circular convolution with scipy's truncated kernel, applied by FFT.
    The kernel spectra are cast to the field's complex dtype (fastbox_tpu
    keeps them complex128 when x64 is enabled).
    """
    n0, n1 = field2d.shape
    cdt = complex_dtype(field2d.dtype)
    dev = field2d.device
    timing.count_copy("h2d_smooth", dev, 2)
    k0 = torch.as_tensor(np.fft.fft(_scipy_gaussian_kernel1d(sigma_pix, n0)),
                         dtype=cdt, device=dev)
    k1 = torch.as_tensor(np.fft.fft(_scipy_gaussian_kernel1d(sigma_pix, n1)),
                         dtype=cdt, device=dev)
    fk = torch.fft.fft2(field2d)
    out = torch.fft.ifft2(fk * k0[:, None] * k1[None, :]).real
    return out.to(field2d.dtype)


class ForegroundModel:
    """Diffuse foregrounds on top of a ``CosmoBox`` (foregrounds.py:34-174)."""

    def __init__(self, box):
        self.box = box

    @staticmethod
    def foreground_amp_from_whitenoise(white2d, grid, chi, amp, beta,
                                       monopole, smoothing_sigma_pix=None):
        """Colour 2D complex white noise by the Santos+2005 C_ell power law.

        C_ell = amp (l/1000)^beta with l = 0.5 k_perp chi
        (foregrounds.py:90), normalisation ``N^4/(Lx Ly)``
        (foregrounds.py:95), zero mode removed, real part kept, monopole
        added.
        """
        rdtype = white2d.real.dtype
        kx, ky, _ = grid.kvec(rdtype, white2d.device)
        k_perp = torch.sqrt(kx[:, None] ** 2 + ky[None, :] ** 2)
        ell = 0.5 * k_perp * chi / 1000.0
        C_ell = amp * torch.where(ell > 0.0, ell, torch.ones_like(ell)) ** beta
        C_ell = torch.where(ell > 0.0, C_ell, torch.zeros_like(C_ell))
        C_ell = C_ell * (grid.N**4 / (grid.Lx * grid.Ly))
        fg_k = white2d * torch.sqrt(C_ell)
        fg_x = torch.fft.ifftn(fg_k).real + monopole
        if smoothing_sigma_pix is not None:
            fg_x = gaussian_smooth_wrap(fg_x, smoothing_sigma_pix)
        return fg_x.to(rdtype)

    @staticmethod
    def construct_cube_fn(amps, spectral_idx, freqs, freq_ref):
        """cube = amps * (nu/nu_ref)^alpha (foregrounds.py:147-174)."""
        ffac_base = freqs / freq_ref
        if spectral_idx.dim() == 0:
            ffac = ffac_base[None, None, :] ** spectral_idx
        else:
            ffac = ffac_base[None, None, :] ** spectral_idx[:, :, None]
        return amps[:, :, None] * ffac

    @staticmethod
    def construct_cube_smallalpha_fn(amps, dalpha, ffac_mean, logf):
        """cube = amps * ffac_mean(nu) * exp(dalpha * logf(nu)) for
        |dalpha * logf| << 1, with exp(u) by a cubic Taylor polynomial.

        The accurate f32 form of ``construct_cube_fn``: every large factor
        is pixel-common, and the tiny pixel-varying part carries ~1 ulp of
        rounding (fastbox_tpu/models/foregrounds.py:137-161 gives the
        truth-gate finding behind it).  Callers precompute
        ffac_mean = (nu/ref)^mean and logf = log(nu/ref) in float64.
        """
        u = dalpha[:, :, None] * logf[None, None, :]
        expu = 1.0 + u * (1.0 + u * (0.5 + u * (1.0 / 6.0)))
        return amps[:, :, None] * (ffac_mean[None, None, :] * expu)

    # -- reference-API methods ---------------------------------------
    def _sigma_pix(self, cosmology, smoothing_scale):
        ang_x, _ = self.box.grid.pixel_array(cosmology)
        return smoothing_scale / (ang_x[1] - ang_x[0])

    def realise_foreground_amp(self, amp, beta, monopole, smoothing_scale=None,
                               redshift=None, white=None):
        """2D foreground amplitude map in field units (foregrounds.py:48-113),
        from the box's next key or the complex (N, N) white noise
        ``white``."""
        box = self.box
        cosmology = box.cosmology_at(redshift)
        if white is None:
            white = complex_white_noise(box.next_key(),
                                        (box.grid.N, box.grid.N), box.dtype,
                                        box.device)
        sigma_pix = (None if smoothing_scale is None
                     else self._sigma_pix(cosmology, smoothing_scale))
        return self.foreground_amp_from_whitenoise(
            box._tensor(white), box.grid, cosmology.chi, amp, beta, monopole,
            sigma_pix)

    def realise_spectral_index(self, mean_spec_idx, std_spec_idx,
                               smoothing_scale, redshift=None, normals=None):
        """Smoothed Gaussian spectral-index map (foregrounds.py:116-144), from
        the box's next key or the (N, N) unit normals ``normals``."""
        box = self.box
        cosmology = box.cosmology_at(redshift)
        if normals is None:
            normals = keys.normal(box.next_key(), (box.grid.N, box.grid.N),
                                  box.dtype, box.device)
        alpha = mean_spec_idx + std_spec_idx * box._tensor(normals)
        return gaussian_smooth_wrap(alpha,
                                    self._sigma_pix(cosmology, smoothing_scale))

    def construct_cube(self, amps, spectral_idx, freq_ref=130.0,
                       redshift=None):
        """Foreground datacube from amplitude + spectral-index maps."""
        box = self.box
        cosmology = box.cosmology_at(redshift)
        freqs = torch.as_tensor(box.grid.freq_array(cosmology).copy(),
                                dtype=box.dtype, device=box.device)
        if isinstance(spectral_idx, float):
            spectral_idx = torch.tensor(spectral_idx, dtype=box.dtype,
                                        device=box.device)
        return self.construct_cube_fn(box._tensor(amps), spectral_idx, freqs,
                                      freq_ref)


# ----------------------------------------------------------------------
# Point sources (Battye et al. 2013)
# ----------------------------------------------------------------------
class PointSourceModel:
    """Battye et al. (2013) point-source model (foregrounds.py:268-434).

    The clustering and faint-Poisson components are 2D GRFs of their C_ell
    on the box's pixel grid; bright sources are put in random pixels.  The
    flux-count formulae are the reference's (foregrounds.py:286-310).
    """

    def __init__(self, box):
        self.box = box

    def flux_amplitude(self, sjy):
        """Amplitude factor of the flux scaling (foregrounds.py:286-295)."""
        logS = np.log10(sjy)
        gamma = (
            2.593
            + 9.333e-2 * logS
            - 4.839e-4 * logS**2
            + 2.488e-1 * logS**3
            + 8.995e-2 * logS**4
            + 8.506e-3 * logS**5
        )
        return 10.0**gamma

    def integ_flux(self, sjy):
        return self.flux_amplitude(sjy) * sjy ** (-2.5) * sjy

    def poisson_pspec(self, sjy):
        return self.flux_amplitude(sjy) * sjy ** (-2.5) * sjy**2.0

    def number_count(self, sjy):
        return self.flux_amplitude(sjy) * sjy ** (-2.5)

    # ------------------------------------------------------------------
    def _grf_from_cl(self, white, cl_fn, chi):
        """Flat-sky 2D GRF whose angular spectrum follows cl_fn(ell), from
        the complex (N, N) white noise ``white``.  C_ell is built in numpy
        on the host from the wavenumbers in the box's dtype, as fastbox_tpu
        builds it."""
        box = self.box
        grid = box.grid
        kx, ky, _ = (k.numpy() for k in grid.kvec(box.dtype))
        k_perp = np.sqrt(kx[:, None] ** 2 + ky[None, :] ** 2)
        ell = k_perp * chi  # flat-sky ell = k_perp * chi
        cl = np.where(ell > 0.0, cl_fn(np.maximum(ell, 1.0)), 0.0)
        # chi^2 converts the per-steradian C_ell to the comoving pixel grid:
        # a transverse comoving length L corresponds to angle L/chi.
        cl = cl * (grid.N**4 / (grid.Lx * grid.Ly)) * chi**2 / 1.0
        fg = white * torch.sqrt(torch.as_tensor(cl, dtype=box.dtype,
                                                device=box.device))
        return torch.fft.ifftn(fg).real.to(box.dtype)

    def _white(self, white, seed):
        """Complex (N, N) white noise: ``white``, or drawn from
        ``PRNGKey(seed)``, or from the box's next key
        (fastbox_tpu/models/foregrounds.py:277-287)."""
        box = self.box
        if white is not None:
            return box._tensor(white)
        key = box.next_key() if seed is None else keys.PRNGKey(seed)
        return complex_white_noise(key, (box.grid.N, box.grid.N), box.dtype,
                                   box.device)

    def shot_map(self, flux_cutoff, seed_poisson=None, redshift=None):
        """Bright sources above 0.01 Jy put in random pixels: a float64
        (N, N) host array in K, drawn by ``np.random.default_rng(
        seed_poisson)`` over the flux steps of ``np.arange(0.01,
        flux_cutoff, step)`` (foregrounds.py:386-410); zeros for a cutoff
        at or below 0.01 Jy."""
        box = self.box
        n = box.grid.N
        shot = np.zeros((n, n))
        if flux_cutoff <= 0.01:
            return shot
        cosmology = box.cosmology_at(redshift)
        cfact = C_MS**2 / (2.0 * KBOLTZ * (1.4e9) ** 2) * 1e-26
        ang_x, ang_y = box.grid.pixel_array(cosmology)
        pixarea_sr = (np.deg2rad(ang_x[1] - ang_x[0])
                      * np.deg2rad(ang_y[1] - ang_y[0]))
        fov_sr = (np.deg2rad(ang_x[-1] - ang_x[0])
                  * np.deg2rad(ang_y[-1] - ang_y[0]))
        rng = np.random.default_rng(seed_poisson)
        for ival in np.arange(0.01, flux_cutoff, (flux_cutoff - 0.01) / 10.0):
            numbster = quad(self.number_count, ival - 1e-3, ival + 1e-3)[0]
            nsrc = rng.poisson(max(numbster * ival, 0.0) * fov_sr)
            tempval = cfact * quad(self.integ_flux, 0.01, ival)[0] / pixarea_sr
            if nsrc > 0:
                idx = rng.integers(0, n * n, size=nsrc)
                shot.ravel()[idx] = tempval
        return shot

    def construct_cube(self, flux_cutoff, beta, delta_beta, redshift=None,
                       seed_clustering=None, seed_poisson=None,
                       white_clustering=None, white_poisson=None,
                       spidx_normals=None):
        """Point-source temperature cube + mean temperature, both in mK.

        Mirrors foregrounds.py:313-434: mean T from the integrated flux below
        the cutoff, a clustering GRF with C_l = 1.8e-4 l^-1.2 T0^2, a
        Gaussian Poisson component from the faint-source P(k), the
        bright-source ``shot_map`` and per-pixel power-law frequency
        scaling.  The two GRFs take the complex (N, N) noise
        ``white_clustering`` / ``white_poisson`` or draw it from
        ``PRNGKey(seed_clustering)`` / ``PRNGKey(seed_poisson)`` (else the
        box's next key); the spectral indices take the (N, N) unit normals
        ``spidx_normals`` or the box's next key.  Returns the (N, N, N)
        cube on the box's device and the (Nfreq, 1) host array of the mean
        temperature.
        """
        box = self.box
        cosmology = box.cosmology_at(redshift)
        freqs = np.asarray(box.grid.freq_array(cosmology))
        nfreq = freqs.size
        n = box.grid.N
        chi = cosmology.chi

        cfact = C_MS**2 / (2.0 * KBOLTZ * (1.4e9) ** 2) * 1e-26

        # Mean temperature at 1.4 GHz (foregrounds.py:366-367)
        T_ps0 = cfact * quad(self.integ_flux, 0.0, flux_cutoff)[0]

        # Clustering component C_l = 1.8e-4 l^-1.2 T0^2 (foregrounds.py:371)
        clustmap = self._grf_from_cl(
            self._white(white_clustering, seed_clustering),
            lambda ell: 1.8e-4 * ell**-1.2 * T_ps0**2, chi)

        # Faint-source Poisson component: flat C_l (foregrounds.py:376-384)
        cl_poisson = cfact**2 * quad(self.poisson_pspec, 0.0,
                                     min(0.01, flux_cutoff))[0]
        poisson_map = self._grf_from_cl(
            self._white(white_poisson, seed_poisson),
            lambda ell: cl_poisson + 0.0 * ell, chi)

        shotmap = torch.as_tensor(
            self.shot_map(flux_cutoff, seed_poisson, redshift),
            dtype=box.dtype, device=box.device)

        map0 = T_ps0 + poisson_map + clustmap + shotmap

        # Spectral index map: the intended RMS delta_beta (the reference has
        # scale=delta_beta**2 at foregrounds.py:416, a documented quirk).
        if spidx_normals is None:
            spidx_normals = keys.normal(box.next_key(), (n, n), box.dtype,
                                        box.device)
        spidxs = beta + delta_beta * box._tensor(spidx_normals)

        freqs_t = torch.as_tensor(freqs.copy(), dtype=box.dtype,
                                  device=box.device)
        maps = map0[:, :, None] \
            * (freqs_t[None, None, :] / 1400.0) ** spidxs[:, :, None]
        T_ps_mean = (T_ps0 * (freqs / 1400.0) ** beta).reshape(nfreq, 1)
        return maps * 1e3, T_ps_mean * 1e3  # mK


# ----------------------------------------------------------------------
# Host-side ingest models (optional heavy deps, like the reference)
# ----------------------------------------------------------------------
class GlobalSkyModel:
    """pyGDSM-based foregrounds (foregrounds.py:178-264); host-side ingest.

    Requires ``pygdsm`` and ``healpy``; raises ImportError otherwise, like
    the reference (foregrounds.py:192-197).
    """

    def __init__(self, box):
        self.box = box
        try:
            from pygdsm import GlobalSkyModel2016
        except ImportError as exc:
            raise ImportError("pygdsm is not installed") from exc
        self.gsm = GlobalSkyModel2016(freq_unit="MHz")

    def construct_cube(self, lat0=0.0, lon0=0.0, redshift=None, loop=True,
                       verbose=True):
        """The GSM projected on the box patch per channel: a float64
        (N, N, N) tensor on the box's device."""
        from functools import partial

        import healpy as hp

        box = self.box
        cosmology = box.cosmology_at(redshift)
        freqs = box.grid.freq_array(cosmology)
        ang_x, ang_y = box.grid.pixel_array(cosmology)
        dx = np.max(ang_x) - np.min(ang_x)
        dy = np.max(ang_y) - np.min(ang_y)
        npix = box.grid.N
        proj = hp.projector.CartesianProj(
            lonra=[lon0 - 0.5 * dx, lon0 + 0.5 * dx],
            latra=[lat0 - 0.5 * dy, lat0 + 0.5 * dy],
            coord="G", xsize=npix, ysize=npix,
        )
        fgcube = np.zeros(box.grid.shape)
        for i, freq in enumerate(freqs):
            if verbose and i % 10 == 0:
                print(f"    Channel {i} / {len(freqs)}")
            m = self.gsm.generate(freq)
            nside = hp.npix2nside(m.size)
            fgcube[:, :, i] = proj.projmap(m, vec2pix_func=partial(hp.vec2pix,
                                                                   nside))
        return torch.as_tensor(fgcube, device=box.device)


class PlanckSkyModel:
    """Planck FFP10 synchrotron + free-free model (foregrounds.py:438-681).

    The healpix map ingest and projection need ``healpy`` and the Planck
    simulation files (host numpy); the T_CMB -> T_RJ correction and the
    power-law cube assembly (on the maps' device) need neither.
    """

    def __init__(self, box, free_idx=-2.1, planck_sim_paths=None):
        try:
            import healpy  # noqa: F401
        except ImportError as exc:
            raise ImportError("healpy is not installed") from exc
        self.box = box
        self.free_idx = free_idx
        self.planck_sim_paths = planck_sim_paths or {}

    @staticmethod
    def planck_corr(freq_ghz):
        """T_CMB -> T_RJ correction factor (foregrounds.py:483-497)."""
        freq = freq_ghz * 1e9
        factor = H_PLANCK * freq / (KBOLTZ * CMB_TEMP)
        return (np.exp(factor) - 1.0) ** 2 / (factor**2 * np.exp(factor))

    @staticmethod
    def assemble_cube(sync_amp, free_amp, sync_idx, freqs, ref_freq, free_idx):
        """cube = sync x^sync_idx + free x^free_idx (foregrounds.py:677-681),
        with x = freqs / ref_freq in the maps' dtype on their device."""
        x = torch.as_tensor(np.array(freqs), dtype=sync_amp.dtype,
                            device=sync_amp.device) / ref_freq
        return (
            sync_amp[:, :, None] * x[None, None, :] ** sync_idx[:, :, None]
            + free_amp[:, :, None] * x[None, None, :] ** free_idx
        )

    def read_planck_sim_maps(self):
        """Read the Planck FFP10 simulation maps, converting T_CMB -> T_RJ
        (foregrounds.py:500-520).  Requires healpy + the .fits files."""
        import healpy as hp

        out = []
        for key, ghz in (("ff217", 217.0), ("sync217", 217.0),
                         ("sync353", 353.0)):
            path = self.planck_sim_paths[key]
            out.append(hp.fitsfunc.read_map(path, field=0, nest=False)
                       / self.planck_corr(ghz))
        return tuple(out)

    def synch_freefree_maps(self, redshift=None, rotation=(0.0, -62.0, 0.0),
                            ref_freq=1000.0, free_idx=None, seed_syncidx=None):
        """Synchrotron/free-free amplitude + spectral-index maps on the box
        patch (foregrounds.py:523-635), as host numpy arrays.

        Spherical-harmonic synthesis and gnomonic projection are healpy
        operations (host-side ingest, as in the reference); the projected
        maps are resampled onto the box pixel grid.
        """
        import healpy as hp
        import scipy.ndimage

        box = self.box
        cosmology = box.cosmology_at(redshift)
        ang_x, ang_y = box.grid.pixel_array(cosmology)
        xside, yside = len(ang_x), len(ang_y)

        free217, sync217, sync353 = self.read_planck_sim_maps()
        free217 = free217.copy()
        free217[free217 < 0.0] = np.percentile(free217, 3)

        if free_idx is None:
            free_idx = self.free_idx

        sync_idx = np.log(sync353 / sync217) / np.log(353.0 / 217.0)
        sync_amp = sync217 * ((ref_freq / 1000.0) / 217.0) ** sync_idx
        free_amp = free217 * ((ref_freq / 1000.0) / 217.0) ** free_idx

        # Small-scale synch-index fluctuations with C_l ~ l^-2.4
        # (foregrounds.py:587-596)
        ells = np.arange(1.0, 4001.0)
        cl0 = np.var(sync_idx) / 4000.0
        cls = cl0 * (1000.0 / ells) ** 2.4
        nside = hp.get_nside(sync_idx)
        sync_idx = sync_idx + hp.sphtfunc.synfast(cls, nside)

        reso_arcmin = hp.nside2resol(nside, arcmin=True)
        npix_proj = int(np.ceil(54.1 * 60.0 / reso_arcmin))

        def project(m):
            proj = hp.visufunc.gnomview(m, coord="G", rot=rotation,
                                        xsize=npix_proj, ysize=npix_proj,
                                        reso=reso_arcmin, flip="astro",
                                        return_projected_map=True, no_plot=True)
            m2 = np.asarray(proj)[::-1]
            zoom = np.array([xside, yside]) / np.array(m2.shape)
            return scipy.ndimage.zoom(m2, zoom, order=3)

        return (project(sync_amp) * 1e3, project(free_amp) * 1e3,
                project(sync_idx))

    def construct_cube(self, redshift=None, rotation=(0.0, -62.0, 0.0),
                       ref_freq=1000.0, seed_syncidx=None):
        """Planck Sky Model datacube in mK (foregrounds.py:638-681), float64
        on the box's device."""
        box = self.box
        cosmology = box.cosmology_at(redshift)
        freqs = box.grid.freq_array(cosmology)
        maps = self.synch_freefree_maps(
            redshift=redshift, rotation=rotation, ref_freq=ref_freq,
            seed_syncidx=seed_syncidx)
        sync_amp, free_amp, sync_idx = (torch.as_tensor(m, device=box.device)
                                        for m in maps)
        return self.assemble_cube(sync_amp, free_amp, sync_idx, freqs,
                                  ref_freq, self.free_idx)
