"""``CosmoBox``: the reference-compatible object API over the functional core.

Counterpart of ``fastbox_tpu/box.py:37-397`` (the reference's ``CosmoBox``,
box.py:23-948).  Geometry lives in an immutable :class:`GridSpec`, the
cosmology in tables built once per redshift (cached), and randomness in a
``jax.random`` key chain, as in fastbox_tpu: ``PRNGKey(seed)``, split by
``next_key`` for every draw (``keys``), so that a seeded box gives
fastbox_tpu's box's sequence of fields, drawn on the box's device.  Each
method calls the port's functions on the box's device: ``fields/gaussian``
and ``fields/transforms``, ``ops.rsd.redshift_space_density`` (K2, K3 and
K1 on the card), ``ops.spectra.binned_power_spectrum`` (K6) and
``fields.cola.realise_density_cola`` (K11).  Field state (``delta_x``,
``delta_k``, ``velocity_k``, ``phi_k``) is kept on the object, as tensors.
Every random method also takes its numbers supplied (``white``,
``normals``).
"""
from __future__ import annotations

from functools import cached_property

import numpy as np
import torch
from scipy.integrate import simpson

from .cosmology import (Cosmology, CosmoParams, as_cosmo_params,
                        build_cosmology)
from .device import resolve
from . import keys
from .fields import gaussian, transforms
from .fields.cola import realise_density_cola as _cola
from .grid import GridSpec
from .ops import fft_safe
from .ops import rsd as rsd_ops
from .ops import spectra as spectra_ops

__all__ = ["CosmoBox", "default_cosmo"]

# Reference default cosmology (box.py:18-20); 'transfer_function' is implicit.
default_cosmo = dict(Omega_c=0.25, Omega_b=0.05, h=0.7, n_s=0.95, sigma8=0.8)


class CosmoBox:
    def __init__(self, cosmo, box_scale=1e3, nsamp=32, redshift=0.0,
                 line_freq=1420.405752, realise_now=True, seed=0, dtype=None,
                 device=None):
        """Initialise a box containing a matter distribution (box.py:25-107).

        Parameters:
            cosmo: CosmoParams or a reference-style dict.
            box_scale: side length in Mpc, or an (Lx, Ly, Lz) tuple.
            nsamp: grid points per dimension.
            redshift: redshift of the box centre.
            line_freq: emission-line rest frequency, MHz.
            realise_now: realise density/velocity/potential immediately.
            seed: integer seed of the box's key chain, jax.random.PRNGKey
                (seed) (the explicit replacement for the reference's
                np.random.seed global state).
            dtype: real dtype of fields (default: torch's default dtype).
            device: where fields live and compute (None: the CUDA card).
        """
        if not isinstance(cosmo, (dict, CosmoParams)):
            raise TypeError("`cosmo` must be a CosmoParams object or dict.")
        self.cosmo = as_cosmo_params(cosmo)
        self.grid = GridSpec.create(box_scale=box_scale, nsamp=nsamp,
                                    redshift=redshift, line_freq=line_freq)
        self.dtype = dtype or torch.get_default_dtype()
        self.device = resolve(device)
        self.set_seed(seed)
        self._cosmology_cache: dict[float, Cosmology] = {}

        self.delta_x = None
        self.delta_k = None
        self.velocity_k = None
        self.phi_k = None

        if realise_now:
            self.realise_density()
            self.realise_velocity()
            self.realise_potential()

    # ------------------------------------------------------------------
    # Plumbing
    # ------------------------------------------------------------------
    def next_key(self) -> torch.Tensor:
        """Advance and return the box's key: ``key, sub = split(key)``
        (fastbox_tpu/box.py:79-82), held on the host."""
        self._key, sub = keys.split(self._key)
        return sub

    def set_seed(self, seed: int):
        self._key = keys.PRNGKey(seed)

    def cosmology_at(self, redshift=None) -> Cosmology:
        """Cosmology tables at a given redshift, on the box's device
        (cached)."""
        z = self.redshift if redshift is None else float(redshift)
        if z not in self._cosmology_cache:
            self._cosmology_cache[z] = build_cosmology(self.cosmo, z,
                                                       device=self.device)
        return self._cosmology_cache[z]

    @property
    def cosmology(self) -> Cosmology:
        return self.cosmology_at(None)

    def _tensor(self, a):
        """An array (numpy or tensor) on the box's device."""
        return torch.as_tensor(a, device=self.device)

    # ------------------------------------------------------------------
    # Reference-compatible geometry attributes
    # ------------------------------------------------------------------
    @property
    def N(self):
        return self.grid.N

    @property
    def redshift(self):
        return self.grid.redshift

    @property
    def scale_factor(self):
        return self.grid.scale_factor

    @property
    def line_freq(self):
        return self.grid.line_freq

    @property
    def Lx(self):
        return self.grid.Lx

    @property
    def Ly(self):
        return self.grid.Ly

    @property
    def Lz(self):
        return self.grid.Lz

    @property
    def x(self):
        return self.grid.x

    @property
    def y(self):
        return self.grid.y

    @property
    def z(self):
        return self.grid.z

    @property
    def boxfactor(self):
        return self.grid.boxfactor

    @property
    def kmin(self):
        return self.grid.kmin

    @property
    def kmax(self):
        return self.grid.kmax

    @cached_property
    def k(self):
        """|k| grid (box.py:125-127), host numpy, materialised on access."""
        return self.grid.kmag(torch.float64).numpy()

    def _index_grid(self, axis: int) -> np.ndarray:
        shape = [1, 1, 1]
        shape[axis] = self.N
        return np.broadcast_to(
            self.grid.fft_index.reshape(shape).astype(np.float64),
            self.grid.shape).copy()

    @cached_property
    def Kx(self):
        """Integer FFT index grids (box.py:116-123), materialised on access."""
        return self._index_grid(0)

    @cached_property
    def Ky(self):
        return self._index_grid(1)

    @cached_property
    def Kz(self):
        return self._index_grid(2)

    # ------------------------------------------------------------------
    # Realisation engine
    # ------------------------------------------------------------------
    def _store(self, delta_x, delta_k, z, inplace: bool):
        if inplace:
            if z != self.redshift:
                print("Warning: Storing density field into self.delta_x with a "
                      "different redshift than self.redshift.")
            self.delta_x, self.delta_k = delta_x, delta_k

    def realise_density(self, linear=False, redshift=None, inplace=True,
                        white=None):
        """Gaussian density realisation (box.py:130-194) from the box's next
        key, or from the complex white noise ``white`` (N, N, N)."""
        if white is not None:
            return self.realise_density_from_whitenoise(white, linear,
                                                        redshift, inplace)
        z = self.redshift if redshift is None else redshift
        delta_x, delta_k = gaussian.realise_density(
            self.next_key(), self.grid, self.cosmology_at(z),
            linear=linear, dtype=self.dtype, device=self.device)
        self._store(delta_x, delta_k, z, inplace)
        return delta_x

    def realise_density_from_whitenoise(self, white, linear=False,
                                        redshift=None, inplace=True):
        """Colour caller-supplied complex white noise (for reproducibility
        tests and matched-seed ensembles)."""
        z = self.redshift if redshift is None else redshift
        cosmology = self.cosmology_at(z)
        pk_fn = cosmology.pk_lin if linear else cosmology.pk_nl
        delta_x, delta_k = gaussian.gaussian_field_from_whitenoise(
            self._tensor(white), self.grid, pk_fn)
        if inplace:
            self.delta_x, self.delta_k = delta_x, delta_k
        return delta_x

    def _spectrum(self, delta_x, delta_k):
        """delta_k from exactly one of the arguments, or the stored one."""
        if delta_x is not None and delta_k is not None:
            raise ValueError("delta_x and delta_k specified; can only "
                             "specify one")
        if delta_x is not None:
            return fft_safe.fftn(self._tensor(delta_x))
        return self.delta_k if delta_k is None else self._tensor(delta_k)

    def realise_velocity(self, delta_x=None, delta_k=None, redshift=None,
                         inplace=True):
        """Linear velocity field in Fourier space (box.py:197-290): a tuple of
        the three complex components."""
        delta_k = self._spectrum(delta_x, delta_k)
        z = self.redshift if redshift is None else redshift
        velocity_k = tuple(gaussian.realise_velocity(
            delta_k, self.grid, self.cosmology_at(z)).unbind(0))
        if inplace:
            self.velocity_k = velocity_k
        return velocity_k

    def realise_potential(self, delta_x=None, delta_k=None, redshift=None,
                          inplace=True, apply_prefactor=False):
        """Potential field phi_k = delta_k / k^2 (box.py:293-353).

        The reference never applies its physical prefactor (box.py:343-347);
        pass ``apply_prefactor=True`` for the intended physics.
        """
        delta_k = self._spectrum(delta_x, delta_k)
        z = self.redshift if redshift is None else redshift
        phi_k = gaussian.realise_potential(delta_k, self.grid,
                                           self.cosmology_at(z),
                                           apply_prefactor=apply_prefactor)
        if inplace:
            self.phi_k = phi_k
        return phi_k

    def realise_density_cola(self, redshift=None, redshift_init=15.0,
                             keep_velocities=True, seed=None, inplace=True,
                             n_steps=None, white=None):
        """2LPT+COLA approximate N-body realisation (box.py:463-589):
        ``fields.cola.realise_density_cola`` on the box's device (K11 on
        the card).  The noise is ``white`` (complex (N, N, N)) or drawn from
        ``PRNGKey(seed)``, else from the box's next key
        (fastbox_tpu/box.py:268).  Returns
        ``delta_x`` or ``(delta_x, vel_x, vel_y, vel_z)`` like the
        reference."""
        z = self.redshift if redshift is None else redshift
        if white is not None:
            key = None
        else:
            key = keys.PRNGKey(seed) if seed is not None else self.next_key()
        delta_x, vel = _cola(key, self.grid, self.cosmology_at(z), redshift=z,
                             redshift_init=redshift_init, n_steps=n_steps,
                             dtype=self.dtype, keep_velocities=keep_velocities,
                             white=None if white is None
                             else self._tensor(white), device=self.device)
        if inplace:
            self.delta_x = delta_x
            self.delta_k = fft_safe.fftn(delta_x)
        if keep_velocities:
            return delta_x, vel[0], vel[1], vel[2]
        return delta_x

    # ------------------------------------------------------------------
    # Transforms
    # ------------------------------------------------------------------
    def lognormal(self, delta_x):
        """Log-normal transform (box.py:441-460)."""
        return transforms.lognormal(self._tensor(delta_x))

    def apply_transfer_fn(self, field_k, transfer_fn):
        """Anisotropic (k_perp, k_par) transfer function (box.py:356-381)."""
        return transforms.apply_transfer_fn(self._tensor(field_k), self.grid,
                                            transfer_fn)

    def smooth_field(self, field_k, R):
        """Top-hat smoothing; R in Mpc/h (box.py:635-655)."""
        return transforms.smooth_field(self._tensor(field_k), self.grid, R,
                                       self.cosmo.h)

    def window(self, k, R):
        return transforms.window(torch.as_tensor(k), R)

    def window1(self, k, R):
        return transforms.window1(torch.as_tensor(k), R)

    def redshift_space_density(self, delta_x=None, velocity_z=None,
                               sigma_nl=0.0, method="linear", normals=None):
        """RSD remap of a density cube along every line of sight
        (box.py:384-438).  With ``sigma_nl > 0`` the incoherent velocities
        are drawn from the box's next key, or taken from ``normals``
        (grid-shaped unit normals)."""
        Hz = 100.0 * self.cosmo.h * self.cosmology.Ea
        key = (self.next_key() if sigma_nl > 0.0 and normals is None
               else None)
        return rsd_ops.redshift_space_density(
            self._tensor(delta_x), self._tensor(velocity_z), self.grid, Hz,
            sigma_nl=sigma_nl, key=key,
            normals=None if normals is None else self._tensor(normals),
            method=method)

    # ------------------------------------------------------------------
    # Estimators
    # ------------------------------------------------------------------
    def binned_power_spectrum(self, delta_x=None, delta_k=None, nbins=20,
                              kbins=None):
        """Binned 1D P(k) (box.py:696-768), on the full spectrum (K6)."""
        return spectra_ops.binned_power_spectrum(
            self.grid, delta_k=self._spectrum(delta_x, delta_k), nbins=nbins,
            kbins=kbins)

    def theoretical_power_spectrum(self):
        """Theory nonlinear P(k) on k in 10^[-3.5, 1] (box.py:770-782)."""
        k = np.logspace(-3.5, 1.0, int(1e3))
        return k, self.cosmology.pk_nl(k).cpu().numpy()

    def sigmaR(self, R):
        """RMS of the realisation smoothed with a top-hat of R Mpc/h
        (box.py:657-683): Simpson's rule over the binned P(k)."""
        kc, pk, _ = self.binned_power_spectrum()
        kc = kc.double().cpu().numpy()
        pk = pk.double().cpu().numpy()
        good = ~np.isnan(pk)
        kc, pk = kc[good], pk[good]
        w = transforms.window(torch.as_tensor(kc), R / self.cosmo.h).numpy()
        integral = simpson(kc**2 * pk * w, x=kc)
        return np.sqrt(integral / (2.0 * np.pi**2))

    def sigma8(self):
        """sigmaR at 8 Mpc/h (box.py:685-694)."""
        return self.sigmaR(8.0)

    # ------------------------------------------------------------------
    # Observational coordinates
    # ------------------------------------------------------------------
    def freq_array(self, redshift=None):
        """Descending frequency channels along z, MHz (box.py:789-828)."""
        return self.grid.freq_array(self.cosmology_at(redshift))

    def pixel_array(self, redshift=None):
        """Angular pixel coordinates in degrees (box.py:831-864)."""
        return self.grid.pixel_array(self.cosmology_at(redshift))

    # ------------------------------------------------------------------
    # Built-in consistency tests (box.py:871-948)
    # ------------------------------------------------------------------
    def test_parseval(self):
        """sum(delta_x^2) N^3 == sum |delta_k|^2 (box.py:931-948)."""
        s1 = float(torch.sum(self.delta_x**2) * self.N**3)
        s2 = float(torch.sum(self.delta_k * torch.conj(self.delta_k)).real)
        print("Parseval test:", s1 / s2, "(should be 1.0)")
        return s1, s2

    def test_sampling_error(self):
        """sigma8 sampling-window report (box.py:871-928)."""
        cosmology = self.cosmology
        R8 = 8.0 / self.cosmo.h

        s8_real = self.sigma8()

        def theory(k):
            pk = cosmology.pk_nl(k).cpu().numpy()
            w = transforms.window(torch.as_tensor(k), R8).numpy()
            y = np.nan_to_num(k**2 * pk * w)
            return np.sqrt(simpson(y, x=k) / (2.0 * np.pi**2))

        s8_th_win = theory(np.linspace(self.kmin, self.kmax, int(5e3)))
        s8_th_full = theory(np.logspace(-5, 2, int(5e4)))
        dx = transforms.smooth_field(self.delta_k, self.grid, 8.0,
                                     self.cosmo.h)
        s8_realspace = float(torch.std(dx.real, correction=0))

        print("")
        print("sigma8 (real.): \t", s8_real)
        print("sigma8 (th.win.):\t", s8_th_win)
        print("sigma8 (th.full):\t", s8_th_full)
        print("sigma8 (realsp.):\t", s8_realspace)
        print("ratio =", s8_realspace / s8_real)
        return s8_real, s8_th_win, s8_th_full, s8_realspace
