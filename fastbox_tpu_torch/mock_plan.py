"""The host plan of a 21cm mock realisation, built once at set-up.

Both mock entry points, the single pipeline (``pipeline.make_pipeline``)
and the sharded ensemble step
(``parallel.sharded.make_sharded_ensemble_step``), build one ``MockPlan``:
the signal and instrument constants, the per-channel tables, and the P(k)
bin plan (``BinPlan``) with its choice of reduction (K4, K4t, K5 or the
plain one).  The step builds it on its slab's rows of
the leading axis, the pipeline on all of them; an entry point keeps only
what is its own (its draws, FFTs and collectives).
"""
from __future__ import annotations

import warnings
from typing import TYPE_CHECKING

import numpy as np
import torch

from .constants import C_MS
from .cosmology import Cosmology
from .grid import GridSpec
from .models import noise as noise_mod
from .ops import spectra as spectra_ops
from .ops.cuda.binned_pk import binned_pk_half_dual
from .ops.cuda.binned_pk_v2 import binned_pk_half_dual_v2
from .ops.reduce import binned_weighted_dual

if TYPE_CHECKING:
    from .pipeline import PipelineConfig

__all__ = ["BinPlan", "MockPlan", "amp_half_table"]


def _dev(a, dtype, device):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


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


def _route(pallas_pk: str, cubic: bool) -> str:
    """'v2' (K4, hoisted counts), 'v2t' (K4t, telescoped), 'v1' (K5) or
    'plain', as fastbox_tpu routes step (9) on a TPU
    (fastbox_tpu/pipeline.py:376-400)."""
    if pallas_pk == "off":
        return "plain"
    if pallas_pk == "on":
        return "v1"
    if cubic:
        return "v2t" if pallas_pk == "v2t" else "v2"
    if pallas_pk in ("v2", "v2t"):
        # stacklevel: the caller of the entry point that builds the plan
        warnings.warn(
            f"pallas_pk='{pallas_pk}' requires a cubic-exact grid "
            "(kbin_thresholds returned None); falling back to the v1 kernel"
            + (" and dropping telescoping" if pallas_pk == "v2t" else ""),
            stacklevel=5)
    return "v1"


class BinPlan:
    """The binned P(k) of step (9) on rows ``rows`` of the half spectrum's
    leading axis: the kz multiplicity, the log-spaced edges and the
    retained bins' centres ``k``, the route (``pallas_pk``: 'auto' takes
    K4 on cubic grids and K5 elsewhere) and its operands for those rows.

    ``sums`` bins one (rows, N, N/2+1) pair of power cubes; the sums of a
    partition of the rows add up to the whole cube's (K4t's differences
    are linear too).  ``finish`` turns the summed statistics into the
    outputs, over any leading batch axes.
    """

    def __init__(self, grid: GridSpec, nbins: int, pallas_pk: str, dtype,
                 device, rows: slice = slice(None), pk_debias=None):
        N = grid.N
        H = N // 2 + 1

        def dev_tensor(a, dt=dtype):
            return _dev(a, dt, device)

        kz_weight = np.full(H, 2.0, dtype=np.float64)
        kz_weight[0] = 1.0
        if N % 2 == 0:
            kz_weight[-1] = 1.0
        kzw = dev_tensor(kz_weight)
        edges = np.asarray(spectra_ops.default_kbins(grid, nbins))
        self.nb = edges.size
        e_ = np.concatenate([[0.0], edges])
        self.k = dev_tensor(0.5 * (e_[1:] + e_[:-1])[1:])
        self.debias = None
        if pk_debias is not None:
            if len(pk_debias) != self.nb - 1:
                raise ValueError(
                    f"pk_debias must have length {self.nb - 1} (the retained "
                    f"bins); got {len(pk_debias)}")
            self.debias = dev_tensor(pk_debias)
        thr = spectra_ops.kbin_thresholds(grid, edges)
        self.route = _route(pallas_pk, thr is not None)
        self.hoisted = self.route in ("v2", "v2t")
        # the full cube's weighted counts, where the route hoists them
        self.counts = None
        if self.hoisted:
            # the exact integer-lattice plan and its counts (K4, K4t)
            fi2 = spectra_ops._index_sq(grid)
            fi2_j = dev_tensor(fi2, torch.int32)
            self._ops = (fi2_j[rows].contiguous(), fi2_j,
                         dev_tensor(fi2[:H], torch.int32), kzw,
                         dev_tensor(thr, torch.int32))
            self.counts = dev_tensor(
                spectra_ops.hoisted_counts(grid, thr, kz_weight))
        elif self.route == "v1":
            # squared-space digitize operands (K5), counts from the kernel
            kx2, ky2, kz2, edges2 = spectra_ops.kbin_plan(grid, edges, dtype,
                                                          device)
            self._ops = (kx2[rows].contiguous(), ky2, kz2[:H].contiguous(),
                         kzw, edges2)
        else:
            # the bin of every half-spectrum mode, as fastbox_tpu's XLA path
            # digitizes (fastbox_tpu/pipeline.py:422-440)
            bin_idx = spectra_ops._bin_index(grid, edges, thr, H, dtype,
                                             device).reshape(N, N, H)[rows]
            w = torch.broadcast_to(kzw[None, None, :], bin_idx.shape)
            self._ops = (w.reshape(-1), bin_idx.reshape(-1))

    def sums(self, p1, p2):
        """(sum w p1, sum w p1^2, sum w p2, count) per bin over the plan's
        rows of two power cubes; the count is None where it is hoisted
        (``counts``).  The kernels read C order (cuFFT may hand back
        permuted strides)."""
        p1, p2 = p1.contiguous(), p2.contiguous()
        if self.hoisted:
            return (*binned_pk_half_dual_v2(
                p1, p2, *self._ops, telescoped=self.route == "v2t"), None)
        if self.route == "v1":
            return binned_pk_half_dual(p1, p2, *self._ops)
        s1, q1, s2, _, cnt = binned_weighted_dual(
            p1.reshape(-1), p2.reshape(-1), *self._ops, self.nb)
        return s1, q1, s2, cnt

    def finish(self, s1, q1, s2, cnt=None) -> dict:
        """The retained bins' mean cleaned power less ``pk_debias``, its
        error on the mean, and the mean density power, from the whole
        cube's sums (``counts`` where ``cnt`` is None)."""
        if cnt is None:
            cnt = self.counts
        mean1 = s1 / cnt
        var = torch.clamp(q1 / cnt - mean1 ** 2, min=0.0)
        var = torch.where(cnt > 1, var, torch.zeros_like(var))
        pk_clean = mean1[..., 1:]
        if self.debias is not None:
            pk_clean = pk_clean - self.debias
        return {"pk_cleaned": pk_clean,
                "pk_cleaned_err": (torch.sqrt(var) / torch.sqrt(cnt))[..., 1:],
                "pk_density": (s2 / cnt)[..., 1:]}


class MockPlan:
    """The host set-up of a mock realisation on rows ``rows`` of the
    leading axis, on ``device`` in ``config.dtype``: the HI bias and Tb,
    H(z) and the velocity factor, sqrt(P boxfactor) (``amp_half``, built
    from ``cosmology`` when not given), the radiometer sigma per channel,
    the foreground spectral law's tables, the instrument response, the
    boxfactor and the bin plan ``bins``.  The grids an entry point needs
    at set-up alone (the velocity weight, the beam, the k vectors) are
    made on request, so the plan holds no device tensor the call does not
    read."""

    def __init__(self, grid: GridSpec, cosmology: Cosmology,
                 config: PipelineConfig, device, rows: slice = slice(None),
                 amp_half: torch.Tensor | None = None):
        self.dtype = dtype = getattr(torch, config.dtype)
        self._grid, self._rows, self._device = grid, rows, device
        N = grid.N
        H = N // 2 + 1
        z = grid.redshift
        # Bull et al. (2015)'s fits of b_HI(z) and of Tb(z) in mK (reference
        # tracers.py:129-144, :115-117)
        self.bias = float(config.bias if config.bias is not None else
                          6.6655e-01 + 1.7765e-01 * z + 5.0223e-02 * z**2)
        self.Tb = float(5.5919e-02 + 2.3242e-01 * z - 2.4136e-02 * z**2)
        self.Hz = 100.0 * cosmology.h * cosmology.Ea
        self.vel_fac = float(100.0 * cosmology.h * cosmology.Ea
                             * cosmology.growth_rate * cosmology.scale_factor)

        if amp_half is None:
            amp_half = amp_half_table(grid, cosmology, config.linear_pk)
        if amp_half.shape != (N, N, H):
            raise ValueError(f"amp_half must be {(N, N, H)}")
        self.amp_half = amp_half[rows].to(device=device, dtype=dtype) \
            .contiguous()

        # Per-channel instrument constants
        freqs = grid.freq_array(cosmology)
        ang_x, _ = grid.pixel_array(cosmology)
        dang = ang_x[1] - ang_x[0]
        self.sigma = _dev(noise_mod.radiometer_sigma(
            freqs, ang_x, config.Tinst, config.tp_hours, config.fov_deg2,
            config.Ndish), dtype, device)
        # Foregrounds: the smoothing scales in pixels, and the spectral
        # factors in f64 on the host; the poly law needs |dalpha logf| << 1
        # (fastbox_tpu/pipeline.py:303-316)
        self.fg_sigma_pix = config.fg_smoothing_deg / dang
        self.alpha_sigma_pix = config.spec_idx_smoothing_deg / dang
        self.freqs = _dev(freqs.copy(), dtype, device)
        logf = np.log(np.asarray(freqs, np.float64) / config.freq_ref)
        self.fg_poly = (config.fg_spectral == "poly"
                        and 8.0 * config.spec_idx_std * np.abs(logf).max()
                        < 1e-2)
        self.ffac_mean = _dev(np.power(
            np.asarray(freqs, np.float64) / config.freq_ref,
            config.spec_idx_mean), dtype, device)
        self.logf = _dev(logf, dtype, device)

        # Instrument response (fastbox_tpu/pipeline.py:636-655): the beam's
        # sigma per channel (Mpc, host) and the k_par high-pass
        self._beam_sigma = self.kpar_filter = None
        if config.beam_dish_m is not None:
            fwhm = 1.22 * (C_MS / (freqs * 1e6)) / config.beam_dish_m  # rad
            self._beam_sigma = (fwhm / np.sqrt(8.0 * np.log(2.0))) \
                * cosmology.chi
        if config.kpar_min is not None:
            self.kpar_filter = 1.0 - torch.exp(
                -0.5 * (self.kvec()[2] / config.kpar_min) ** 2)

        self.boxfactor = torch.tensor(grid.boxfactor, dtype=dtype,
                                      device=device)
        self.bins = BinPlan(grid, config.nbins, config.pallas_pk, dtype,
                            device, rows, config.pk_debias)

    def kvec(self):
        """(kx on the plan's rows, ky, kz on the half axis) in the plan's
        dtype on its device."""
        kx, ky, kz = self._grid.kvec(self.dtype, self._device)
        return kx[self._rows], ky, kz[:self._grid.N // 2 + 1]

    def vz_weight(self) -> torch.Tensor:
        """The LOS velocity weight vel_fac kz / k^2 on the plan's rows of
        the half grid, zero on the Nyquist plane
        (fastbox_tpu/pipeline.py:526-533)."""
        kx, ky, kzh = self.kvec()
        k2 = (kx[:, None, None] ** 2 + ky[None, :, None] ** 2
              + kzh[None, None, :] ** 2)
        inv_k2 = torch.where(k2 > 0.0, 1.0 / torch.where(k2 > 0.0, k2, 1.0),
                             torch.zeros_like(k2))
        del k2
        vz_w = (torch.tensor(self.vel_fac, dtype=self.dtype) * kzh)[
            None, None, :] * inv_k2
        nyq_z = self._grid.nyquist_mask(2, self._device)[:kzh.numel()]
        return torch.where(nyq_z[None, None, :], torch.zeros_like(vz_w), vz_w)

    def beam(self, ny: int) -> torch.Tensor | None:
        """The beam's response on the plan's kx rows by the first ``ny``
        ky columns by channel (ny = N/2+1 after an rfft2 over (x, y), N
        after a full 2D FFT), or None without a beam."""
        if self._beam_sigma is None:
            return None
        kx, ky, _ = self.kvec()
        sig2 = torch.as_tensor(self._beam_sigma, dtype=self.dtype,
                               device=self._device) ** 2
        kperp2 = kx[:, None] ** 2 + ky[:ny][None, :] ** 2
        return torch.exp(-0.5 * kperp2[:, :, None] * sig2[None, None, :])
