"""Plain reference of the mock 21cm survey (FastBox's end-to-end example).

From a seed it works out one realisation of the configuration in float64
on a device, with plain torch: the keyed draws (``draws``), the density
half-spectrum x sqrt(P), the log-normal HI field, the linear LOS velocity
plus the sigma_NL dispersion, the redshift-space remap (periodic wrap,
sort, linear interpolation, the hull fill), Tb, the diffuse foregrounds
(C_ell power law, spectral-index map), the radiometer noise, the PCA clean
and both binned spectra on the integer k-lattice.  Two draw schemes, as the
program has them:

* ``'rows'``: every field drawn row by row, row ``r`` of field ``tag``
  with ``fold_in(fold_in(PRNGKey(seed), tag), r)`` (the sharded step);
* ``'keys'``: ``split(PRNGKey(seed), 5)`` and whole-array draws (the
  single pipeline and its chain).

``quant`` rounds every stored field at each stage boundary (the control
passes a bfloat16 rounding); the identity keeps float64 throughout.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import compare, draws
from .cosmology import background as bg
from .cosmology.constants import C_KMS, LINE_FREQ_21CM
from .cosmology.eisenstein_hu import linear_power_z0
from .cosmology.halofit import halofit_power
from .cosmology.params import CosmoParams

# row-stream tags of the sharded step (fastbox_tpu's parallel/rng.py)
TAGS = {"density": 1, "sigma_nl": 17, "fg_re": 101, "fg_im": 102,
        "alpha": 103, "noise": 202}
_KTAB = np.logspace(-5.0, 3.0, 8192)


def _identity(x):
    return x


def loglog_interp(k_tab: np.ndarray, p_tab: np.ndarray, k: torch.Tensor):
    """P(k) by linear interpolation of ln P in ln k; 0 at k <= 0."""
    lnk = torch.as_tensor(np.log(k_tab), dtype=torch.float64,
                          device=k.device)
    lnp = torch.as_tensor(np.log(p_tab), dtype=torch.float64,
                          device=k.device)
    x = torch.log(torch.where(k > 0, k, torch.ones_like(k))).reshape(-1)
    i = torch.clamp(torch.searchsorted(lnk, x) - 1, 0, lnk.numel() - 2)
    w = torch.clamp((x - lnk[i]) / (lnk[i + 1] - lnk[i]), 0.0, 1.0)
    p = torch.exp(lnp[i] * (1.0 - w) + lnp[i + 1] * w).reshape(k.shape)
    return torch.where(k > 0, p, torch.zeros_like(p))


def gaussian_kernel_spectrum(sigma_pix: float, n: int) -> np.ndarray:
    """FFT of scipy.ndimage's truncated (4 sigma), normalised Gaussian,
    wrapped circularly onto n points."""
    radius = int(4.0 * sigma_pix + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 * (x / sigma_pix) ** 2)
    phi /= phi.sum()
    k = np.zeros(n)
    np.add.at(k, x.astype(int) % n, phi)
    return np.fft.fft(k)


def hermitian_symmetrize(a: torch.Tensor, dims) -> torch.Tensor:
    """(a + conj(a at -k)) / 2 over ``dims``."""
    rev = torch.roll(torch.flip(a, dims), (1,) * len(dims), dims)
    return 0.5 * (a + torch.conj(rev))


class Geometry:
    """The cubic box and its cosmology, on the host in float64."""

    def __init__(self, config: dict):
        self.N = N = int(config["nsamp"])
        self.L = L = float(config["box_mpc"])
        self.redshift = z = float(config["redshift"])
        self.params = CosmoParams(**config["cosmology"])
        self.a = a = 1.0 / (1.0 + z)
        self.Ea = float(bg.e_of_a(self.params, a))
        self.f = float(bg.growth_rate(self.params, a))
        self.chi = float(bg.comoving_radial_distance(self.params, a))
        self.Hz = 100.0 * self.params.h * self.Ea
        self.n = (N * np.fft.fftfreq(N, 1.0)).astype(np.int64)
        self.k1d = 2.0 * np.pi * self.n / L
        self.boxfactor = float(N) ** 6 / L ** 3
        self.z = np.linspace(-0.5 * L, 0.5 * L, N)

    def pk_tables(self):
        """(k, P_lin(k, z), P_nl(k, z)) of the configuration's redshift."""
        pk0 = linear_power_z0(self.params, _KTAB)
        D = float(bg.growth_factor(self.params, self.a))
        plin = pk0 * D ** 2
        return _KTAB, plin, halofit_power(self.params, _KTAB, plin, self.a)


class MockReference:
    """One configuration of the mock survey, realised from seeds."""

    def __init__(self, config: dict, device, quant=None):
        self.device = torch.device(device)
        self.q = quant or _identity
        g = self.geo = Geometry(config)
        p = self.p = config["pipeline"]
        N, H, dev = g.N, g.N // 2 + 1, self.device
        f64 = torch.float64
        self.bias = 6.6655e-01 + 1.7765e-01 * g.redshift \
            + 5.0223e-02 * g.redshift ** 2          # Bull et al. 2015 b_HI
        self.Tb = 5.5919e-02 + 2.3242e-01 * g.redshift \
            - 2.4136e-02 * g.redshift ** 2          # Tb(z) in mK
        kx = torch.as_tensor(g.k1d, dtype=f64, device=dev)
        kzh = kx[:H]
        k2 = kx[:, None, None] ** 2 + kx[None, :, None] ** 2 \
            + kzh[None, None, :] ** 2
        kt, _, pnl = g.pk_tables()
        self.amp = torch.sqrt(loglog_interp(kt, pnl, torch.sqrt(k2))
                              * g.boxfactor)
        vel_fac = g.Hz * g.f * g.a
        inv_k2 = torch.where(k2 > 0, 1.0 / torch.where(k2 > 0, k2, 1.0),
                             torch.zeros_like(k2))
        vz_w = vel_fac * kzh[None, None, :] * inv_k2
        if N % 2 == 0:
            vz_w[:, :, H - 1] = 0.0      # the Nyquist plane carries none
        self.vz_w = vz_w
        del k2, inv_k2
        # frequencies (descending along z) and angular pixels
        a, line = g.a, LINE_FREQ_21CM
        dx = g.L / N
        df = dx * line * (a ** 2 * g.Hz) / C_KMS
        self.freqs = (a * line + df * (np.arange(N) - 0.5 * (N - 1.0)))[::-1]
        x_px = g.L / (N - 1)
        dang = (180.0 / np.pi) * (x_px / g.chi)
        # radiometer noise RMS per channel (mK)
        dnu = abs(self.freqs[1] - self.freqs[0]) * 1e6
        t_res = p["tp_hours"] * 3600.0 * dang ** 2 / p["fov_deg2"]
        tsys = p["Tinst"] * 1e3 + 60e3 * (self.freqs / 300.0) ** -2.5
        self.sigma_noise = torch.as_tensor(
            tsys / np.sqrt(p["Ndish"] * t_res * dnu), dtype=f64, device=dev)
        # foregrounds: sqrt(C_ell) N^2 / sqrt(L^2), smoothing spectra
        kp = torch.sqrt(kx[:, None] ** 2 + kx[None, :] ** 2)
        ell = 0.5 * kp * g.chi / 1000.0
        c_ell = torch.where(ell > 0, p["fg_amp"] * torch.where(
            ell > 0, ell, torch.ones_like(ell)) ** p["fg_beta"],
            torch.zeros_like(ell)) * (N ** 4 / (g.L * g.L))
        sm = torch.as_tensor(gaussian_kernel_spectrum(
            p["fg_smoothing_deg"] / dang, N), device=dev)
        self.fg_filter = torch.sqrt(c_ell) * sm[:, None] * sm[None, :]
        sa = torch.as_tensor(gaussian_kernel_spectrum(
            p["spec_idx_smoothing_deg"] / dang, N), device=dev)
        self.alpha_filter = sa[:, None] * sa[None, :]
        logf = np.log(self.freqs / p["freq_ref"])
        self.logf = torch.as_tensor(logf, dtype=f64, device=dev)
        self.ffac_mean = torch.as_tensor(np.exp(p["spec_idx_mean"] * logf),
                                         dtype=f64, device=dev)
        # the bins: log edges on [kmin, kmax], classified on the exact
        # integer lattice |n|^2 >= ceil((edge / kappa)^2)
        edges = np.logspace(np.log10(2 * np.pi / g.L),
                            np.log10(2 * np.pi * np.sqrt(3.0) * N / g.L),
                            p["nbins"])
        thr = np.ceil((edges / (2 * np.pi / g.L)) ** 2 * (1 - 1e-12))
        n2 = torch.as_tensor(g.n ** 2, device=dev)
        m = n2[:, None, None] + n2[None, :, None] + n2[:H][None, None, :]
        self.nb = len(edges)
        self.bin = torch.searchsorted(torch.as_tensor(thr, device=dev)
                                      .to(torch.int64), m.reshape(-1),
                                      right=True)
        w = torch.full((H,), 2.0, dtype=f64, device=dev)
        w[0] = 1.0
        if N % 2 == 0:
            w[-1] = 1.0
        self.wz = w.expand(N, N, H).reshape(-1)
        self.counts = self._bin_sum(torch.ones_like(self.wz))

    # ------------------------------------------------------------------
    def _bin_sum(self, values: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(self.nb + 1, dtype=torch.float64,
                          device=self.device)
        out.index_add_(0, self.bin, values.reshape(-1) * self.wz)
        return out[:self.nb]

    def _draw_fields(self, seed: int, scheme: str) -> dict:
        """The float32 draws of the realisation, as the program makes them,
        widened to float64."""
        g, dev = self.geo, self.device
        N, H = g.N, g.N // 2 + 1
        f32 = torch.float32
        if scheme == "rows":
            def rows(tag, shape):
                return draws.row_normal([seed], TAGS[tag], N, shape, f32,
                                        dev)[0].double()
            white = rows("density", (N, N))
            dk = torch.fft.rfftn(self.q(white)) * N ** -1.5
            return {
                "delta_k": dk * self.amp,
                "rsd": rows("sigma_nl", (N, N)),
                "fg": torch.complex(rows("fg_re", (N,)), rows("fg_im", (N,))),
                "alpha": rows("alpha", (N,)),
                "noise": rows("noise", (N, N))}
        if scheme != "keys":
            raise ValueError(f"unknown draw scheme '{scheme}'")
        five = draws.split(draws.seed_words(seed), 5)
        k_int, k_z0, k_nyq = draws.split(five[0], 3)
        half = draws.complex_normal(k_int, (N, N, H), f32, dev) \
            * np.float32(math.sqrt(0.5))
        planes = [(0, k_z0)] + ([(H - 1, k_nyq)] if N % 2 == 0 else [])
        half = half.to(torch.complex128)
        for kz, key in planes:
            half[:, :, kz] = hermitian_symmetrize(
                draws.complex_normal(key, (N, N), f32, dev)
                .to(torch.complex128), (0, 1))
        return {
            "delta_k": self.q(half) * self.amp,
            "rsd": draws.normal(five[1], (N, N, N), f32, dev).double(),
            "fg": draws.complex_normal(five[2], (N, N), f32, dev)
            .to(torch.complex128),
            "alpha": draws.normal(five[3], (N, N), f32, dev).double(),
            "noise": draws.normal(five[4], (N, N, N), f32, dev).double()}

    def _remap(self, delta: torch.Tensor, vel: torch.Tensor) -> torch.Tensor:
        """Redshift-space remap along z: each cell moves to s = z - v/H,
        wrapped into the box; the field at the grid z is the linear
        interpolation of the moved cells, sorted per line of sight, and
        ``(delta[0] + delta[-1]) / 2`` outside their hull."""
        g = self.geo
        N = g.N
        z = torch.as_tensor(g.z, dtype=torch.float64, device=self.device)
        z0, span = z[0], z[-1] - z[0]
        s = torch.remainder(z - vel / g.Hz - z0, span) + z0
        s = s.reshape(N * N, N)
        vals = delta.reshape(N * N, N)
        fill = 0.5 * (vals[:, 0] + vals[:, -1])
        ss, order = torch.sort(s, dim=1, stable=True)
        vv = torch.gather(vals, 1, order)
        t = z[None, :].expand(N * N, N).contiguous()
        i0 = torch.clamp(torch.searchsorted(ss, t, right=True) - 1, 0, N - 2)
        x0, x1 = torch.gather(ss, 1, i0), torch.gather(ss, 1, i0 + 1)
        y0, y1 = torch.gather(vv, 1, i0), torch.gather(vv, 1, i0 + 1)
        gap = x1 - x0
        w = torch.where(gap > 0, (t - x0) / torch.where(gap > 0, gap, 1.0),
                        torch.zeros_like(gap))
        out = y0 + w * (y1 - y0)
        inside = (t >= ss[:, :1]) & (t <= ss[:, -1:])
        return torch.where(inside, out, fill[:, None]).reshape(N, N, N)

    def realise(self, seed: int, scheme: str) -> dict:
        """The program's outputs for the realisation of ``seed``: ``k`` bins
        1..nbins-1 of ``pk_cleaned``, ``pk_cleaned_err``, ``pk_density``,
        and ``sigma_data``, as float64 numpy."""
        g, p, q = self.geo, self.p, self.q
        N = g.N
        d = self._draw_fields(seed, scheme)
        delta_k = d["delta_k"]
        s = (N, N, N)
        delta_x = q(torch.fft.irfftn(delta_k, s))
        vel = q(torch.fft.irfftn(1j * self.vz_w * delta_k, s))
        e = torch.exp(delta_x * self.bias)
        delta_ln = q(e / e.mean() - 1.0)
        del e, delta_x
        vel = q(vel + p["sigma_nl"] * q(d["rsd"]))
        data = q(self.Tb * (1.0 + self._remap(delta_ln, vel)))
        del delta_ln, vel
        fg_x = torch.fft.ifft2(q(d["fg"]) * self.fg_filter).real \
            + p["fg_monopole"]
        dalpha = torch.fft.ifft2(torch.fft.fft2(
            p["spec_idx_std"] * q(d["alpha"])) * self.alpha_filter).real
        fg = q(fg_x[:, :, None] * self.ffac_mean
               * torch.exp(dalpha[:, :, None] * self.logf))
        data = q(data + fg)
        del fg
        data = q(data + self.sigma_noise * q(d["noise"]))
        sigma = torch.std(data, correction=0)
        # PCA clean over the frequency axis
        d2 = data.reshape(N * N, N)
        mean = d2.mean(dim=0, keepdim=True)
        x = d2 - mean
        cov = x.T @ x / (N * N - 1)
        _, vec = torch.linalg.eigh(cov)
        U = torch.flip(vec, (1,))[:, :p["pca_nmodes"]]
        cleaned = q((d2 - (x @ U @ U.T + mean)).reshape(N, N, N))
        del d2, x, data
        ck = torch.fft.rfftn(cleaned)
        p_clean = (ck.real ** 2 + ck.imag ** 2) / g.boxfactor
        p_dens = (delta_k.real ** 2 + delta_k.imag ** 2) / g.boxfactor
        cnt = self.counts
        s1 = self._bin_sum(p_clean)
        q1 = self._bin_sum(p_clean ** 2)
        s2 = self._bin_sum(p_dens)
        mean1 = s1 / cnt
        var = torch.clamp(q1 / cnt - mean1 ** 2, min=0.0)
        var = torch.where(cnt > 1, var, torch.zeros_like(var))
        out = {"pk_cleaned": mean1[1:],
               "pk_cleaned_err": (torch.sqrt(var) / torch.sqrt(cnt))[1:],
               "pk_density": (s2 / cnt)[1:], "sigma_data": sigma}
        return {k: v.cpu().numpy() for k, v in out.items()}

    def outputs(self, seeds, scheme: str) -> dict:
        """:meth:`realise` of each seed, stacked on a leading axis as the
        program stacks a batch."""
        rs = [self.realise(s, scheme) for s in seeds]
        return {k: np.stack([r[k] for r in rs]) for k in rs[0]}


def sample_gaps(config: dict, samples, scheme: str, device) -> dict:
    """The widest gaps (``compare.mock_gaps``) over the realisations of
    the sampled calls ``[(seeds, outputs stacked per realisation)]``."""
    ref = MockReference(config, device)
    return compare.worst(
        compare.mock_gaps({k: out[k][j] for k in compare.MOCK_OUTPUTS},
                          ref.realise(s, scheme))
        for seeds, out in samples for j, s in enumerate(seeds))
