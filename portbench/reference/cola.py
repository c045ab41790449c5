"""Plain reference of the COLA N-body realisation (FastBox's pycola3 path).

From a seed: complex white noise ``re + i im`` drawn from ``split(
PRNGKey(seed))`` in float32, coloured by the linear P(k) at z = 0 and
made Hermitian; 2LPT displacements (Zel'dovich plus the second-order
potential of the tidal field); then ``n_steps`` kick-drift steps of COLA
(Tassev, Zaldarriaga & Eisenstein 2013) in which each force evaluation
paints the particles by exact cloud-in-cell (``index_add_``), solves
Poisson's equation with the spectral gradient, gathers the force by
trilinear interpolation and subtracts the 2LPT acceleration; finally the
CIC density with the window deconvolved and the CIC mass-weighted
velocities.  Everything in float64 on one device; ``quant`` rounds each
stored field at each stage boundary (the control).
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.integrate import quad

from . import draws
from .cosmology import background as bg
from .cosmology.eisenstein_hu import linear_power_z0
from .cosmology.params import CosmoParams
from .mock import _KTAB, _identity, hermitian_symmetrize, loglog_interp


def _second_order_growth(D1, om):
    """D2 = -3/7 D1^2 Omega_m(a)^(-1/143) (Bouchet et al. 1995)."""
    return -3.0 / 7.0 * D1 ** 2 * om ** (-1.0 / 143.0)


def _growth(params, a):
    """(D1, f1, D2, f2) at scale factor ``a``; f2 by a finite difference
    of ln D2 in ln a."""
    a_tab, D_tab, f_tab = bg.growth_tables(params)
    la = np.log(a_tab)
    D1 = np.interp(np.log(a), la, D_tab)
    f1 = np.interp(np.log(a), la, f_tab)
    D2 = _second_order_growth(D1, bg.omega_m_of_a(params, a))
    eps = 1e-4
    D2b = _second_order_growth(np.interp(np.log(a * (1 + eps)), la, D_tab),
                               bg.omega_m_of_a(params, a * (1 + eps)))
    f2 = (np.log(abs(D2b)) - np.log(abs(D2))) / np.log(1 + eps)
    return float(D1), float(f1), float(D2), float(f2)


def _integrals(params, a1, a2):
    """(kick int da/(a H), drift int da/(a^3 H)) from a1 to a2."""
    H0 = 100.0 * params.h
    K = quad(lambda a: 1.0 / (a * bg.e_of_a(params, a)), a1, a2)[0] / H0
    D = quad(lambda a: 1.0 / (a ** 3 * bg.e_of_a(params, a)), a1, a2)[0] / H0
    return K, D


class ColaReference:
    """One COLA configuration, realised from seeds."""

    def __init__(self, config: dict, device, quant=None):
        self.device = dev = torch.device(device)
        self.q = quant or _identity
        self.N = N = int(config["nsamp"])
        self.L = L = float(config["box_mpc"])
        c = config["cola"]
        self.params = p = CosmoParams(**config["cosmology"])
        z_init, z_final = float(c["redshift_init"]), float(c["redshift"])
        n_steps = int(c["n_steps"])
        a0, a1 = 1.0 / (1.0 + z_init), 1.0 / (1.0 + z_final)
        H0 = 100.0 * p.h
        steps = np.linspace(a0, a1, n_steps + 1)
        half = 0.5 * (steps[:-1] + steps[1:])
        self.schedule = []
        for i in range(n_steps):
            Ka = _integrals(p, steps[i], half[i])[0]
            Kb = _integrals(p, half[i], steps[i + 1])[0]
            Dr = _integrals(p, steps[i], steps[i + 1])[1]
            d1a, _, d2a, _ = _growth(p, steps[i])
            d1b, _, d2b, _ = _growth(p, steps[i + 1])
            self.schedule.append((Ka + Kb, Dr, d1a, d2a, d1b - d1a,
                                  d2b - d2a, steps[i]))
        self.d1_init, _, self.d2_init, _ = _growth(p, a0)
        D1f, f1f, D2f, f2f = _growth(p, a1)
        a2H = a1 ** 2 * H0 * float(bg.e_of_a(p, a1))
        self.fac_pm = 1.5 * p.Omega_m * H0 ** 2
        self.pfac1, self.pfac2 = a2H * f1f * D1f, a2H * f2f * D2f
        self.inv_a_final = 1.0 / a1
        self.cell = L / N
        n = torch.as_tensor((N * np.fft.fftfreq(N, 1.0)).astype(np.int64),
                            device=dev)
        self.k = 2.0 * np.pi * n.double() / L
        self.H = H = N // 2 + 1
        # derivative wavenumbers: the Nyquist plane of the axis zeroed
        self.kd = torch.where(n == -(N // 2), torch.zeros_like(self.k),
                              self.k) if N % 2 == 0 else self.k
        k2 = self._k2()
        self.inv_k2 = torch.where(k2 > 0, 1.0 / torch.where(k2 > 0, k2, 1.0),
                                  torch.zeros_like(k2))
        kfull = torch.sqrt(self.k[:, None, None] ** 2
                           + self.k[None, :, None] ** 2
                           + self.k[None, None, :] ** 2)
        self.amp = torch.sqrt(loglog_interp(
            _KTAB, linear_power_z0(p, _KTAB), kfull) * float(N) ** 6 / L ** 3)
        del kfull
        # 1 / CIC window on the half spectrum
        x = self.k * self.cell / 2.0
        w = torch.where(x != 0, torch.sin(x) / torch.where(x != 0, x, 1.0),
                        torch.ones_like(x)) ** 2
        self.deconv = 1.0 / (w[:, None, None] * w[None, :, None]
                             * w[None, None, :H])

    def _k2(self):
        k, H = self.k, self.H
        return k[:, None, None] ** 2 + k[None, :, None] ** 2 \
            + k[None, None, :H] ** 2

    def _kvec(self, ax):
        kd, H = self.kd, self.H
        return (kd[:, None, None], kd[None, :, None], kd[None, None, :H])[ax]

    def _grad(self, phi_h):
        """(3, N, N, N) spectral gradient of a half-spectrum potential."""
        s = (self.N,) * 3
        return torch.stack([torch.fft.irfftn(1j * self._kvec(a) * phi_h, s)
                            for a in range(3)])

    def _corners(self, u):
        """Per axis the two cells and weights of each particle."""
        out = []
        for a in range(3):
            fl = torch.floor(u[a])
            fr = u[a] - fl
            i0 = fl.long()
            out.append(((torch.remainder(i0, self.N), 1.0 - fr),
                        (torch.remainder(i0 + 1, self.N), fr)))
        return out

    def paint(self, u, weight=None):
        """Exact CIC mass (or ``weight``) on the periodic mesh."""
        N = self.N
        mesh = torch.zeros(N ** 3, dtype=torch.float64, device=self.device)
        cx, cy, cz = self._corners(u)
        for ix, wx in cx:
            px = wx if weight is None else weight.reshape(-1) * wx
            for iy, wy in cy:
                for iz, wz in cz:
                    mesh.index_add_(0, (ix * N + iy) * N + iz, px * wy * wz)
        return mesh.reshape(N, N, N)

    def gather(self, meshes, u):
        """Trilinear interpolation of each mesh at the particles."""
        N = self.N
        cx, cy, cz = self._corners(u)
        out = torch.zeros((len(meshes), N ** 3), dtype=torch.float64,
                          device=self.device)
        flats = [m.reshape(-1) for m in meshes]
        for ix, wx in cx:
            for iy, wy in cy:
                for iz, wz in cz:
                    idx = (ix * N + iy) * N + iz
                    w = wx * wy * wz
                    for j, f in enumerate(flats):
                        out[j] += f[idx] * w
        return out

    def initial_conditions(self, seed: int):
        """2LPT positions and the displacement fields (3, N^3) each."""
        N, H, q = self.N, self.H, self.q
        white = draws.complex_normal(draws.seed_words(seed), (N,) * 3,
                                     torch.float32, self.device)
        dk = hermitian_symmetrize(q(white).to(torch.complex128) * self.amp,
                                  (0, 1, 2))[:, :, :H]
        del white
        phi1 = dk * self.inv_k2
        psi1 = q(self._grad(phi1))
        s = (N,) * 3

        def dd(a, b):
            return torch.fft.irfftn(-(self._k(a) * self._k(b)) * phi1, s)

        dxx, dyy, dzz = dd(0, 0), dd(1, 1), dd(2, 2)
        S2 = dxx * dyy + dxx * dzz + dyy * dzz
        del dxx, dyy, dzz
        S2 = S2 - dd(0, 1) ** 2 - dd(0, 2) ** 2 - dd(1, 2) ** 2
        psi2 = q(self._grad(torch.fft.rfftn(S2) * self.inv_k2))
        qgrid = torch.arange(N, dtype=torch.float64, device=self.device) \
            * self.cell
        x = torch.stack([qgrid[:, None, None].expand(s),
                         qgrid[None, :, None].expand(s),
                         qgrid[None, None, :].expand(s)])
        x = q(x + self.d1_init * psi1 + self.d2_init * psi2)
        return (x.reshape(3, -1), psi1.reshape(3, -1), psi2.reshape(3, -1))

    def _k(self, ax):
        k, H = self.k, self.H
        return (k[:, None, None], k[None, :, None], k[None, None, :H])[ax]

    def force(self, x, a):
        """PM acceleration at the particles (3, N^3)."""
        u = x / self.cell
        rho = self.q(self.paint(u))
        dk = torch.fft.rfftn(rho - 1.0)
        phi = (self.fac_pm / a) * dk * self.inv_k2
        return self.q(self.gather(list(self.q(self._grad(phi))), u))

    def realise(self, seed: int) -> dict:
        """``delta`` (N, N, N), ``vel`` (3, N, N, N) and ``rho`` (the final
        CIC mass per cell, the weight of the velocity comparison), float64
        on the device."""
        q = self.q
        x, p1, p2 = self.initial_conditions(seed)
        v = torch.zeros_like(x)
        for K, Dr, D1, D2, dD1, dD2, a in self.schedule:
            F = self.force(x, a)
            F = F - (self.fac_pm / a) * (p1 * D1 + p2 * (D2 - D1 * D1))
            v = q(v + K * F)
            del F
            x = q(torch.remainder(x + v * Dr + p1 * dD1 + p2 * dD2, self.L))
        u = x / self.cell
        rho = self.paint(u)
        s = (self.N,) * 3
        delta = q(torch.fft.irfftn(torch.fft.rfftn(rho - 1.0) * self.deconv,
                                   s))
        p_tot = v + self.pfac1 * p1 + self.pfac2 * p2
        vel = torch.stack([
            torch.where(rho > 0, self.paint(u, p_tot[c])
                        / torch.clamp(rho, min=1e-10), torch.zeros_like(rho))
            for c in range(3)]) * self.inv_a_final
        return {"delta": delta, "vel": q(vel), "rho": rho}
