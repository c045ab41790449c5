"""COLA (COmoving Lagrangian Acceleration) approximate N-body engine.

Torch counterpart of ``fastbox_tpu/fields/cola.py``, the native
replacement for the reference's optional pycola3 dependency
(box.py:463-589): 2LPT initial conditions plus a particle-mesh leapfrog in
which particles evolve *relative to* their 2LPT trajectories (Tassev,
Zaldarriaga & Eisenstein 2013), so ~10 steps give accurate quasi-linear
structure.  Each force evaluation paints the particles with CIC, solves
Poisson's equation in k space, differentiates spectrally (or by finite
differences) and gathers the force back at the particles; kicks and drifts
use host-precomputed step integrals.

Units: comoving Mpc, velocities in km/s (momentum p = a^2 dx/dt), H in
km/s/Mpc.  Force: lap(phi) = (3/2) Omega_m H0^2 delta / a.  The COLA
compensation subtracts the LPT acceleration
d(p_lpt)/dt = (3/2) Omega_m H0^2 / a [D1 psi1 + (D2 - D1^2) psi2].

The state (x, v and the LPT fields p1, p2, each (3, N, N, N)) stays on the
device through one Python loop over the steps, updated in place; at 512^3
in f32 it is 6.4 GB.  The CIC paint and force gather take the lattice
form (K11, ``ops/cuda/lattice_cic.py``) under an adaptive band ladder, and
the exact CIC tier beyond the widest band (K13, ``ops/cuda/cic_exact.py``:
one paint and one three-mesh gather a force evaluation).  The band is
picked on the host from ``maxd.item()``: one device sync per force
evaluation and one at the finish.  Each step's kick and drift are one
pass over the state (K12, ``ops/cuda/cola_kick.py``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from scipy.integrate import quad

from .. import timing
from ..cosmology import background as bg
from ..device import resolve
from ..grid import GridSpec
from ..ops import fft_safe
from ..ops.cuda import cic_exact as exact
from ..ops.cuda import cola_kick as kick
from ..ops.cuda import lattice_cic as k11
from ..ops.painting import compensation
from . import lattice_cic as twin
from .gaussian import gaussian_field_from_whitenoise, white_noise
from .lpt import lpt_displacements, second_order_growth

__all__ = ["realise_density_cola", "ColaEngine", "cic_paint_particles",
           "cic_gather", "cic_gather3_particles"]


# ----------------------------------------------------------------------
# Exact CIC scatter / gather on the periodic grid (cell units): K13 on
# CUDA tensors, the plain passes on CPU tensors (ops/cuda/cic_exact.py)
# ----------------------------------------------------------------------
cic_paint_particles = exact.cic_paint_exact
cic_gather3_particles = exact.cic_gather_exact


def cic_gather(mesh, u):
    """Trilinear (CIC) interpolation of a periodic (N, N, N) mesh at
    positions ``u`` (cell units; (M, 3) or a component tuple)."""
    return cic_gather3_particles((mesh,), u)[0]


# ----------------------------------------------------------------------
# Host-side step schedule (numpy/scipy, as in fastbox_tpu).  Seed-free, so
# built once for each configuration: the schedule and the scalars are
# memoised as immutable tuples of floats, keyed by the frozen CosmoParams
# and the scale factors; the engine's 1-D k vectors by grid, dtype and
# device.
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=32)
def _growth_scalars(params, a):
    a_tab, D_tab, f_tab = bg.growth_tables(params)
    D1 = np.interp(np.log(a), np.log(a_tab), D_tab)
    f1 = np.interp(np.log(a), np.log(a_tab), f_tab)
    om = bg.omega_m_of_a(params, a)
    D2 = second_order_growth(D1, om)
    # f2 = dlnD2/dlna from D2(a) = -3/7 D1^2 om^(-1/143), numerically
    eps = 1e-4
    f2 = (np.log(np.abs(second_order_growth(
        np.interp(np.log(a * (1 + eps)), np.log(a_tab), D_tab),
        bg.omega_m_of_a(params, a * (1 + eps)))))
        - np.log(np.abs(D2))) / np.log(1 + eps)
    return float(D1), float(f1), float(D2), float(f2)


def _kick_drift_integrals(params, a1, a2):
    """Kick dt = int da/(a H) (dp/da = F/(aH)) and drift
    int da/(a^3 H) (dx/da = p/(a^3 H)), with p = a^2 dx/dt."""
    H0 = 100.0 * params.h
    K = quad(lambda a: 1.0 / (a * bg.e_of_a(params, a)), a1, a2)[0] / H0
    D = quad(lambda a: 1.0 / (a**3 * bg.e_of_a(params, a)), a1, a2)[0] / H0
    return K, D


@functools.lru_cache(maxsize=32)
def _step_schedule(params, a_init: float, a_final: float, n_steps: int):
    """Per step (K1, K2, Dr, D1, D2, dD1, dD2, a_force): the half kicks, the
    drift, the growth factors at the step start and their increments, as
    a tuple of tuples."""
    a_steps = np.linspace(a_init, a_final, n_steps + 1)
    a_half = 0.5 * (a_steps[:-1] + a_steps[1:])
    rows = []
    for i in range(n_steps):
        K1, _ = _kick_drift_integrals(params, a_steps[i], a_half[i])
        K2, _ = _kick_drift_integrals(params, a_half[i], a_steps[i + 1])
        _, Dr = _kick_drift_integrals(params, a_steps[i], a_steps[i + 1])
        d1a, _, d2a, _ = _growth_scalars(params, a_steps[i])
        d1b, _, d2b, _ = _growth_scalars(params, a_steps[i + 1])
        rows.append((K1, K2, Dr, d1a, d2a, d1b - d1a, d2b - d2a,
                     float(a_steps[i])))
    return tuple(rows)


@functools.lru_cache(maxsize=32)
def _k_vectors(Nf: int, N: int, L: float, dtype, device):
    """The engine's 1-D k vectors on ``device`` (an indexed device):
    (kf, kf's half axis, both with the Nyquist plane zeroed for the
    derivative, the particle-Nyquist masks on the full and half axes).
    Shared by every engine of the configuration: never written in place."""
    Hf = Nf // 2 + 1
    kf = 2.0 * np.pi * np.fft.fftfreq(Nf, d=1.0 / Nf) / L
    # Zero the derivative axis's Nyquist plane: in the full-FFT form
    # the .real projection drops exactly that (anti-Hermitian) plane.
    nyq_full = np.zeros(Nf, bool)
    nyq_half = np.zeros(Hf, bool)
    if Nf % 2 == 0:
        nyq_full[Nf // 2] = True
        nyq_half[-1] = True

    def vec(a):
        timing.count_copy("h2d_cola_k", device)
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    m1 = np.abs(kf) <= np.pi * N / L * (1 + 1e-12)
    return (vec(kf).to(dtype), vec(kf[:Hf]).to(dtype),
            vec(np.where(nyq_full, 0.0, kf)).to(dtype),
            vec(np.where(nyq_half, 0.0, kf[:Hf])).to(dtype),
            vec(m1), vec(m1[:Hf]))


def _plan_misses() -> int:
    """The misses of the host plan's memos so far (the step schedule, the
    growth scalars and the k vectors)."""
    return sum(f.cache_info().misses
               for f in (_step_schedule, _growth_scalars, _k_vectors))


def _fuse_max_band(fuse_force_gather) -> int:
    """False -> 0 (never fuse), True -> every band, an int B -> fuse the
    three-mesh force gather only for ladder bands <= B."""
    if isinstance(fuse_force_gather, bool):
        return 99 if fuse_force_gather else 0
    return int(fuse_force_gather)


def _maxabs(d) -> float:
    """max |d| over the three components, on the host (one sync)."""
    timing.count("sync.cola_band")
    return torch.stack([c.abs().max() for c in d]).max().item()


# ----------------------------------------------------------------------
# Engine
# ----------------------------------------------------------------------
class ColaEngine:
    """One COLA configuration on one device: the schedule, the initial
    conditions, the PM force, the kick-drift step and the final paint.

    ``realise_density_cola`` drives it; the pieces are public so that a
    check can hold one force evaluation of two lattice implementations
    against each other on the same state.  Parameters are those of
    :func:`realise_density_cola`.
    """

    def __init__(self, grid: GridSpec, cosmology, redshift=None,
                 redshift_init: float = 15.0, n_steps: int | None = None,
                 dtype=torch.float32, device=None,
                 keep_velocities: bool = True, force_factor: int = 1,
                 lattice_B: int | None = 3, lattice_impl: str = "auto",
                 gradient: str = "spectral",
                 fuse_force_gather: bool | int = True,
                 diagnostics: bool = False):
        if not grid.Lx == grid.Ly == grid.Lz:
            raise ValueError("COLA requires a cubic box")
        self.device = device = resolve(device)
        if lattice_impl == "auto":
            lattice_impl = "cuda" if device.type == "cuda" else "plain"
        if lattice_impl not in ("plain", "cuda"):
            raise ValueError(f"Unknown lattice_impl '{lattice_impl}'")
        if lattice_impl == "cuda" and device.type != "cuda":
            raise ValueError("lattice_impl='cuda' needs a CUDA device, "
                             f"got {device}")
        if gradient not in ("spectral", "fd4", "fd6"):
            raise ValueError(f"Unknown gradient '{gradient}'")
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"dtype must be float32 or float64, got {dtype}")
        params = cosmology.params
        z_final = grid.redshift if redshift is None else redshift
        if not redshift_init > z_final:
            raise ValueError("Must have redshift_init > redshift")
        if n_steps is None:
            n_steps = int(1 + redshift_init)

        self.grid, self.cosmology = grid, cosmology
        self.dtype = dtype
        self.np_dtype = np.float32 if dtype == torch.float32 else np.float64
        self.keep_velocities = bool(keep_velocities)
        self.diagnostics = bool(diagnostics)
        self.lattice_impl, self.gradient = lattice_impl, gradient
        self.N = N = grid.N
        self.force_factor = ff = int(force_factor)
        self.Nf = Nf = N * ff
        self.cell = grid.Lx / N
        self.cell_f = grid.Lx / Nf
        self.lattice_B = lattice_B
        self.use_lattice = ff == 1 and lattice_B is not None
        # Adaptive band ladder: the kernel cost grows with the band, max|d|
        # grows smoothly over the evolution, so each force evaluation takes
        # the smallest band covering the current displacements; beyond the
        # widest band the exact scatter runs.
        self.bands = () if not self.use_lattice else tuple(
            b for b in range(1, int(lattice_B) + 1) if 2 * b + 2 <= N)
        self.fuse_band = _fuse_max_band(fuse_force_gather)
        if lattice_impl == "cuda":
            self._paint = k11.cic_paint_lattice_cuda
            self._gather = k11.cic_gather_lattice_cuda
            self._gather3 = k11.cic_gather3_lattice_cuda
        else:
            self._paint = k11.cic_paint_lattice_plain
            self._gather = k11.cic_gather_lattice_plain
            self._gather3 = k11.cic_gather3_lattice_plain

        # --- host schedule and scalars (memoised), rounded to dtype as
        # fastbox_tpu's step_consts / scal arrays are
        misses = _plan_misses()
        a_init = 1.0 / (1.0 + redshift_init)
        a_final = 1.0 / (1.0 + z_final)
        H0 = 100.0 * params.h
        self.n_steps = int(n_steps)
        self.rows = [tuple(self._s(v) for v in row) for row in
                     _step_schedule(params, a_init, a_final, self.n_steps)]
        d1_init, _, d2_init, _ = _growth_scalars(params, a_init)
        D1_f, f1_f, D2_f, f2_f = _growth_scalars(params, a_final)
        a2H = a_final**2 * H0 * float(bg.e_of_a(params, a_final))
        self.d1_init, self.d2_init = self._s(d1_init), self._s(d2_init)
        self.fac_pm = self._s(1.5 * params.Omega_m * H0**2)
        self.pfac1 = self._s(a2H * f1_f * D1_f)
        self.pfac2 = self._s(a2H * f2_f * D2_f)
        self.inv_a_final = self._s(1.0 / a_final)

        # --- 1-D k vectors (memoised); the 3-D k^2 grid is broadcast on
        # the fly
        key_device = device
        if device.type == "cuda" and device.index is None:
            key_device = torch.device("cuda", torch.cuda.current_device())
        (self._kf, self._kzf_h, self._kx_d, self._kz_d, self._m1,
         self._m1h) = _k_vectors(Nf, N, grid.Lx, dtype, key_device)
        timing.count("colaplan.hit" if _plan_misses() == misses
                     else "colaplan.miss")
        self.mean_per_cell = self._s(N**3 / Nf**3)

    # ------------------------------------------------------------------
    def _s(self, v) -> float:
        """A host scalar rounded to the engine's dtype."""
        return float(self.np_dtype(v))

    def pick_band(self, maxd: float):
        """The smallest ladder band b with maxd < b STRICTLY, or None for
        the exact scatter.  The strict bound is what makes the open band
        exact: with maxd < b, floor(d) lies in [-b, b-1], so the cloud
        never reaches offset b+1; a displacement exactly equal to b
        escalates to the next band."""
        if not np.isfinite(maxd):
            raise FloatingPointError(f"COLA displacement is {maxd}: the "
                                     "particle state is not finite")
        for b in self.bands:
            if maxd < b:
                return b
        return None

    def _band_index(self, b) -> int:
        return self.bands.index(b) if b is not None else len(self.bands)

    def _frac_out(self, d, bound):
        return sum((c.abs() > bound).to(self.dtype).mean() for c in d) / 3.0

    @staticmethod
    def _flat(u3):
        return tuple(u3[i].reshape(-1) for i in range(3))

    # ------------------------------------------------------------------
    def initial_conditions(self, white):
        """2LPT from complex white noise: (x, v, p1, p2), each (3, N, N, N).

        x = q + D1 psi1 + D2 psi2 at the initial scale factor, v = 0 (the
        residual momentum)."""
        delta_x0, delta_k0 = gaussian_field_from_whitenoise(
            white, self.grid, self.cosmology.pk_lin_z0)
        del delta_x0
        p1, p2 = lpt_displacements(delta_k0, self.grid)
        del delta_k0
        N = self.N
        q = torch.arange(N, dtype=self.dtype, device=self.device) \
            * self._s(self.cell)
        x = torch.empty_like(p1)
        for i, qi in enumerate((q[:, None, None], q[None, :, None],
                                q[None, None, :])):
            x[i] = (qi + self.d1_init * p1[i]) + self.d2_init * p2[i]
        return x, torch.zeros_like(x), p1, p2

    def _k2_inv(self):
        kx, kz = self._kf, self._kzf_h
        k2 = kx[:, None, None] ** 2 + kx[None, :, None] ** 2 \
            + kz[None, None, :] ** 2
        pos = k2 > 0.0
        return torch.where(pos, 1.0 / torch.where(pos, k2,
                                                  torch.ones_like(k2)),
                           torch.zeros_like(k2))

    def force(self, x, a: float, clock=timing.NULL_CLOCK):
        """PM acceleration at positions ``x`` (3, N, N, N) (Mpc) and scale
        factor ``a``: returns (F, diag) with F (3, N, N, N), and diag
        (maxd, frac_out, band index) when diagnostics are on, else None."""
        N, Nf, dt = self.N, self.Nf, self.np_dtype
        s = (Nf, Nf, Nf)
        u = x / self._s(self.cell_f)
        diag = None
        b = None
        if self.use_lattice:
            d = twin.wrapped_displacement_axes(u, N)
            maxd = _maxabs(d)
            b = self.pick_band(maxd)
            if self.diagnostics:
                diag = (maxd, self._frac_out(d, self._s(self.lattice_B)),
                        self._band_index(b))
        elif self.diagnostics:
            d_p = twin.wrapped_displacement_axes(x / self._s(self.cell), N)
            bref = self._s(self.lattice_B if self.lattice_B is not None
                           else 2)
            diag = (_maxabs(d_p), self._frac_out(d_p, bref), -1)
            del d_p
        clock.mark("prep")
        timing.count(f"cola.band{b}" if b is not None else "cola.exact")
        if b is not None:
            rho = self._paint(d, b, None, True)
            clock.mark("paint")
        else:
            timing.count("exact.paint")
            rho = cic_paint_particles(self._flat(u), Nf)
            clock.mark("paint_exact")

        dk = fft_safe.rfftn(rho / self.mean_per_cell - 1.0)
        del rho
        if self.force_factor > 1:
            # Keep only modes that exist on the particle grid: beyond the
            # particle Nyquist the painted density is lattice discreteness.
            m1, m1h = self._m1, self._m1h
            dk = dk * (m1[:, None, None] & m1[None, :, None]
                       & m1h[None, None, :])
        c = float(dt(self.fac_pm) / dt(a))
        # No window deconvolution in the force: W^-2 diverges at the mesh
        # corners and pumps aliasing noise into the particles.
        if self.gradient in ("fd4", "fd6"):
            # one inverse transform of the potential, then centred finite
            # differences (fd4: (8, -1)/12, fd6: (45, -9, 1)/60)
            phi = fft_safe.irfftn(c * dk * self._k2_inv(), s).contiguous()
            del dk
            coeffs, denom = (((8.0, -1.0), 12.0) if self.gradient == "fd4"
                             else ((45.0, -9.0, 1.0), 60.0))
            invh = self._s(1.0 / (denom * self.cell_f))

            def comp(ax):
                acc = None
                for j, cj in enumerate(coeffs, start=1):
                    t = self._s(cj) * (torch.roll(phi, -j, ax)
                                       - torch.roll(phi, j, ax))
                    acc = t if acc is None else acc + t
                return acc * invh
        else:
            base = (1j * c) * dk * self._k2_inv()
            del dk
            kvecs = (self._kx_d[:, None, None], self._kx_d[None, :, None],
                     self._kz_d[None, None, :])

            def comp(ax):
                return fft_safe.irfftn(base * kvecs[ax], s).contiguous()

        F = torch.empty((3, N, N, N), dtype=self.dtype, device=self.device)
        if b is None or b <= self.fuse_band:
            comps = tuple(comp(ax) for ax in range(3))
            clock.mark("solve")
            if b is None:
                # one exact gather of the three meshes into the force rows
                timing.count("exact.gather", 3)
                cic_gather3_particles(comps, self._flat(u), out=self._flat(F))
                clock.mark("gather_exact")
                return F, diag
            if self.lattice_impl == "cuda":
                # K11c gathers straight into the force rows
                self._gather3(comps, d, b, True, out=F.unbind(0))
            else:
                for i, g in enumerate(self._gather3(comps, d, b, True)):
                    F[i] = g
            clock.mark("gather")
            return F, diag
        # One force mesh at a time, each consumed by its own gather.
        for ax in range(3):
            mesh = comp(ax)
            clock.mark("solve")
            F[ax] = self._gather(mesh, d, b, True)
            clock.mark("gather")
        return F, diag

    def step(self, x, v, p1, p2, i: int, clock=timing.NULL_CLOCK):
        """Kick-drift step ``i``, updating ``x`` and ``v`` in place; returns
        the force evaluation's diag (None without diagnostics)."""
        dt = self.np_dtype
        K1, K2, Dr, D1, D2, dD1, dD2, a_f = (dt(r) for r in self.rows[i])
        F, diag = self.force(x, a_f, clock)
        # COLA compensation (the LPT acceleration subtracted), kick, drift
        kick.kick_drift(x, v, p1, p2, F, float(D1), float(D2 - D1 * D1),
                        float(dt(self.fac_pm) / a_f), float(K1 + K2),
                        float(Dr), float(dD1), float(dD2),
                        self._s(self.grid.Lx))
        del F
        clock.mark("update")
        return diag

    def finish(self, x, v, p1, p2):
        """Final CIC paint, window deconvolution and (optionally) the
        CIC-averaged velocities: (delta_x, vel or None, final_maxdisp or
        None)."""
        N = self.N
        u = x / self._s(self.cell)
        d_fin = b = final_maxdisp = None
        if self.use_lattice or self.diagnostics:
            d_fin = twin.wrapped_displacement_axes(u, N)
            final_maxdisp = _maxabs(d_fin)
            if self.use_lattice:
                b = self.pick_band(final_maxdisp)
        timing.count(f"cola.band{b}" if b is not None else "cola.exact")

        def paint(w):
            if b is not None:
                return self._paint(d_fin, b, w, True)
            return cic_paint_particles(self._flat(u), N, weights=None
                                       if w is None else w.reshape(-1))

        rho = paint(None)
        # Deconvolve the CIC assignment window, so the output spectrum is
        # unbiased up to the particle Nyquist scale.
        comp_k = compensation(self.grid, "cic", self.dtype, self.device,
                              half=True)
        delta_x = fft_safe.irfftn(fft_safe.rfftn(rho - 1.0) * comp_k,
                                  self.grid.shape).to(self.dtype)
        delta_x = delta_x.contiguous()
        del comp_k
        if not self.diagnostics:
            final_maxdisp = None
        if not self.keep_velocities:
            return delta_x, None, final_maxdisp
        # Total momentum = LPT part at a_final + residual; v_pec = p/a (km/s)
        p_tot = v + self.pfac1 * p1 + self.pfac2 * p2
        vel = torch.empty_like(p_tot)
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        for c in range(3):
            m = paint(p_tot[c])
            vel[c] = torch.where(rho > 0, m / torch.clamp(rho, min=1e-10),
                                 zero) * self.inv_a_final
        return delta_x, vel, final_maxdisp

    def run(self, white, clock=timing.NULL_CLOCK):
        """The whole evolution from complex white noise; returns what
        :func:`realise_density_cola` returns."""
        x, v, p1, p2 = self.initial_conditions(white)
        clock.mark("ic")
        diags = [self.step(x, v, p1, p2, i, clock)
                 for i in range(self.n_steps)]
        delta_x, vel, final_maxdisp = self.finish(x, v, p1, p2)
        clock.mark("finish")
        if not self.diagnostics:
            return delta_x, vel
        timing.count("sync.cola_diagnostics")
        return delta_x, vel, {
            "maxdisp": torch.tensor([g[0] for g in diags], dtype=self.dtype),
            "frac_out": torch.stack([g[1] for g in diags]).cpu(),
            "used_lattice": torch.tensor([g[2] for g in diags],
                                         dtype=torch.int32),
            "final_maxdisp": torch.tensor(final_maxdisp, dtype=self.dtype)}


def realise_density_cola(generator, grid: GridSpec, cosmology, redshift=None,
                         redshift_init: float = 15.0,
                         n_steps: int | None = None, dtype=torch.float32,
                         keep_velocities: bool = True, force_factor: int = 1,
                         lattice_B: int | None = 3, lattice_impl: str = "auto",
                         gradient: str = "spectral",
                         fuse_force_gather: bool | int = True,
                         diagnostics: bool = False, white=None, clock=None,
                         device=None):
    """Evolve a 2LPT+COLA realisation to the target redshift.

    Parameters mirror ``fastbox_tpu.fields.cola.realise_density_cola`` and
    the reference's (box.py:463-534).  ``generator`` draws the complex
    white noise: a key (an int seed or key words) draws fastbox_tpu's
    ``white_noise(key, grid, dtype)`` (fastbox_tpu/fields/cola.py:297) on
    ``device`` (None: the card), a ``torch.Generator`` torch's on its
    device; pass ``white`` (complex (N, N, N), its device is used) to
    supply it instead.
    ``redshift`` defaults to ``grid.redshift``; ``n_steps`` to
    ``int(1 + redshift_init)``, as pycola3 does.
    ``force_factor`` computes PM forces on a mesh of ``force_factor * N``
    cells per side, keeping only modes below the particle Nyquist.

    ``lattice_B`` (force_factor == 1 only) enables the lattice CIC paint
    and gather under an adaptive band ladder: each force evaluation takes
    the smallest band b <= lattice_B with max|d| < b, and the exact scatter
    beyond it; ``None`` disables.  ``lattice_impl``: ``"cuda"`` (the K11
    kernels; raises off a CUDA device), ``"plain"`` (the roll-form twins,
    any device) or ``"auto"`` (the kernels on a CUDA device, the twins on
    the CPU).  ``fuse_force_gather`` gathers the three force components in
    one call for bands <= it (True: every band, False: never); the exact
    tier always gathers them in one call.

    ``gradient``: ``"spectral"`` (default; three C2R transforms per step)
    or ``"fd4"``/``"fd6"`` (one C2R of the potential and 4th/6th-order
    centred differences, which under-pull the force near the mesh
    Nyquist).  ``clock`` (a ``timing.StageClock``) marks the stages white
    (the white-noise draw), schedule (the engine's set-up, its host step
    schedule), ic (2LPT), prep, paint, solve, gather, update and finish
    (on the exact tier paint_exact and gather_exact in place of paint and
    gather, one each a force evaluation); it counts each paint's band
    (``cola.band<b>``, or ``cola.exact`` for the exact scatter; one a
    force evaluation and one for the final paints), the exact tier's
    force paints (``exact.paint``, one a force evaluation) and gathers
    (``exact.gather``, one a force component), each exact paint or gather
    call's implementation (``exactcic.fused`` for K13, ``exactcic.plain``
    for the plain passes), each band pick's host sync
    (``sync.cola_band``), and the engine's host plan (``colaplan.hit``
    where the step schedule, the growth scalars and the k vectors all
    came from their memos, built by an earlier call of the configuration;
    else ``colaplan.miss``, and the k vectors' copies to a CUDA device,
    ``sync.h2d_cola_k``).

    With ``diagnostics=True`` a third return value holds ``maxdisp`` (max
    wrapped displacement in cells at each force evaluation), ``frac_out``
    (fraction of displacement components beyond ``lattice_B``),
    ``used_lattice`` (band index per step: 0.. for band 1..lattice_B,
    len(bands) for the exact scatter, -1 with the lattice off) and
    ``final_maxdisp``.

    Returns:
        (delta_x, vel[, diag]): the window-deconvolved CIC density contrast
        and, if ``keep_velocities``, the (3, N, N, N) CIC-averaged peculiar
        velocities in km/s (zero where empty), else None.
    """
    if white is None and generator is None:
        raise ValueError("pass a key, a generator or white noise")
    with timing.active(clock) as clock:
        if white is None:
            white = white_noise(generator, grid, dtype, device)
        if white.real.dtype != dtype:
            raise TypeError(f"white noise is {white.dtype}, the engine "
                            f"{dtype}")
        clock.mark("white")
        engine = ColaEngine(grid, cosmology, redshift=redshift,
                            redshift_init=redshift_init, n_steps=n_steps,
                            dtype=dtype, device=white.device,
                            keep_velocities=keep_velocities,
                            force_factor=force_factor, lattice_B=lattice_B,
                            lattice_impl=lattice_impl, gradient=gradient,
                            fuse_force_gather=fuse_force_gather,
                            diagnostics=diagnostics)
        clock.mark("schedule")
        return engine.run(white, clock)
