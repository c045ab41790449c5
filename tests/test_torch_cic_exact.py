"""K13, COLA's exact CIC tier in one pass (ops/cuda/cic_exact.py).

On the CPU at 16^3 with one intra-op thread: the plain passes against the
tier as ``fields/cola.py`` wrote it before K13 (copied below), bit for
bit in f32 and f64, on positions that are random, negative, beyond the
mesh, on integers and just under its side, on meshes of N and 2N cells a
side; ``ColaEngine.force``'s exact branch (one three-mesh gather) against
the per-axis loop it replaced, with ``lattice_B`` 1 and None and
``force_factor`` 1 and 2; the ``exactcic.*`` counters, one an exact call,
leaving ``exact.*``, ``cola.*`` and ``sync.*`` and the outputs unmoved;
the wrappers' refusals.  On the card (skipped without one): K13b bitwise
equal to the plain gather (f32/f64, one and three meshes, 63^3 and 126^3
meshes, an input off a 16-byte boundary), K13a against the plain paint,
weighted and not.
"""
import numpy as np
import pytest
import torch

from fastbox_tpu_torch import timing
from fastbox_tpu_torch.cosmology import build_cosmology
from fastbox_tpu_torch.fields import lattice_cic as twin
from fastbox_tpu_torch.fields.cola import (ColaEngine, cic_gather,
                                           cic_gather3_particles,
                                           cic_paint_particles,
                                           realise_density_cola)
from fastbox_tpu_torch.fields.gaussian import white_noise
from fastbox_tpu_torch.grid import GridSpec
from fastbox_tpu_torch.ops import fft_safe
from fastbox_tpu_torch.ops.cuda import _build
from fastbox_tpu_torch.ops.cuda import cic_exact as k13

COSMO = dict(Omega_c=0.25, Omega_b=0.05, h=0.7, n_s=0.95, sigma8=0.8)
DTYPES = [torch.float32, torch.float64]
N = 16
L = 4000.0 * N / 512          # the 512^3 cell's 7.8 Mpc cells
SEED = 2 ** 31 + 2626
# (lattice_B, force_factor): the exact tier past band 1, the lattice off,
# and a force mesh twice as fine (always exact)
FORCE_CASES = [(1, 1), (None, 1), (1, 2), (None, 2)]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (chip_smoke.py runs the kernels there)")
    return torch.device("cuda")


# ----------------------------------------------------------------------
# The tier before K13, verbatim (fields/cola.py)
# ----------------------------------------------------------------------
def _u_axes(u):
    if isinstance(u, (tuple, list)):
        return tuple(u)
    return u[:, 0], u[:, 1], u[:, 2]


def _corners(u, N: int):
    out = []
    for a in u:
        fl = torch.floor(a)
        fr = a - fl
        i0 = fl.long()
        out.append(((torch.remainder(i0, N), 1.0 - fr),
                    (torch.remainder(i0 + 1, N), fr)))
    return out


def paint_before_k13(u, N: int, weights=None):
    cx, cy, cz = _corners(_u_axes(u), N)
    ref = cx[0][1]
    mesh = torch.zeros(N**3, dtype=ref.dtype, device=ref.device)
    for ix, wx in cx:
        px = wx if weights is None else weights * wx
        for iy, wy in cy:
            pxy = px * wy
            row = ix * N + iy
            for iz, wz in cz:
                mesh.index_add_(0, row * N + iz, pxy * wz)
    return mesh.reshape(N, N, N)


def gather_before_k13(mesh, u):
    N = mesh.shape[0]
    flat = mesh.reshape(-1)
    cx, cy, cz = _corners(_u_axes(u), N)
    out = torch.zeros_like(cx[0][1])
    for ix, wx in cx:
        for iy, wy in cy:
            row = ix * N + iy
            for iz, wz in cz:
                out = out + flat[row * N + iz] * wx * wy * wz
    return out


def force_before_k13(eng, x, a):
    """``ColaEngine.force`` before K13 (spectral gradient), verbatim but
    for the clock and the diagnostics: its exact tier painted with
    ``paint_before_k13`` and gathered one component at a time."""
    N, Nf, dt = eng.N, eng.Nf, eng.np_dtype
    s = (Nf, Nf, Nf)
    u = x / eng._s(eng.cell_f)
    b = None
    if eng.use_lattice:
        d = twin.wrapped_displacement_axes(u, N)
        maxd = torch.stack([c.abs().max() for c in d]).max().item()
        b = eng.pick_band(maxd)
    assert b is None, "the case must take the exact tier"
    rho = paint_before_k13(eng._flat(u), Nf)
    dk = fft_safe.rfftn(rho / eng.mean_per_cell - 1.0)
    del rho
    if eng.force_factor > 1:
        m1, m1h = eng._m1, eng._m1h
        dk = dk * (m1[:, None, None] & m1[None, :, None]
                   & m1h[None, None, :])
    c = float(dt(eng.fac_pm) / dt(a))
    base = (1j * c) * dk * eng._k2_inv()
    del dk
    kvecs = (eng._kx_d[:, None, None], eng._kx_d[None, :, None],
             eng._kz_d[None, None, :])

    def comp(ax):
        return fft_safe.irfftn(base * kvecs[ax], s).contiguous()

    F = torch.empty((3, N, N, N), dtype=eng.dtype, device=eng.device)
    for ax in range(3):
        mesh = comp(ax)
        F[ax] = gather_before_k13(mesh, eng._flat(u)).reshape(N, N, N)
    return F


# ----------------------------------------------------------------------
# Positions shared with chip_smoke.py
# ----------------------------------------------------------------------
def positions(M: int, Nm: int, dtype, device, seed: int, offset: int = 0):
    """(ux, uy, uz), each (M,), in cell units of an Nm-cell mesh: uniform
    in [-Nm, 2 Nm) (negative and beyond the mesh), with runs on integers,
    just under Nm, at 0 and -0.5, and on the mesh's first and last cells.
    ``offset`` elements into a larger buffer puts them off a 16-byte
    boundary."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    out = []
    for axis in range(3):
        a = torch.rand(M, generator=g, dtype=torch.float64) * (3 * Nm) - Nm
        k = max(M // 16, 17)        # M >= 51
        a[:k] = torch.randint(-2 * Nm, 3 * Nm, (k,), generator=g)
        a[k:2 * k] = float(np.nextafter(np.float32(Nm), np.float32(0))) \
            if dtype == torch.float32 else np.nextafter(float(Nm), 0.0)
        a[2 * k:2 * k + 8] = 0.0
        a[2 * k + 8:2 * k + 16] = -0.5
        a[2 * k + 16:3 * k] = torch.rand(k - 16, generator=g,
                                         dtype=torch.float64) * 2 - 1 + (
            Nm - 1 if axis % 2 else 0)
        buf = torch.empty(M + offset, dtype=dtype, device=device)
        out.append(buf[offset:].copy_(a.to(dtype)))
    return tuple(out)


def meshes_of(Nm: int, C: int, dtype, device, seed: int, offset: int = 0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    out = []
    for _ in range(C):
        buf = torch.empty(Nm ** 3 + offset, dtype=dtype, device=device)
        m = buf[offset:].view(Nm, Nm, Nm)
        m.copy_(torch.randn((Nm, Nm, Nm), generator=g, dtype=torch.float64))
        out.append(m)
    return tuple(out)


# ----------------------------------------------------------------------
# CPU: the plain passes against the tier before K13
# ----------------------------------------------------------------------
@pytest.mark.parametrize("Nm", [N, 2 * N], ids=["Nm=N", "Nm=2N"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_gather3_equals_three_gathers_before_k13(dtype, Nm):
    u = positions(N ** 3, Nm, dtype, "cpu", 1)
    meshes = meshes_of(Nm, 3, dtype, "cpu", 2)
    want = [gather_before_k13(m, u) for m in meshes]
    got = cic_gather3_particles(meshes, u)
    assert len(got) == 3
    for g, w, m in zip(got, want, meshes):
        assert torch.equal(g, w)
        assert torch.equal(cic_gather(m, u), w)
    out = tuple(torch.full_like(u[0], np.nan) for _ in meshes)
    back = cic_gather3_particles(meshes, u, out=out)
    assert all(a is b for a, b in zip(back, out))
    assert all(torch.equal(o, w) for o, w in zip(out, want))
    # an (M, 3) tensor of positions gives the same bits
    um = torch.stack(u, dim=1)
    assert torch.equal(cic_gather(meshes[0], um), want[0])


@pytest.mark.parametrize("Nm", [N, 2 * N], ids=["Nm=N", "Nm=2N"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_paint_equals_the_paint_before_k13(dtype, Nm):
    u = positions(N ** 3, Nm, dtype, "cpu", 3)
    w = torch.rand(N ** 3, dtype=dtype, generator=torch.Generator()
                   .manual_seed(4)) * 2 - 1
    for wt in (None, w):
        want = paint_before_k13(u, Nm, wt)
        assert torch.equal(cic_paint_particles(u, Nm, wt), want)
        assert torch.equal(cic_paint_particles(torch.stack(u, dim=1), Nm,
                                               wt), want)
    # every particle's unit mass lands on the mesh
    total = paint_before_k13(u, Nm).double().sum().item()
    assert total == pytest.approx(N ** 3, rel=1e-6)


@pytest.fixture(scope="module")
def cosmo():
    return build_cosmology(COSMO, redshift=0.0, device="cpu")


def _moved_state(eng, cosmo, dtype, seed):
    """2LPT initial positions at 16^3, shifted by up to 2.5 cells a
    component (wrapped into the box): past band 1, so the exact tier."""
    grid = eng.grid
    white = white_noise(torch.Generator().manual_seed(seed), grid, dtype,
                        "cpu")
    x, _, _, _ = eng.initial_conditions(white)
    g = torch.Generator().manual_seed(seed + 1)
    shift = (torch.rand(x.shape, generator=g, dtype=dtype) * 5 - 2.5) \
        * eng._s(eng.cell)
    return torch.remainder(x + shift, eng._s(grid.Lx))


@pytest.mark.parametrize("lattice_B, ff", FORCE_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_force_exact_branch_equals_the_per_axis_loop(cosmo, dtype,
                                                     lattice_B, ff):
    grid = GridSpec.create(box_scale=L, nsamp=N, redshift=0.0)
    eng = ColaEngine(grid, cosmo, redshift_init=15.0, n_steps=4,
                     dtype=dtype, device="cpu", lattice_B=lattice_B,
                     force_factor=ff)
    x = _moved_state(eng, cosmo, dtype, 5 + ff)
    a = eng.rows[2][7]
    clock = timing.StageClock("cpu")
    with timing.active(clock):
        F, _ = eng.force(x, a, clock)
    want = force_before_k13(eng, x, a)
    assert torch.equal(F, want)
    counts = clock.counts()
    assert counts["exact.paint"] == 1 and counts["exact.gather"] == 3
    assert counts["exactcic.plain"] == 2 and "exactcic.fused" not in counts
    assert list(clock.host_ms()) == ["prep", "paint_exact", "solve",
                                     "gather_exact"]


def _run(grid, cosmo, lattice_B, clock, keep_velocities=True):
    white = white_noise(SEED, grid, torch.float32, "cpu")
    return realise_density_cola(
        None, grid, cosmo, redshift=0.0, redshift_init=15.0, n_steps=8,
        lattice_B=lattice_B, lattice_impl="plain", white=white, clock=clock,
        keep_velocities=keep_velocities, diagnostics=True, device="cpu")


@pytest.mark.parametrize("keep_velocities", [True, False])
@pytest.mark.parametrize("lattice_B", [1, None])
def test_exactcic_counts_one_an_exact_call(cosmo, lattice_B,
                                           keep_velocities):
    grid = GridSpec.create(box_scale=L, nsamp=N, redshift=0.0)
    clock = timing.StageClock("cpu")
    _build.reset_launch_counts()
    _, _, diag = _run(grid, cosmo, lattice_B, clock, keep_velocities)
    counts = clock.counts()
    n_exact = counts["exact.paint"]
    assert n_exact > 0 and counts["exact.gather"] == 3 * n_exact
    # the finish's exact paints: the density, and the three momenta
    final_exact = counts["cola.exact"] - n_exact
    assert final_exact in (0, 1)
    fin = final_exact * (4 if keep_velocities else 1)
    assert counts["exactcic.plain"] == 2 * n_exact + fin
    assert "exactcic.fused" not in counts
    assert _build.launch_counts() == {}


@pytest.mark.parametrize("lattice_B", [1, None])
def test_exactcic_leaves_the_other_families_unmoved(cosmo, monkeypatch,
                                                    lattice_B):
    grid = GridSpec.create(box_scale=L, nsamp=N, redshift=0.0)
    with_cic = timing.StageClock("cpu")
    d1, v1, _ = _run(grid, cosmo, lattice_B, with_cic)
    count = timing.count
    monkeypatch.setattr(timing, "count", lambda name, n=1: None
                        if name.startswith("exactcic.") else count(name, n))
    without = timing.StageClock("cpu")
    d2, v2, _ = _run(grid, cosmo, lattice_B, without)

    def family(clock, prefix):
        return {k: v for k, v in clock.counts().items()
                if k.startswith(prefix)}

    assert family(with_cic, "exactcic.") and not family(without, "exactcic.")
    for prefix in ("exact.", "cola.", "sync."):
        assert family(with_cic, prefix) == family(without, prefix), prefix
    assert torch.equal(d1, d2) and torch.equal(v1, v2)


def test_plain_passes_count_only_under_a_clock():
    u = positions(64, 4, torch.float64, "cpu", 6)
    m = meshes_of(4, 1, torch.float64, "cpu", 7)
    cic_paint_particles(u, 4)
    cic_gather(m[0], u)
    clock = timing.StageClock("cpu")
    with timing.active(clock):
        cic_paint_particles(u, 4)
        cic_gather3_particles(m * 3, u)
    assert clock.counts() == {"exactcic.plain": 2}


# ----------------------------------------------------------------------
# The wrappers' refusals
# ----------------------------------------------------------------------
def test_kernels_refuse_cpu_tensors():
    u = positions(64, 4, torch.float32, "cpu", 8)
    m = meshes_of(4, 3, torch.float32, "cpu", 9)
    with pytest.raises(ValueError, match="CUDA"):
        k13.cic_paint_exact_cuda(u, 4)
    with pytest.raises(ValueError, match="CUDA"):
        k13.cic_gather_exact_cuda(m, u)
    counts = _build.launch_counts()
    assert counts.get(k13.PAINT, 0) == 0 and counts.get(k13.GATHER, 0) == 0


def test_kernels_refuse_mixed_dtypes_and_other_types():
    u = positions(64, 4, torch.float32, "cpu", 10)
    m = meshes_of(4, 3, torch.float32, "cpu", 11)
    mixed = (u[0], u[1].double(), u[2])
    with pytest.raises(TypeError, match="dtype|float"):
        k13.cic_paint_exact_cuda(mixed, 4)
    with pytest.raises(TypeError, match="dtype|float"):
        k13.cic_paint_exact_cuda(u, 4, weights=torch.ones(64,
                                                          dtype=torch.float64))
    with pytest.raises(TypeError, match="dtype|float"):
        k13.cic_gather_exact_cuda((m[0].double(),), u)
    with pytest.raises(TypeError, match="dtype|float"):
        k13.cic_gather_exact_cuda(m, tuple(a.half() for a in u))


def test_kernels_refuse_non_contiguous_inputs():
    u = positions(64, 4, torch.float32, "cpu", 12)
    m = meshes_of(4, 3, torch.float32, "cpu", 13)
    cols = torch.stack(u, dim=1)
    strided = (cols[:, 0], cols[:, 1], cols[:, 2])
    with pytest.raises(ValueError, match="contiguous"):
        k13.cic_paint_exact_cuda(strided, 4)
    with pytest.raises(ValueError, match="contiguous"):
        k13.cic_gather_exact_cuda((m[0].transpose(0, 2),), u)
    with pytest.raises(ValueError, match="contiguous"):
        k13.cic_gather_exact_cuda(m, strided)


def test_kernels_refuse_wrong_shapes():
    u = positions(64, 4, torch.float32, "cpu", 14)
    m = meshes_of(4, 3, torch.float32, "cpu", 15)
    with pytest.raises(ValueError, match="one or three"):
        k13.cic_gather_exact_cuda(m[:2], u)
    with pytest.raises(ValueError, match=r"\(M,\)"):
        k13.cic_paint_exact_cuda((u[0], u[1], u[2][:10]), 4)
    with pytest.raises(ValueError, match="weights"):
        k13.cic_paint_exact_cuda(u, 4, weights=torch.ones(10))
    with pytest.raises(ValueError, match="Nm"):
        k13.cic_gather_exact_cuda((m[0], m[1], m[2][:, :2]), u)
    with pytest.raises(ValueError, match="out"):
        k13.cic_gather_exact_cuda(m, u, out=(torch.empty(64),) * 2)
    with pytest.raises(ValueError, match="unsupported device"):
        cic_paint_particles(tuple(a.to("meta") for a in u), 4)


# ----------------------------------------------------------------------
# On the card
# ----------------------------------------------------------------------
CARD_N = 63


def paint_tolerance(u, Nm: int, weights=None):
    """Per cell, the largest gap between two f32 sums of the same
    contributions in two orders, against their exact sum: each sum is
    within (n - 1) u sum|t| of it (n terms, u = 2^-24, first order), and
    each contribution ((w wx) wy) wz, the weights 1 - fr and fr included,
    within 4 u |t| of its exact value: 2 (n + 3) u sum|t| apart."""
    u64 = tuple(a.double() for a in u)
    w = torch.ones_like(u64[0]) if weights is None else weights.double()
    cx, cy, cz = k13._corners(u64, Nm)
    count = torch.zeros(Nm ** 3, dtype=torch.float64, device=u64[0].device)
    for ix, _ in cx:
        for iy, _ in cy:
            for iz, _ in cz:
                count.index_add_(0, (ix * Nm + iy) * Nm + iz,
                                 torch.ones_like(w))
    abs_sum = k13.cic_paint_exact_plain(u64, Nm, w.abs()).reshape(-1)
    return (2 * (count + 3) * 2.0 ** -24 * abs_sum).reshape(Nm, Nm, Nm)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "off16"])
@pytest.mark.parametrize("Nm", [CARD_N, 2 * CARD_N])
@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("dtype", DTYPES)
def test_k13b_equals_the_plain_gather(cuda, dtype, C, Nm, offset):
    u = positions(CARD_N ** 3, Nm, dtype, cuda, 20 + Nm, offset)
    meshes = meshes_of(Nm, C, dtype, cuda, 21 + Nm, offset)
    before = _build.launch_counts().get(k13.GATHER, 0)
    got = k13.cic_gather_exact_cuda(meshes, u)
    want = k13.cic_gather_exact_plain(meshes, u)
    torch.cuda.synchronize()
    assert _build.launch_counts()[k13.GATHER] == before + 1
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("Nm", [CARD_N, 2 * CARD_N])
@pytest.mark.parametrize("dtype", DTYPES)
def test_k13a_matches_the_plain_paint(cuda, dtype, Nm, weighted):
    u = positions(CARD_N ** 3, Nm, dtype, cuda, 30 + Nm)
    w = None
    if weighted:
        g = torch.Generator(device=cuda).manual_seed(31)
        w = torch.rand(CARD_N ** 3, generator=g, device=cuda,
                       dtype=dtype) * 2 - 1
    before = _build.launch_counts().get(k13.PAINT, 0)
    got = k13.cic_paint_exact_cuda(u, Nm, w)
    want = k13.cic_paint_exact_plain(u, Nm, w)
    torch.cuda.synchronize()
    assert _build.launch_counts()[k13.PAINT] == before + 1
    if dtype == torch.float64:
        err = ((got - want).abs().max() / want.abs().max()).item()
        assert err <= 1e-14, err
    else:
        # atomics and index_add_ add the same contributions in two orders
        tol = paint_tolerance(u, Nm, w)
        assert bool(((got.double() - want.double()).abs() <= tol).all())
