"""K11 (lattice CIC paint, gather, three-mesh gather): the plain twins and
the exact scatter of fastbox_tpu_torch against fastbox_tpu, in float64 on
the CPU at 16^3.

The twins are held to fastbox_tpu's roll form (fields/lattice_cic.py) for
B = 1, 2, 3, open and closed band, weighted and unweighted, and to the
Pallas kernels run in interpret mode (as tests/test_cola.py runs them) in
three of those cases.  Displacements are uniform inside the band; the
closed-band cases also put some exactly on +-B.  Tolerance: 1e-12 of the
largest value (f64 summation order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastbox_tpu.fields import cola as jcola
from fastbox_tpu.fields import lattice_cic as jlat
from fastbox_tpu.ops.pallas import lattice_cic as plc
from fastbox_tpu_torch.fields import cola, lattice_cic
from fastbox_tpu_torch.ops.cuda import lattice_cic as k11

N = 16
RTOL = 1e-12


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (chip_smoke.py runs the kernels there)")
    return torch.device("cuda")


def close(got, want, rtol=RTOL):
    got = np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def displacements(rng, B, openband, n=N):
    """(dx, dy, dz) numpy arrays inside the band: |d| < B for the open band,
    |d| <= B with some values exactly +-B for the closed one."""
    if openband:
        return tuple(rng.uniform(-B, B, (n, n, n)) * 0.999 for _ in range(3))
    d = [rng.uniform(-B, B, (n, n, n)) for _ in range(3)]
    for a in d:
        a.reshape(-1)[::97] = B
        a.reshape(-1)[5::97] = -B
    return tuple(d)


def clustered(rng, B, n):
    """Displacements uniform inside the open band, except that every site
    within B - 1/2 cells of three centres is pulled onto one point near
    the centre: up to ~(2B)^3 sources land in one cell, as in a collapsed
    halo.  Three centres, one near a corner, so clusters straddle the
    periodic edge."""
    d = [rng.uniform(-B, B, (n, n, n)) * 0.999 for _ in range(3)]
    site = np.meshgrid(*(np.arange(n),) * 3, indexing="ij")
    for cen in ((n // 2, n // 2, n // 2), (2, n - 3, 5), (n - 1, 0, n - 1)):
        # periodic offset of each site from the centre, in [-n/2, n/2)
        off = [(s - c + n // 2) % n - n // 2 for s, c in zip(site, cen)]
        near = sum(o ** 2 for o in off) <= (B - 0.5) ** 2
        for a, o in zip(d, off):
            a[near] = 0.3 - o[near]
    return tuple(d)


def tt(arrs):
    return tuple(torch.as_tensor(a) for a in arrs)


def jj(arrs):
    return tuple(jnp.asarray(a) for a in arrs)


CASES = [(B, ob) for B in (1, 2, 3) for ob in (True, False)]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("B, openband", CASES)
def test_paint_twin_matches_roll_form(rng, B, openband, weighted):
    d = displacements(rng, B, openband)
    w = rng.uniform(0.5, 1.5, (N, N, N)) if weighted else None
    want = jlat.cic_paint_lattice(jj(d), B=B,
                                  weights=None if w is None else jnp.asarray(w))
    got = lattice_cic.cic_paint_lattice(
        tt(d), B, None if w is None else torch.as_tensor(w), openband)
    close(got.numpy(), want)
    if not weighted:  # CIC conserves the particle count
        assert abs(got.sum().item() - N**3) < 1e-9


@pytest.mark.parametrize("B, openband", CASES)
def test_gather_twins_match_roll_form(rng, B, openband):
    d = displacements(rng, B, openband)
    meshes = [rng.standard_normal((N, N, N)) for _ in range(3)]
    want = [jlat.cic_gather_lattice(jnp.asarray(m), jj(d), B=B)
            for m in meshes]
    got1 = lattice_cic.cic_gather_lattice(torch.as_tensor(meshes[0]), tt(d),
                                          B, openband)
    close(got1.numpy(), want[0])
    got3 = lattice_cic.cic_gather3_lattice(tt(meshes), tt(d), B, openband)
    for g, w in zip(got3, want):
        close(g.numpy(), w)


@pytest.mark.parametrize("B, openband, weighted",
                         [(1, True, True), (3, True, True), (2, False, False)])
def test_twins_match_pallas_interpret(rng, B, openband, weighted):
    d = displacements(rng, B, openband)
    w = rng.uniform(0.5, 1.5, (N, N, N)) if weighted else None
    meshes = [rng.standard_normal((N, N, N)) for _ in range(3)]
    want_p = plc.cic_paint_lattice_pallas(
        jj(d), B=B, weights=None if w is None else jnp.asarray(w),
        interpret=True, openband=openband)
    want_g = plc.cic_gather_lattice_pallas(jnp.asarray(meshes[0]), jj(d), B=B,
                                           interpret=True, openband=openband)
    want_g3 = plc.cic_gather3_lattice_pallas(jj(meshes), jj(d), B=B,
                                             interpret=True, openband=openband)
    close(k11.cic_paint_lattice(
        tt(d), B, None if w is None else torch.as_tensor(w),
        openband).numpy(), want_p)
    close(k11.cic_gather_lattice(torch.as_tensor(meshes[0]), tt(d), B,
                                 openband).numpy(), want_g)
    for g, w3 in zip(k11.cic_gather3_lattice(tt(meshes), tt(d), B, openband),
                     want_g3):
        close(g.numpy(), w3)


def test_wrapped_displacements_match(rng):
    u = rng.uniform(-3.0, N + 3.0, (N, N, N, 3))
    close(lattice_cic.wrapped_displacement(torch.as_tensor(u), N).numpy(),
          jlat.wrapped_displacement(jnp.asarray(u), N))
    u3 = np.moveaxis(u, -1, 0).copy()
    got = lattice_cic.wrapped_displacement_axes(torch.as_tensor(u3), N)
    want = jlat.wrapped_displacement_axes(jnp.asarray(u3), N)
    for g, w in zip(got, want):
        assert g.is_contiguous()
        close(g.numpy(), w)
        assert g.min() >= -N / 2 and g.max() < N / 2


@pytest.mark.parametrize("layout", ["rows", "tuple"])
def test_exact_scatter_matches_fastbox_tpu(rng, layout):
    M = 3000
    u = rng.uniform(-2.0, N + 2.0, (M, 3))
    w = rng.uniform(0.5, 1.5, M)
    mesh = rng.standard_normal((N, N, N))
    ut = torch.as_tensor(u) if layout == "rows" else tuple(
        torch.as_tensor(u[:, i].copy()) for i in range(3))
    for weights in (None, w):
        close(cola.cic_paint_particles(
            ut, N, None if weights is None else torch.as_tensor(weights)
        ).numpy(), jcola.cic_paint_particles(
            jnp.asarray(u), N,
            weights=None if weights is None else jnp.asarray(weights)))
    close(cola.cic_gather(torch.as_tensor(mesh), ut).numpy(),
          jcola.cic_gather(jnp.asarray(mesh), jnp.asarray(u)))


@pytest.mark.parametrize("B", [1, 3])
def test_lattice_equals_exact_scatter_in_band(rng, B):
    """Under the strict bound the open-band twins are the CIC scatter and
    gather at the positions l + d."""
    d = displacements(rng, B, True)
    w = rng.uniform(0.5, 1.5, (N, N, N))
    mesh = rng.standard_normal((N, N, N))
    site = np.meshgrid(*(np.arange(N),) * 3, indexing="ij")
    u = tuple(torch.as_tensor((s + a).reshape(-1)) for s, a in zip(site, d))
    close(lattice_cic.cic_paint_lattice(tt(d), B, torch.as_tensor(w),
                                        True).numpy(),
          cola.cic_paint_particles(u, N, torch.as_tensor(w.reshape(-1))))
    close(lattice_cic.cic_gather_lattice(torch.as_tensor(mesh), tt(d), B,
                                         True).numpy().reshape(-1),
          cola.cic_gather(torch.as_tensor(mesh), u))


@pytest.mark.parametrize("B", [1, 2, 3])
def test_clustered_twin_equals_exact_scatter(rng, B):
    """Many sources in one cell: the open-band twin is still the exact CIC
    scatter at the positions l + d, weighted and not."""
    d = clustered(rng, B, N)
    assert max(np.abs(a).max() for a in d) < B
    site = np.meshgrid(*(np.arange(N),) * 3, indexing="ij")
    u = tuple(torch.as_tensor((s + a).reshape(-1)) for s, a in zip(site, d))
    # the clusters put more than 8 sources on one cell
    counts = np.bincount(np.ravel_multi_index(
        [np.floor(a.numpy()).astype(int) % N for a in u], (N,) * 3))
    assert counts.max() >= {1: 4, 2: 20, 3: 60}[B]
    w = rng.uniform(0.5, 1.5, (N, N, N))
    for weights in (None, w):
        close(lattice_cic.cic_paint_lattice(
            tt(d), B, None if weights is None else torch.as_tensor(weights),
            True).numpy(),
            cola.cic_paint_particles(
                u, N, None if weights is None
                else torch.as_tensor(weights.reshape(-1))))


def test_band_edge_and_beyond(rng):
    """d == B exactly still paints exactly in the open band (its far cell
    has weight 0); d beyond B loses mass there and needs band B+1, the step
    the COLA ladder takes once max|d| >= B."""
    site = np.meshgrid(*(np.arange(N),) * 3, indexing="ij")

    def exact(d):
        u = tuple(torch.as_tensor((s + a).reshape(-1))
                  for s, a in zip(site, d))
        return cola.cic_paint_particles(u, N).numpy()

    d = list(displacements(rng, 1, True))
    d[0][3, 4, 5] = 1.0
    close(lattice_cic.cic_paint_lattice(tt(d), 1, None, True).numpy(),
          exact(d))
    d[1][6, 7, 8] = 1.25
    lost = lattice_cic.cic_paint_lattice(tt(d), 1, None, True)
    assert abs(lost.sum().item() - (N**3 - 0.25)) < 1e-9
    close(lattice_cic.cic_paint_lattice(tt(d), 2, None, True).numpy(),
          exact(d))


def test_dispatch_takes_the_twin_on_the_cpu_and_the_kernel_raises(rng):
    d = tt(displacements(rng, 2, True))
    mesh = torch.as_tensor(rng.standard_normal((N, N, N)))
    torch.testing.assert_close(k11.cic_paint_lattice(d, 2),
                               lattice_cic.cic_paint_lattice(d, 2, None, True),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        k11.cic_paint_lattice_cuda(d, 2)
    with pytest.raises(ValueError, match="CUDA"):
        k11.cic_gather_lattice_cuda(mesh, d, 2)
    with pytest.raises(ValueError, match="CUDA"):
        k11.cic_gather3_lattice_cuda((mesh, mesh, mesh), d, 2)
    with pytest.raises(ValueError, match="B must be"):
        k11.cic_gather_lattice_cuda(mesh, d, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_equal_twins(cuda, rng, B, dtype):
    """The kernels sum in the twins' order with explicit rounding: equal."""
    n = 64
    d = tuple(torch.as_tensor(rng.uniform(-B, B, (n, n, n)) * 0.999,
                              dtype=dtype, device=cuda) for _ in range(3))
    w = torch.as_tensor(rng.uniform(-1.0, 1.0, (n, n, n)), dtype=dtype,
                        device=cuda)
    meshes = tuple(torch.randn((n, n, n), dtype=dtype, device=cuda)
                   for _ in range(3))
    for weights in (None, w):
        assert torch.equal(k11.cic_paint_lattice_cuda(d, B, weights),
                           k11.cic_paint_lattice_plain(d, B, weights))
    assert torch.equal(k11.cic_gather_lattice_cuda(meshes[0], d, B),
                       k11.cic_gather_lattice_plain(meshes[0], d, B))
    for a, b in zip(k11.cic_gather3_lattice_cuda(meshes, d, B),
                    k11.cic_gather3_lattice_plain(meshes, d, B)):
        assert torch.equal(a, b)
    # closed band, displacements up to +-B inclusive
    dc = tuple(torch.clamp(a / 0.999, -B, B) for a in d)
    assert torch.equal(k11.cic_paint_lattice_cuda(dc, B, w, openband=False),
                       k11.cic_paint_lattice_plain(dc, B, w, openband=False))
    # clustered sources, many in one cell; and |d| just under B on ~30%
    dcl = tuple(torch.as_tensor(a, dtype=dtype, device=cuda)
                for a in clustered(rng, B, n))
    under = torch.nextafter(torch.tensor(float(B), dtype=dtype),
                            torch.tensor(0.0, dtype=dtype)).to(cuda)
    du = tuple(torch.where(torch.rand_like(a) < 0.3,
                           torch.where(a > 0, under, -under), a).contiguous()
               for a in d)
    for disp in (dcl, du):
        for weights in (None, w):
            got = k11.cic_paint_lattice_cuda(disp, B, weights)
            assert torch.equal(got, k11.cic_paint_lattice_plain(disp, B,
                                                                weights))
            assert torch.equal(got, k11.cic_paint_lattice_cuda(disp, B,
                                                               weights))


@pytest.mark.parametrize("nmesh", [1, 3])
def test_grid_sample_yardstick_is_the_gather(rng, nmesh):
    """chip_smoke.py times the gathers beside one grid_sample call on the
    meshes padded circularly by one cell (its library yardstick).  In f64
    that call is the twin gather, channel by channel, to rounding."""
    import chip_smoke

    B = 3
    d = tt(displacements(rng, B, True))
    meshes = tt([rng.standard_normal((N, N, N)) for _ in range(nmesh)])
    inp, grid = chip_smoke.grid_sample_operands(meshes, d)
    assert inp.shape == (1, nmesh, N + 1, N + 1, N + 1)
    got = chip_smoke.grid_sample_gather(inp, grid)
    assert got.shape == (nmesh, N, N, N)
    for g, m in zip(got, meshes):
        close(g.numpy(), lattice_cic.cic_gather_lattice(m, d, B,
                                                        True).numpy())


def test_gather3_out_is_checked(rng):
    """K11c's optional outputs (the COLA force rows) are checked before
    anything launches."""
    d = tt(displacements(rng, 2, True))
    meshes = tt([rng.standard_normal((N, N, N)) for _ in range(3)])
    with pytest.raises(ValueError, match="three tensors"):
        k11.cic_gather3_lattice_cuda(meshes, d, 2, out=meshes[:2])
    with pytest.raises(ValueError, match="CUDA"):
        k11.cic_gather3_lattice_cuda(meshes, d, 2,
                                     out=torch.empty((3, N, N, N)).unbind(0))


def smooth(rng, B, n):
    """Displacements like COLA's: smooth fields (a few long waves) with
    max|d| just under B."""
    site = np.meshgrid(*(np.arange(n),) * 3, indexing="ij")
    out = []
    for _ in range(3):
        f = sum(np.sin(2 * np.pi * sum(k * s for k, s in
                                       zip(rng.integers(-2, 3, 3), site)) / n
                       + rng.uniform(0, 2 * np.pi)) for _ in range(4))
        out.append(f * (0.99 * B / np.abs(f).max()))
    return tuple(out)


@pytest.mark.cuda
@pytest.mark.parametrize("B, openband, n", [(1, True, 64), (2, True, 64),
                                            (3, True, 64), (2, False, 64),
                                            (3, True, 60), (3, True, 30),
                                            (8, True, 32), (16, True, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gathers_equal_twins_bitwise(cuda, rng, B, openband, n, dtype):
    """K11b and K11c stream mesh planes through shared memory, or read
    their corners from global memory where the rings do not fit (K11c at
    B = 8 in f32, both at B = 8 in f64 and at B = 16) or N is not a
    multiple of a 16-byte chunk (n = 30 in f32); ragged faces at n = 60; either
    way they sum in the twins' order:
    bitwise equal to the twins and repeatable on uniform, clustered and
    smooth (COLA-like) displacements, into new tensors or given ones."""
    def on(arrs):
        return tuple(torch.as_tensor(a, dtype=dtype, device=cuda)
                     for a in arrs)

    meshes = on([rng.standard_normal((n, n, n)) for _ in range(3)])
    cases = [displacements(rng, B, openband, n)]
    if openband:
        cases += [clustered(rng, B, n), smooth(rng, B, n)]
    for d in map(on, cases):
        g1 = k11.cic_gather_lattice_cuda(meshes[0], d, B, openband)
        assert torch.equal(g1, k11.cic_gather_lattice_plain(meshes[0], d, B,
                                                            openband))
        assert torch.equal(g1, k11.cic_gather_lattice_cuda(meshes[0], d, B,
                                                           openband))
        g3 = k11.cic_gather3_lattice_cuda(meshes, d, B, openband)
        out = torch.empty((3, n, n, n), dtype=dtype, device=cuda)
        k11.cic_gather3_lattice_cuda(meshes, d, B, openband,
                                     out=out.unbind(0))
        for a, b, c in zip(g3, k11.cic_gather3_lattice_plain(meshes, d, B,
                                                             openband), out):
            assert torch.equal(a, b)
            assert torch.equal(a, c)
