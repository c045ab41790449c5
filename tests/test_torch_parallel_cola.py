"""The port's slab-sharded COLA engine and its halo-exchange lattice paint
and gather (``parallel/{lattice,cola}.py``) on gloo ranks, against
fastbox_tpu.

As tests/test_parallel_cola.py does for fastbox_tpu: the halo primitives on
1, 2 and 4 ranks ('space' = the world, ``parallel.local``) at N = 16 and
B = 1, 2 equal fastbox_tpu's ``halo_paint``/``halo_gather`` under
``shard_map`` on 4 virtual devices (rtol 1e-12) and conserve mass; the
``*_many`` forms equal their per-channel calls bit for bit; the slab twins
equal the periodic twins.  ``make_sharded_cola`` in float64 at 16^3 (B = 2,
z 9 -> 0 in 3 steps, velocities, ``pk_nbins=8``), fed fastbox_tpu's
row-keyed white field or drawing it from the seed itself
(``parallel.rng``: jax's stream for ``PRNGKey(seed)``), equals
fastbox_tpu's engine on the same key at
tests/test_parallel_cola.py's tolerances (delta_x 1e-8, vel 1e-7 / 1e-6,
max_disp 1e-8, pk 1e-8) on 1, 2 and 4 ranks, and the rank counts agree;
the ensemble mode on a (2, 2) mesh equals per-seed calls bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from fastbox_tpu.cosmology import build_cosmology as jax_cosmology
from fastbox_tpu.grid import GridSpec as JaxGrid
from fastbox_tpu.parallel import (halo_gather as j_gather,
                                  halo_gather_many as j_gather_many,
                                  halo_paint as j_paint,
                                  halo_paint_many as j_paint_many)
from fastbox_tpu.parallel import make_sharded_cola as j_sharded_cola
from fastbox_tpu.parallel.rng import TAGS, default_row_method
from fastbox_tpu.parallel.rng import row_normal as j_row_normal
from fastbox_tpu_torch.cosmology import build_cosmology
from fastbox_tpu_torch.fields import lattice_cic as twin
from fastbox_tpu_torch.grid import GridSpec
from fastbox_tpu_torch.ops.cuda import lattice_cic as k11
from fastbox_tpu_torch.parallel import (halo_gather, halo_gather_many,
                                        halo_paint, halo_paint_many, local,
                                        make_mesh, make_sharded_cola)
from test_torch_slab_paint_order import KINDS, slab_disp

COSMO = dict(Omega_c=0.25, Omega_b=0.05, h=0.7, n_s=0.95, sigma8=0.8)
N = 16
BANDS = (1, 2)
WORLDS = (1, 2, 4)
RTOL = 1e-12
# the engine's configuration (tests/test_parallel_cola.py's ensemble case)
BOX = 250.0
COLA_KW = dict(redshift_init=9.0, n_steps=3, lattice_B=2, pk_nbins=8)
SEED = 42
ENS_SEEDS = [3, 4, 5, 6]


def bounded_disp(rng, n, B):
    """Displacements strictly inside the band (tests/test_parallel_cola.py)."""
    return rng.uniform(-1.0, 1.0, (n, n, n, 3)) * (B - 0.01)


def lattice_inputs():
    rng = np.random.default_rng(5)
    disp = {B: bounded_disp(rng, N, B) for B in BANDS}
    return disp, rng.standard_normal((N, N, N)), \
        rng.standard_normal((3, N, N, N))


def jax_white():
    """fastbox_tpu's row-keyed density white field of key SEED (full cube)."""
    return np.asarray(j_row_normal(jax.random.PRNGKey(SEED), TAGS["density"],
                                   0, N, (N, N), jnp.float64,
                                   method=default_row_method(N)))


@pytest.fixture(scope="module")
def ranks():
    """Each world's ranks' results: the lattice task, and the engine on
    fastbox_tpu's white field (plus, on 4 ranks, the ensemble mode on a
    (2, 2) mesh beside per-seed calls)."""
    disp, w, m = lattice_inputs()
    lat = dict(disp={B: torch.as_tensor(d) for B, d in disp.items()},
               weights=torch.as_tensor(w), meshes=torch.as_tensor(m))
    base = dict(grid=(BOX, N, 0.0), cosmo=COSMO,
                kw=dict(COLA_KW, dtype=torch.float64))
    out = {}
    for world in WORLDS:
        specs = [dict(base, space=world, white=jax_white())]
        if world == 4:
            specs.append(dict(base, space=2, seeds=ENS_SEEDS,
                              kw=dict(COLA_KW, dtype=torch.float64,
                                      keep_velocities=False)))
        specs.append(dict(base, space=world, seed=SEED))
        out[world] = local.launch("fastbox_tpu_torch.parallel.local:tasks",
                                  world, dict(tasks=["lattice", "cola"],
                                              lattice=lat, cola=specs))
    return out


@pytest.fixture(scope="module")
def jax_lattice():
    """fastbox_tpu's halo primitives under shard_map on 4 virtual devices."""
    disp, w, m = lattice_inputs()
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("space",))

    def smap(fn, in_specs, out_specs):
        return jax.jit(shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))

    out = {}
    for B in BANDS:
        d = jnp.asarray(disp[B])
        out[B] = {
            "paint": smap(lambda d: j_paint(d, B, "space", 4), P("space"),
                          P("space"))(d),
            "paint_w": smap(lambda d, w: j_paint(d, B, "space", 4, weights=w),
                            (P("space"), P("space")), P("space"))(
                                d, jnp.asarray(w)),
            "paint_many": smap(
                lambda d, w: j_paint_many(d, B, "space", 4, weights=w),
                (P("space"), P(None, "space")), P(None, "space"))(
                    d, jnp.asarray(m)),
            "gather": smap(lambda m, d: j_gather(m, d, B, "space", 4),
                           (P("space"), P("space")), P("space"))(
                               jnp.asarray(m[0]), d),
            "gather_many": smap(
                lambda m, d: j_gather_many(m, d, B, "space", 4),
                (P(None, "space"), P("space")), P(None, "space"))(
                    jnp.asarray(m), d),
        }
    return {B: {k: np.asarray(v) for k, v in o.items()}
            for B, o in out.items()}


@pytest.fixture(scope="module")
def jax_cola():
    """fastbox_tpu's make_sharded_cola on 4 virtual devices, key SEED."""
    grid = JaxGrid.create(box_scale=(BOX,) * 3, nsamp=N, redshift=0.0)
    fn = j_sharded_cola(Mesh(np.asarray(jax.devices()[:4]), ("space",)),
                        grid, jax_cosmology(COSMO, redshift=0.0),
                        dtype=jnp.float64, **COLA_KW)
    return jax.tree.map(np.asarray, fn(jax.random.PRNGKey(SEED)))


@pytest.fixture(scope="module")
def mesh1():
    """A one-rank ('ens' 1, 'space' 1) mesh in this process, on gloo."""
    assert not dist.is_initialized()
    yield make_mesh(device="cpu")
    dist.destroy_process_group()


def cat(results, key, B, axis=0):
    """The full cube of ``key`` from the ranks' slabs."""
    return np.concatenate([r["lattice"][B][key].numpy() for r in results],
                          axis=axis)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("B", BANDS)
def test_halo_primitives_match_fastbox_tpu(ranks, jax_lattice, world, B):
    res = ranks[world]
    want = jax_lattice[B]
    for key, axis in (("paint", 0), ("paint_w", 0), ("paint_many", 1),
                      ("gather_many", 1)):
        np.testing.assert_allclose(cat(res, key, B, axis), want[key],
                                   rtol=RTOL, atol=RTOL, err_msg=key)
    gather = np.concatenate([r["lattice"][B]["gather_single"][0].numpy()
                             for r in res])
    np.testing.assert_allclose(gather, want["gather"], rtol=RTOL, atol=RTOL)
    # the unweighted paint conserves the particle count
    assert abs(cat(res, "paint", B).sum() - N**3) < 1e-8


@pytest.mark.parametrize("world", WORLDS)
def test_many_forms_equal_per_channel_calls(ranks, world):
    for r in ranks[world]:
        for B in BANDS:
            out = r["lattice"][B]
            for c in range(3):
                assert torch.equal(out["paint_many"][c],
                                   out["paint_single"][c])
                assert torch.equal(out["gather_many"][c],
                                   out["gather_single"][c])


@pytest.mark.parametrize("B", (1, 2, 3))
def test_slab_twins_equal_periodic_twins(B):
    """A slab covering the whole cube, its strips folded periodically, is
    the periodic paint; four slabs' buffers, each strip added to its
    neighbour, too.  The gather of the periodically extended mesh is the
    periodic gather bit for bit (the same sums in the same order)."""
    rng = np.random.default_rng(10 + B)
    disp = torch.as_tensor(bounded_disp(rng, N, B))
    d = tuple(disp[..., i].contiguous() for i in range(3))
    mesh = torch.as_tensor(rng.standard_normal((N, N, N)))
    H = B + 1
    want = twin.cic_paint_lattice(d, B, mesh, openband=False)
    for nslab in (1, 4):
        S = N // nslab
        full = torch.zeros((N, N, N), dtype=torch.float64)
        for k in range(nslab):
            buf = twin.cic_paint_lattice_slab(
                tuple(a[k * S:(k + 1) * S] for a in d), B,
                mesh[k * S:(k + 1) * S])
            rows = torch.arange(k * S - H, (k + 1) * S + H) % N
            full.index_add_(0, rows, buf)
        np.testing.assert_allclose(full.numpy(), want.numpy(), rtol=RTOL,
                                   atol=RTOL)
    ext = torch.cat([mesh[-H:], mesh, mesh[:H]])
    for got, ref in zip(twin.cic_gather3_lattice_slab((ext, ext, ext), d, B),
                        twin.cic_gather3_lattice((mesh,) * 3, d, B,
                                                 openband=False)):
        assert torch.equal(got, ref)


def test_slab_dispatch_takes_the_twins_on_the_cpu_and_the_kernels_raise():
    rng = np.random.default_rng(4)
    d = tuple(torch.as_tensor(a) for a in
              np.moveaxis(bounded_disp(rng, N, 2)[:8], -1, 0).copy())
    w = torch.as_tensor(rng.standard_normal((8, N, N)))
    ext = torch.as_tensor(rng.standard_normal((14, N, N)))
    assert torch.equal(k11.cic_paint_lattice_slab(d, 2, w),
                       twin.cic_paint_lattice_slab(d, 2, w))
    for got, ref in zip(k11.cic_gather3_lattice_slab_plain((ext,) * 3, d, 2),
                        twin.cic_gather3_lattice_slab((ext,) * 3, d, 2)):
        assert torch.equal(got, ref)
    with pytest.raises(ValueError, match="CUDA"):
        k11.cic_paint_lattice_slab_cuda(d, 2, w)
    with pytest.raises(ValueError, match="CUDA"):
        k11.cic_gather3_lattice_slab_cuda((ext,) * 3, d, 2)
    with pytest.raises(ValueError, match=r"S \+ 2\(B \+ 1\)"):
        k11.cic_gather3_lattice_slab_cuda((ext,) * 3, d, 3)
    with pytest.raises(ValueError, match="B must be"):
        k11.cic_paint_lattice_slab_cuda(d, 0)


def test_slab_paint_channel_stack_is_checked_before_any_build(monkeypatch):
    """The slab paint's (C, S, N, N) weight stack: its shape and C >= 1 are
    checked before the kernels are built; on the CPU a stack paints as a
    stack of twins."""
    from fastbox_tpu_torch.ops.cuda import _build

    def no_build():
        raise AssertionError("the kernels were built")

    monkeypatch.setattr(_build, "load_library", no_build)
    rng = np.random.default_rng(6)
    d = tuple(torch.as_tensor(a) for a in
              np.moveaxis(bounded_disp(rng, N, 2)[:8], -1, 0).copy())
    w3 = torch.as_tensor(rng.standard_normal((3, 8, N, N)))
    got = k11.cic_paint_lattice_slab(d, 2, w3)
    assert got.shape == (3, 8 + 2 * 3, N, N)
    for c in range(3):
        assert torch.equal(got[c], twin.cic_paint_lattice_slab(d, 2, w3[c]))
    for bad in (w3[:0], w3[:, :7], w3[..., :8], w3[None], w3[0, 0]):
        with pytest.raises(ValueError, match="weight stack|must be"):
            k11.cic_paint_lattice_slab_cuda(d, 2, bad)
    with pytest.raises(ValueError, match="CUDA"):
        k11.cic_paint_lattice_slab_cuda(d, 2, w3)
    with pytest.raises(ValueError, match="B must be"):
        k11.cic_paint_lattice_slab_cuda(d, 17, w3)


def assert_cola_matches(outs, want):
    """The ranks' results against fastbox_tpu's at its tolerances."""
    np.testing.assert_allclose(
        np.concatenate([o["delta_x"].numpy() for o in outs]),
        want["delta_x"], rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(
        np.concatenate([o["vel"].numpy() for o in outs], axis=1),
        want["vel"], rtol=1e-7, atol=1e-6)
    for o in outs:   # every rank holds the global values
        assert o["max_disp"].dim() == 0
        assert abs(float(o["max_disp"]) - float(want["max_disp"])) < 1e-8
        np.testing.assert_allclose(o["k"].numpy(), want["k"], rtol=1e-12)
        np.testing.assert_allclose(o["pk"].numpy(), want["pk"], rtol=1e-8,
                                   equal_nan=True)
        np.testing.assert_allclose(o["pk_err"].numpy(), want["pk_err"],
                                   rtol=1e-6, atol=1e-12, equal_nan=True)
    assert float(want["max_disp"]) <= COLA_KW["lattice_B"]


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_cola_matches_fastbox_tpu(ranks, jax_cola, world):
    assert_cola_matches([r["cola"][0] for r in ranks[world]], jax_cola)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_cola_from_a_seed_matches_fastbox_tpu(ranks, jax_cola, world):
    """The port draws the white field from SEED itself (parallel.rng:
    fastbox_tpu's field for PRNGKey(SEED)) on every rank count."""
    assert_cola_matches([r["cola"][-1] for r in ranks[world]], jax_cola)


def test_sharded_cola_rank_counts_agree(ranks):
    def field(world, key, axis=0):
        return np.concatenate([r["cola"][0][key].numpy()
                               for r in ranks[world]], axis=axis)

    for world in (2, 4):
        np.testing.assert_allclose(field(world, "delta_x"), field(1, "delta_x"),
                                   rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(field(world, "vel", 1), field(1, "vel", 1),
                                   rtol=1e-7, atol=1e-6)


def test_sharded_cola_ensemble_equals_single_calls(ranks):
    for r in ranks[4]:
        ens, single = r["cola"][1]["ensemble"], r["cola"][1]["single"]
        assert ens["pk"].shape == (len(ENS_SEEDS), COLA_KW["pk_nbins"] - 1)
        assert ens["max_disp"].shape == (len(ENS_SEEDS),)
        assert "vel" not in ens
        assert torch.equal(ens["k"], single[0]["k"])
        for b, one in enumerate(single):
            for key in ("delta_x", "max_disp", "pk", "pk_err"):
                assert torch.equal(ens[key][b].nan_to_num(),
                                   one[key].nan_to_num()), key


def test_sharded_cola_fields_off_and_errors(mesh1):
    mesh, group1 = mesh1, mesh1.get_group("space")
    grid = GridSpec.create(box_scale=BOX, nsamp=N)
    cosmo = build_cosmology(COSMO)
    fn = make_sharded_cola(mesh, grid, cosmo, dtype=torch.float64,
                           fields=False, device="cpu", **COLA_KW)
    out = fn(white=jax_white())
    assert set(out) == {"max_disp", "k", "pk", "pk_err"}
    with pytest.raises(ValueError, match="requires pk_nbins"):
        make_sharded_cola(mesh, grid, cosmo, fields=False, device="cpu")
    with pytest.raises(ValueError, match="seed or the white field"):
        fn()
    # a slab lower than B + 1 rows cannot carry the band
    small = GridSpec.create(box_scale=BOX, nsamp=2)
    with pytest.raises(ValueError, match="slab height"):
        make_sharded_cola(mesh, small, cosmo, lattice_B=2, device="cpu")
    d = tuple(torch.zeros((2, N, N), dtype=torch.float64) for _ in range(3))
    with pytest.raises(ValueError, match="slab height"):
        halo_paint(d, 2, group1)
    with pytest.raises(ValueError, match="slab height"):
        halo_gather(torch.zeros((2, N, N), dtype=torch.float64), d, 2, group1)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no CUDA device"):
            make_sharded_cola(mesh, grid, cosmo)


def test_one_rank_halo_wraps_onto_itself(mesh1):
    """With one rank on 'space' the strips land on the rank's own slab: the
    periodic twins' results, without a collective."""
    group1 = mesh1.get_group("space")
    disp, w, m = lattice_inputs()
    d = tuple(torch.as_tensor(disp[2][..., i]).contiguous() for i in range(3))
    w, m = torch.as_tensor(w), torch.as_tensor(m)
    np.testing.assert_allclose(
        halo_paint(d, 2, group1, weights=w).numpy(),
        twin.cic_paint_lattice(d, 2, w, openband=False).numpy(), rtol=RTOL,
        atol=RTOL)
    np.testing.assert_allclose(
        halo_paint_many(d, 2, group1, m).numpy(),
        torch.stack([twin.cic_paint_lattice(d, 2, c, openband=False)
                     for c in m]).numpy(), rtol=RTOL, atol=RTOL)
    for got, c in zip(halo_gather_many(m, d, 2, group1), m):
        assert torch.equal(got, twin.cic_gather_lattice(c, d, 2,
                                                        openband=False))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (chip_smoke.py runs the kernels there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
@pytest.mark.parametrize("B", (1, 2, 3))
@pytest.mark.parametrize("n, S", ((64, 64), (64, 16), (62, 8)))
def test_slab_kernels_equal_twins(cuda, B, dtype, n, S):
    """K11a/K11c's slab mode bit for bit against the slab twins (the
    staged gather at 64, the direct path on 62-cell rows), repeatable.  The
    paint also on the minimum slab S = B + 1 and on the order test's cases
    (uniform, across the y/z wrap, a region aimed at one cell, integer
    displacements, |d| > B), unweighted, weighted and with a C = 3 weight
    stack, which equals three single-channel twins."""
    gen = torch.Generator(device=cuda).manual_seed(100 * B + S)
    d = tuple(((torch.rand((S, n, n), generator=gen, device=cuda,
                           dtype=dtype) * 2 - 1) * B).contiguous()
              for _ in range(3))
    w = torch.randn((S, n, n), generator=gen, device=cuda, dtype=dtype)
    exts = tuple(torch.randn((S + 2 * (B + 1), n, n), generator=gen,
                             device=cuda, dtype=dtype) for _ in range(3))
    for wt in (None, w):
        got = k11.cic_paint_lattice_slab_cuda(d, B, wt)
        assert torch.equal(got, k11.cic_paint_lattice_slab_plain(d, B, wt))
        assert torch.equal(got, k11.cic_paint_lattice_slab_cuda(d, B, wt))
    got = k11.cic_gather3_lattice_slab_cuda(exts, d, B)
    for a, b in zip(got, k11.cic_gather3_lattice_slab_plain(exts, d, B)):
        assert torch.equal(a, b)
    rng = np.random.default_rng(100 * B + S + n)
    for rows in (S, B + 1):
        for kind in KINDS:
            dk = tuple(torch.as_tensor(a, dtype=dtype, device=cuda)
                       .contiguous() for a in slab_disp(rng, kind, rows, n, B))
            w3 = torch.as_tensor(rng.standard_normal((3, rows, n, n)),
                                 dtype=dtype, device=cuda)
            for wt in (None, w3[0], w3):
                got = k11.cic_paint_lattice_slab_cuda(dk, B, wt)
                assert torch.equal(
                    got, k11.cic_paint_lattice_slab_plain(dk, B, wt)), kind
                assert torch.equal(
                    got, k11.cic_paint_lattice_slab_cuda(dk, B, wt)), kind
