"""The mock plan (``fastbox_tpu_torch/mock_plan.py``) that the single
pipeline and the sharded ensemble step share.

On the CPU at 16^3, in a 4 Gpc cube and in an anisotropic 4 x 4 x 2 Gpc
box, with one intra-op thread.  ``BinPlan``: for each route (K4 'v2', K4t
'v2t', K5 'on', the plain reduction 'off') the sums of P row slabs add up
to the whole cube's (counts exactly; float64 sums within 1e-12, float32
sums within the rounding of each slab's float64 sums to float32), the
whole plan's sums are those of a direct call of the route's reduction on
the operands the entry points built for it before the plan existed, and
``finish`` is the numpy formula.  ``MockPlan``: a slab's plan is the rows
of the whole plan.  The ``pk_debias`` check, the warning off cubic grids
and the plan's place in the imports.
"""
import ast
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from fastbox_tpu_torch.cosmology import build_cosmology
from fastbox_tpu_torch.grid import GridSpec
from fastbox_tpu_torch.mock_plan import BinPlan, MockPlan
from fastbox_tpu_torch.ops import spectra as spectra_ops
from fastbox_tpu_torch.ops.cuda.binned_pk import binned_pk_half_dual
from fastbox_tpu_torch.ops.cuda.binned_pk_v2 import binned_pk_half_dual_v2
from fastbox_tpu_torch.ops.reduce import binned_weighted_dual
from fastbox_tpu_torch.pipeline import PipelineConfig

COSMO = dict(Omega_c=0.25, Omega_b=0.05, h=0.7, n_s=0.95, sigma8=0.8)
N, Z, NBINS = 16, 0.8, 8
H = N // 2 + 1
BOXES = {"cube": 4e3, "aniso": (4e3, 4e3, 2e3)}
# (box, pallas_pk): K4 and K4t need the cube's integer lattice
ROUTES = [("cube", "v2"), ("cube", "v2t"), ("cube", "on"), ("cube", "off"),
          ("aniso", "on"), ("aniso", "off")]
DTYPES = [torch.float32, torch.float64]
PORT = Path(__file__).resolve().parents[1] / "fastbox_tpu_torch"


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cosmo():
    return build_cosmology(COSMO, redshift=Z, device="cpu")


def grid_of(box: str) -> GridSpec:
    return GridSpec.create(box_scale=BOXES[box], nsamp=N, redshift=Z)


def slabs(P: int) -> list:
    n = N // P
    return [slice(s * n, (s + 1) * n) for s in range(P)]


def powers(dtype, seed=0):
    """Two positive half-spectrum power cubes with a wide spread."""
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.exp(2.0 * torch.randn((N, N, H), generator=g,
                                             dtype=torch.float64)).to(dtype)
                 for _ in range(2))


@pytest.mark.parametrize("P", [1, 2, 4])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("box,pallas_pk", ROUTES)
def test_slab_sums_add_up_to_the_whole(box, pallas_pk, dtype, P):
    grid = grid_of(box)
    p1, p2 = powers(dtype)
    whole = BinPlan(grid, NBINS, pallas_pk, dtype, "cpu")
    want = whole.sums(p1, p2)
    parts = [BinPlan(grid, NBINS, pallas_pk, dtype, "cpu", rows).sums(
        p1[rows], p2[rows]) for rows in slabs(P)]
    assert whole.hoisted == (pallas_pk in ("v2", "v2t"))
    if whole.hoisted:
        assert want[3] is None and all(p[3] is None for p in parts)
    else:
        assert torch.equal(sum(p[3].double() for p in parts),
                           want[3].double())
    # float32: each slab's float64 sums are rounded to float32 once
    rtol = 1e-12 if dtype == torch.float64 else (P + 1) * 2.0 ** -24
    for i in range(3):
        got = sum(p[i].double() for p in parts)
        torch.testing.assert_close(got, want[i].double(), rtol=rtol, atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("box,pallas_pk", ROUTES)
def test_whole_plan_is_the_direct_call(box, pallas_pk, dtype):
    """The route's reduction on the operands ``make_pipeline`` built for
    it inline before the plan: the same bits."""
    grid = grid_of(box)
    p1, p2 = powers(dtype, seed=1)
    plan = BinPlan(grid, NBINS, pallas_pk, dtype, "cpu")
    kz_weight = np.full(H, 2.0)
    kz_weight[0] = kz_weight[-1] = 1.0
    kzw = torch.as_tensor(kz_weight, dtype=dtype)
    edges = np.asarray(spectra_ops.default_kbins(grid, NBINS))
    thr = spectra_ops.kbin_thresholds(grid, edges)
    if pallas_pk in ("v2", "v2t"):
        fi2 = spectra_ops._index_sq(grid)
        fi2_j = torch.as_tensor(fi2, dtype=torch.int32)
        want = (*binned_pk_half_dual_v2(
            p1, p2, fi2_j, fi2_j, torch.as_tensor(fi2[:H], dtype=torch.int32),
            kzw, torch.as_tensor(thr, dtype=torch.int32),
            telescoped=pallas_pk == "v2t"), None)
        assert torch.equal(plan.counts, torch.as_tensor(
            spectra_ops.hoisted_counts(grid, thr, kz_weight), dtype=dtype))
    elif pallas_pk == "on":
        kx2, ky2, kz2, edges2 = spectra_ops.kbin_plan(grid, edges, dtype,
                                                      "cpu")
        want = binned_pk_half_dual(p1, p2, kx2, ky2, kz2[:H].contiguous(),
                                   kzw, edges2)
    else:
        bin_idx = spectra_ops._bin_index(grid, edges, thr, H, dtype, "cpu")
        w = torch.broadcast_to(kzw[None, None, :], (N, N, H)).reshape(-1)
        s1, q1, s2, _, cnt = binned_weighted_dual(
            p1.reshape(-1), p2.reshape(-1), w, bin_idx, edges.size)
        want = (s1, q1, s2, cnt)
    got = plan.sums(p1, p2)
    for g, w in zip(got, want):
        assert (g is None and w is None) or (g.dtype == w.dtype
                                            and torch.equal(g, w))
    torch.testing.assert_close(plan.k, torch.as_tensor(
        0.5 * (edges[1:] + edges[:-1]), dtype=dtype), rtol=0, atol=0)


@pytest.mark.parametrize("batch", [(), (3,)])
@pytest.mark.parametrize("debias", [False, True])
@pytest.mark.parametrize("hoisted", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_finish_is_the_numpy_formula(dtype, hoisted, debias, batch):
    """The formula in numpy in the plan's dtype: the same operations, so
    only the square roots may differ, by an ulp."""
    npdt = np.float32 if dtype == torch.float32 else np.float64
    g = np.random.default_rng(7)
    nb = NBINS
    d = tuple(g.normal(0.0, 1e-3, nb - 1)) if debias else None
    plan = BinPlan(grid_of("cube"), nb, "v2" if hoisted else "off", dtype,
                   "cpu", pk_debias=d)
    s1 = g.lognormal(0.0, 2.0, (*batch, nb)).astype(npdt)
    q1 = (s1 ** 2 * g.uniform(0.2, 2.0, s1.shape)).astype(npdt)
    s2 = g.lognormal(0.0, 2.0, (*batch, nb)).astype(npdt)
    if hoisted:
        cnt, arg = plan.counts.numpy(), None
    else:
        # empty, single-mode and populated bins
        cnt = np.broadcast_to(np.arange(nb, dtype=npdt) * 3 % 7,
                              s1.shape).copy()
        cnt[..., :2] = (0.0, 1.0)
        arg = torch.from_numpy(cnt)
    got = plan.finish(*(torch.from_numpy(a) for a in (s1, q1, s2)), arg)
    with np.errstate(divide="ignore", invalid="ignore"):
        mean = s1 / cnt
        var = np.maximum(q1 / cnt - mean ** 2, npdt(0.0))
        var = np.where(cnt > 1, var, npdt(0.0))
        want = {"pk_cleaned": mean[..., 1:] - (np.asarray(d, npdt) if debias
                                                else npdt(0.0)),
                "pk_cleaned_err": (np.sqrt(var) / np.sqrt(cnt))[..., 1:],
                "pk_density": (s2 / cnt)[..., 1:]}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == dtype and got[k].shape == v.shape, k
        torch.testing.assert_close(got[k], torch.from_numpy(v),
                                   rtol=4 * torch.finfo(dtype).eps, atol=0,
                                   equal_nan=True)


@pytest.mark.parametrize("nbins", [8, 20])
def test_pk_debias_length_is_checked(cosmo, nbins):
    grid = grid_of("cube")
    with pytest.raises(ValueError,
                       match=f"pk_debias must have length {nbins - 1}"):
        BinPlan(grid, nbins, "auto", torch.float32, "cpu", pk_debias=(0.0,))
    with pytest.raises(ValueError,
                       match=f"pk_debias must have length {nbins - 1}"):
        MockPlan(grid, cosmo, PipelineConfig(nbins=nbins, pk_debias=(0.0,)),
                 "cpu")
    d = tuple(np.linspace(-1.0, 1.0, nbins - 1))
    plan = BinPlan(grid, nbins, "auto", torch.float64, "cpu", pk_debias=d)
    assert torch.equal(plan.debias, torch.as_tensor(d, dtype=torch.float64))
    assert BinPlan(grid, nbins, "auto", torch.float64, "cpu").debias is None


@pytest.mark.parametrize("box,pallas_pk,route,warns", [
    ("aniso", "v2", "v1", "v1 kernel"),
    ("aniso", "v2t", "v1", "dropping telescoping"),
    ("aniso", "auto", "v1", None),
    ("cube", "auto", "v2", None),
    ("cube", "v2t", "v2t", None),
    ("cube", "on", "v1", None),
    ("cube", "off", "plain", None),
])
def test_route_and_its_warning_off_the_cube(box, pallas_pk, route, warns):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        plan = BinPlan(grid_of(box), NBINS, pallas_pk, torch.float32, "cpu")
    assert plan.route == route
    msgs = [str(w.message) for w in caught
            if issubclass(w.category, UserWarning)]
    if warns is None:
        assert msgs == []
    else:
        assert len(msgs) == 1 and warns in msgs[0]


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("box", ["cube", "aniso"])
def test_slab_plan_is_rows_of_the_whole(cosmo, box, P):
    grid = grid_of(box)
    cfg = PipelineConfig(nbins=NBINS, beam_dish_m=15.0, kpar_min=0.02,
                         pallas_pk="off")
    whole = MockPlan(grid, cosmo, cfg, "cpu")
    w_vz, w_beam = whole.vz_weight(), whole.beam(N)
    for rows in slabs(P):
        part = MockPlan(grid, cosmo, cfg, "cpu", rows)
        for name in ("bias", "Tb", "Hz", "vel_fac", "fg_poly",
                     "fg_sigma_pix", "alpha_sigma_pix"):
            assert getattr(part, name) == getattr(whole, name), name
        for name in ("sigma", "freqs", "ffac_mean", "logf", "kpar_filter",
                     "boxfactor"):
            assert torch.equal(getattr(part, name), getattr(whole, name))
        assert torch.equal(part.amp_half, whole.amp_half[rows])
        assert torch.equal(part.vz_weight(), w_vz[rows])
        assert torch.equal(part.beam(N), w_beam[rows])
        assert torch.equal(part.beam(H), whole.beam(H)[rows])


def _imports(path: Path):
    """(module, names, level, under TYPE_CHECKING) of each import."""
    tree = ast.parse(path.read_text())
    guarded = {id(n) for node in ast.walk(tree) if isinstance(node, ast.If)
               and ast.unparse(node.test) == "TYPE_CHECKING"
               for n in ast.walk(node)}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            yield (node.module or "", [a.name for a in node.names],
                   node.level, id(node) in guarded)
        elif isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, [], 0, id(node) in guarded


@pytest.mark.parametrize("module", ["parallel/sharded.py", "mock_plan.py"])
def test_the_plan_sits_below_the_entry_points(module):
    """``parallel/sharded.py`` takes no private name from ``pipeline``;
    ``mock_plan.py`` imports neither jax nor ``pipeline`` at run time."""
    for name, names, level, typing_only in _imports(PORT / module):
        from_pipeline = name.split(".")[-1] == "pipeline" and (
            level > 0 or name.startswith("fastbox_tpu_torch"))
        if module == "mock_plan.py":
            assert not name.startswith("jax")
            assert typing_only or not from_pipeline, name
        elif from_pipeline:
            assert not [n for n in names if n.startswith("_")], names
