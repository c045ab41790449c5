"""The port's parallel/ slice on the CPU: slab FFTs, the row-keyed draws,
the sharded ensemble step and ``make_ensemble_pipeline(mesh=...)``.

The step is held to ``fastbox_tpu.parallel.make_sharded_ensemble_step``
(on JAX's 8 virtual CPU devices, a (2, 4) mesh) with fastbox_tpu's own
``row_normal`` fields injected as ``draws``, at the tolerances of
tests/test_parallel.py; and to itself on a one-rank mesh in this process,
on (1, 2) and (2, 2) meshes of gloo ranks (``parallel.local``), and to the
single pipeline in ``noise_scheme='rows'``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from fastbox_tpu.cosmology import build_cosmology as jax_build_cosmology
from fastbox_tpu.grid import GridSpec as JaxGrid
from fastbox_tpu.parallel import make_mesh as jax_make_mesh
from fastbox_tpu.parallel import make_sharded_ensemble_step as jax_step
from fastbox_tpu.parallel.rng import TAGS as JAX_TAGS
from fastbox_tpu.parallel.rng import default_row_method
from fastbox_tpu.parallel.rng import row_normal as jax_row_normal
from fastbox_tpu.pipeline import PipelineConfig as JaxConfig
from fastbox_tpu.pipeline import _build_pipeline
from fastbox_tpu.pipeline import make_pipeline as jax_make
from fastbox_tpu_torch.convert import from_jax_state
from fastbox_tpu_torch.fields.cola import ColaEngine
from fastbox_tpu_torch.grid import GridSpec
from fastbox_tpu_torch.parallel import fft as pf
from fastbox_tpu_torch.parallel import (largest_pow2_divisor, local,
                                        make_mesh, make_sharded_ensemble_step)
from fastbox_tpu_torch.parallel.mesh import axis_group
from fastbox_tpu_torch.parallel.rng import (ROW_NDIM, TAGS, row_complex_normal,
                                            row_draws, row_normal)
from fastbox_tpu_torch.pipeline import (ROWS_DRAW_NAMES, PipelineConfig,
                                        calibrate_pk_debias,
                                        make_chained_pipeline,
                                        make_ensemble_pipeline, make_pipeline)
from test_torch_pipeline import COSMO, jax_state

N = 16
Z = 0.8
BOX = 1e3
ANISO = (1e3, 1e3, 5e2)
OUTPUTS = ("pk_cleaned", "pk_cleaned_err", "pk_density", "sigma_data")

# name -> (box, config): tests/test_parallel.py:129-174's two, and an
# anisotropic box, whose P(k) takes K5's plan with its counts all-reduced
CONFIGS = {
    "instrument": (BOX, dict(dtype="float64", nbins=8, noise_scheme="rows",
                             sigma_nl=120.0, beam_dish_m=13.5, kpar_min=0.02,
                             pca_nmodes=3)),
    "nearest": (BOX, dict(dtype="float64", nbins=8, noise_scheme="rows",
                          sigma_nl=0.0, rsd_method="nearest",
                          pca_exact=False, include_foregrounds=False,
                          include_noise=False, pca_nmodes=2)),
    "aniso": (ANISO, dict(dtype="float64", nbins=8, noise_scheme="rows",
                          pca_nmodes=3)),
}


def assert_outputs_close(got, want, rtol=1e-7, atol=1e-12, sigma_rtol=1e-9):
    """fastbox_tpu's parity tolerances (tests/test_parallel.py:149-153)."""
    got = {k: np.asarray(v) for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    for name in OUTPUTS[:3]:
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name], want[name], rtol=rtol,
                                   atol=atol, equal_nan=True, err_msg=name)
    np.testing.assert_allclose(got["sigma_data"], want["sigma_data"],
                               rtol=sigma_rtol)


def jax_row_fields(key) -> dict:
    """fastbox_tpu's full-field rows of every stream, by TAGS name."""
    method = default_row_method(N)
    return {n: np.asarray(jax_row_normal(key, JAX_TAGS[n], 0, N,
                                         (N,) * ROW_NDIM[n], jnp.float64,
                                         method))
            for n in ROWS_DRAW_NAMES}


@functools.lru_cache(maxsize=None)
def inputs_for(box) -> dict:
    """fastbox_tpu's grid, cosmology, its state and amp_half for ``box``,
    and the port's grid, cosmology and amp_half built from them."""
    jgrid = JaxGrid.create(box_scale=box, nsamp=N, redshift=Z)
    jcosmo = jax_build_cosmology(COSMO, redshift=Z)
    _, (amp, _) = _build_pipeline(jgrid, jcosmo, JaxConfig(dtype="float64"))
    state = jax_state(jcosmo, amp)
    cosmo, amp_t = from_jax_state(state)
    grid = GridSpec.create(box_scale=box, nsamp=N, redshift=Z)
    return dict(box=box, jgrid=jgrid, jcosmo=jcosmo, state=state, grid=grid,
                cosmo=cosmo, amp=amp_t)


@pytest.fixture(scope="module")
def inputs():
    return inputs_for(BOX)


@pytest.fixture(scope="module")
def mesh1():
    """A one-rank ('ens' 1, 'space' 1) mesh in this process, on gloo."""
    assert not dist.is_initialized()
    mesh = make_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


@pytest.fixture(scope="module", params=list(CONFIGS))
def case(request):
    """fastbox_tpu's sharded step and single rows-mode pipeline on two keys,
    and the fields those keys draw."""
    box, kw = CONFIGS[request.param]
    inputs = inputs_for(box)
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    jcfg = JaxConfig(**kw)
    step = jax_step(jax_make_mesh(8, space=4, grid_n=N), inputs["jgrid"],
                    inputs["jcosmo"], jcfg)
    single = jax_make(inputs["jgrid"], inputs["jcosmo"], jcfg)
    return dict(
        name=request.param, config=PipelineConfig(**kw), inputs=inputs,
        step={k: np.asarray(v) for k, v in step(keys).items()},
        single=[{k: np.asarray(v) for k, v in single(k_).items()}
                for k_ in keys],
        draws=[jax_row_fields(k_) for k_ in keys])


@pytest.fixture(scope="module")
def port_step(case, mesh1):
    inputs = case["inputs"]
    step = make_sharded_ensemble_step(mesh1, inputs["grid"], inputs["cosmo"],
                                      case["config"], "cpu", inputs["amp"])
    return step(draws=case["draws"])


def test_step_matches_fastbox_tpu(case, port_step):
    assert port_step["pk_cleaned"].shape == (2, 7)
    np.testing.assert_allclose(port_step["k"].numpy(), case["step"]["k"],
                               rtol=1e-12)
    assert_outputs_close(port_step, case["step"])
    assert np.isfinite(port_step["pk_density"].numpy()).sum() >= 12


def test_rows_pipeline_matches_fastbox_tpu(case):
    """The single pipeline in noise_scheme='rows' on fastbox_tpu's row
    fields, against fastbox_tpu's single pipeline on the same keys."""
    inputs = case["inputs"]
    fn = make_pipeline(inputs["grid"], inputs["cosmo"], case["config"],
                       device="cpu", amp_half=inputs["amp"])
    for d, want in zip(case["draws"], case["single"]):
        got = fn(draws={k: torch.tensor(v) for k, v in d.items()})
        assert_outputs_close(got, want)


def test_step_equals_rows_pipeline(case, port_step):
    """The step and the single rows-mode pipeline of the port agree on the
    same fields (their FFT decomposition and remap kernels differ)."""
    inputs = case["inputs"]
    fn = make_pipeline(inputs["grid"], inputs["cosmo"], case["config"],
                       device="cpu", amp_half=inputs["amp"])
    for i, d in enumerate(case["draws"]):
        got = fn(draws={k: torch.tensor(v) for k, v in d.items()})
        assert_outputs_close({k: port_step[k][i] for k in OUTPUTS}, got)


def test_rows_pipeline_draws_from_a_seed(inputs):
    """Without draws, rows mode draws the fields of ``seed`` (default: the
    generator's initial seed) with parallel.rng."""
    cfg = PipelineConfig(**CONFIGS["instrument"][1])
    fn = make_pipeline(inputs["grid"], inputs["cosmo"], cfg, device="cpu",
                       amp_half=inputs["amp"])
    a = fn(torch.Generator().manual_seed(31))
    b = fn(seed=31)
    c = fn(draws=row_draws(31, ROWS_DRAW_NAMES, N, dtype=torch.float64,
                           device="cpu"))
    for k in OUTPUTS:
        assert torch.equal(a[k].nan_to_num(), b[k].nan_to_num()), k
        assert torch.equal(a[k].nan_to_num(), c[k].nan_to_num()), k
    assert not torch.equal(a["sigma_data"], fn(seed=32)["sigma_data"])
    half = make_pipeline(inputs["grid"], inputs["cosmo"],
                         PipelineConfig(dtype="float64"), device="cpu")
    with pytest.raises(ValueError, match="noise_scheme='rows'"):
        half(seed=31)


def test_step_applies_pk_debias(inputs, mesh1):
    """The step subtracts pk_debias from the retained cleaned bins, as the
    single pipeline does, and refuses a wrong length with its message."""
    kw = CONFIGS["instrument"][1]
    d = tuple(np.linspace(-1e-3, 1e-3, kw["nbins"] - 1))
    args = (mesh1, inputs["grid"], inputs["cosmo"])
    cfg = PipelineConfig(**kw, pk_debias=d)
    seeds = [21, 22]
    plain = make_sharded_ensemble_step(*args, PipelineConfig(**kw), "cpu",
                                       inputs["amp"])(seeds=seeds)
    got = make_sharded_ensemble_step(*args, cfg, "cpu",
                                     inputs["amp"])(seeds=seeds)
    want = plain["pk_cleaned"] - torch.tensor(d, dtype=torch.float64)
    assert torch.equal(got["pk_cleaned"].nan_to_num(), want.nan_to_num())
    for k in OUTPUTS[1:]:
        assert torch.equal(got[k].nan_to_num(), plain[k].nan_to_num()), k
    single = make_pipeline(inputs["grid"], inputs["cosmo"], cfg,
                           device="cpu", amp_half=inputs["amp"])
    for i, seed in enumerate(seeds):
        assert_outputs_close({k: got[k][i] for k in OUTPUTS},
                             single(seed=seed))
    with pytest.raises(ValueError, match="pk_debias must have length 7"):
        make_sharded_ensemble_step(*args, PipelineConfig(**kw,
                                                         pk_debias=(0.0,)),
                                   "cpu", inputs["amp"])


def test_step_f32_clean_runs_in_f64(monkeypatch, inputs, mesh1):
    """A float32 step cleans in float64, as pca_filter does
    (test_torch_foregrounds_pca.py::test_f32_clean_runs_in_f64): the
    all-reduced mean spectrum, the centring, the covariance and both
    projections, with only the cleaned cube rounded (ROADMAP C3).  Under a
    foreground monopole 3e3 times the signal, an f32 mean spectrum stays in
    every pixel of its channel, and the f32-cleaned step's worst pk_cleaned
    error over 8 seeds, against the f64 step on the same f32 row draws, was
    10x the single rows pipeline's (which cleans in f64) at 16^3; cleaned
    in f64 it is 0.9x.  The bar is 1.5x, the one --truth-256 holds the card
    to.  The covariance the eigh decomposes is float64."""
    from fastbox_tpu_torch.parallel import sharded

    kw = dict(nbins=8, noise_scheme="rows", pca_nmodes=3, fg_monopole=3e3)
    c32 = PipelineConfig(**kw)
    c64 = PipelineConfig(**kw, dtype="float64")
    d32 = [row_draws(s, ROWS_DRAW_NAMES, N, dtype=torch.float32, device="cpu")
           for s in range(1, 9)]
    d64 = [{k: v.double() for k, v in d.items()} for d in d32]
    covs = []

    def top(cov, nmodes):
        covs.append(cov)
        return top_eigvecs(cov, nmodes)

    top_eigvecs = sharded.top_eigvecs
    monkeypatch.setattr(sharded, "top_eigvecs", top)
    args = (mesh1, inputs["grid"], inputs["cosmo"])
    s32 = make_sharded_ensemble_step(*args, c32, "cpu", inputs["amp"])(
        draws=d32)
    assert [c.dtype for c in covs] == [torch.float64]
    assert s32["pk_cleaned"].dtype == torch.float32
    s64 = make_sharded_ensemble_step(*args, c64, "cpu", inputs["amp"])(
        draws=d64)
    single = {c.dtype: make_pipeline(inputs["grid"], inputs["cosmo"], c,
                                     device="cpu", amp_half=inputs["amp"])
              for c in (c32, c64)}
    p32 = torch.stack([single["float32"](draws=d)["pk_cleaned"]
                       for d in d32])
    p64 = torch.stack([single["float64"](draws=d)["pk_cleaned"]
                       for d in d64])
    # the f64 step and the f64 single pipeline agree: the same oracle
    torch.testing.assert_close(s64["pk_cleaned"], p64, rtol=1e-8, atol=0,
                               equal_nan=True)

    def worst(got, want):
        # the last bin holds no mode at 16^3 (NaN in every run)
        return ((got.double() - want).abs() / want.abs()).nan_to_num() \
            .max().item()

    err_step = worst(s32["pk_cleaned"], s64["pk_cleaned"])
    err_single = worst(p32, p64)
    assert err_step <= 1.5 * err_single, (err_step, err_single)


def spec(name: str, **kw) -> dict:
    """A ``parallel.local`` task spec of configuration ``name``."""
    box, config = CONFIGS[name]
    return dict(grid=(box, N, Z), state=inputs_for(box)["state"],
                config=config, **kw)


# (world, index into the world's steps, configuration) of each gloo step
GLOO_STEPS = {"mesh1x2": (2, 0, "instrument"), "mesh2x2": (4, 0, "instrument"),
              "aniso_mesh1x2": (2, 1, "aniso")}


@pytest.fixture(scope="module")
def ranks():
    """The FFT helpers and the steps of GLOO_STEPS ('space' 2) on 2 gloo
    ranks ((1, 2) mesh) and on 4 ((2, 2), the FFTs at space 4), plus
    make_ensemble_pipeline over 4 'ens' ranks."""
    rng = np.random.default_rng(3)
    xr = torch.as_tensor(rng.standard_normal((2, N, N, N)))
    xc = torch.complex(xr, torch.as_tensor(rng.standard_normal((2, N, N, N))))
    draws = [jax_row_fields(k) for k in
             jax.random.split(jax.random.PRNGKey(5), 2)]
    payload = dict(fft=dict(complex=xc, real=xr),
                   ensemble=spec("instrument", seeds=(1, 2, 3, 4)))
    out = {}
    for world, tasks in ((2, ["fft", "sharded_step"]),
                         (4, ["fft", "sharded_step", "ensemble"])):
        steps = [spec(name, draws=draws, space=2)
                 for w, _, name in GLOO_STEPS.values() if w == world]
        out[world] = local.launch("fastbox_tpu_torch.parallel.local:tasks",
                                  world, dict(payload, tasks=tasks,
                                              steps=steps))
    return dict(xr=xr, xc=xc, draws=draws, out=out)


def fft_want(xc, xr) -> dict:
    return {"pfft3": torch.fft.fftn(xc, dim=(1, 2, 3)),
            "pifft3": torch.fft.ifftn(xc, dim=(1, 2, 3)),
            "pfft2": torch.fft.fftn(xc, dim=(1, 2)),
            "pifft2": torch.fft.ifftn(xc, dim=(1, 2)),
            "prfft3": torch.fft.rfftn(xr, dim=(1, 2, 3)),
            "pirfft3": xr}


@pytest.mark.parametrize("space", [1, 2, 4])
def test_fft_helpers_match_torch_fft(ranks, mesh1, space):
    xc, xr = ranks["xc"], ranks["xr"]
    if space == 1:
        group, P, _ = axis_group(mesh1, "space")
        assert P == 1
        got = {"pfft3": pf.pfft3_local(xc, group),
               "pifft3": pf.pifft3_local(xc, group),
               "pfft2": pf.pfft2_local(xc, group),
               "pifft2": pf.pifft2_local(xc, group),
               "prfft3": pf.prfft3_local(xr, group),
               "pirfft3": pf.pirfft3_local(pf.prfft3_local(xr, group), N,
                                           group)}
    else:
        slabs = [r["fft"] for r in ranks["out"][space]]
        got = {k: torch.cat([s[k] for s in slabs], dim=1) for k in slabs[0]}
    for k, want in fft_want(xc, xr).items():
        assert got[k].shape == want.shape, k
        torch.testing.assert_close(got[k], want, rtol=1e-12, atol=1e-10,
                                   msg=k)


@pytest.mark.parametrize("mesh", list(GLOO_STEPS))
def test_step_on_gloo_ranks_equals_one_rank(ranks, mesh1, mesh):
    world, index, name = GLOO_STEPS[mesh]
    box, config = CONFIGS[name]
    inputs = inputs_for(box)
    step = make_sharded_ensemble_step(
        mesh1, inputs["grid"], inputs["cosmo"], PipelineConfig(**config),
        "cpu", inputs["amp"])
    want = step(draws=ranks["draws"])
    results = [r["sharded_step"][index] for r in ranks["out"][world]]
    for got in results:
        # every rank returns the whole batch
        assert_outputs_close(got, want, rtol=1e-8)
    for got in results[1:]:
        for k in OUTPUTS:
            assert torch.equal(got[k].nan_to_num(),
                               results[0][k].nan_to_num()), k


def test_ensemble_mesh_over_gloo_ranks(ranks, inputs):
    cfg = PipelineConfig(**CONFIGS["instrument"][1])
    want = make_ensemble_pipeline(inputs["grid"], inputs["cosmo"], cfg,
                                  device="cpu", amp_half=inputs["amp"])(
        [torch.Generator().manual_seed(s) for s in (1, 2, 3, 4)])
    for r in ranks["out"][4]:
        # the ranks run single-threaded, this process does not: the CPU's
        # sums may round differently, so equal to within rounding
        assert_outputs_close(r["ensemble"], want, rtol=1e-12, atol=0,
                             sigma_rtol=1e-13)


def test_ensemble_mesh_equals_meshless(inputs, mesh1):
    cfg = PipelineConfig(dtype="float64")
    gens = lambda: [torch.Generator().manual_seed(s) for s in (7, 8)]
    a = make_ensemble_pipeline(inputs["grid"], inputs["cosmo"], cfg,
                               device="cpu", mesh=mesh1)(gens())
    b = make_ensemble_pipeline(inputs["grid"], inputs["cosmo"], cfg,
                               device="cpu")(gens())
    assert a["pk_cleaned"].shape == (2, 19)
    for k, v in b.items():
        assert torch.equal(a[k].nan_to_num(), v.nan_to_num()), k


def test_make_mesh_sizes_and_checks_its_ranks(mesh1):
    """fastbox_tpu's default 'space' rule, and a rank count that the process
    group does not have is refused."""
    assert [largest_pow2_divisor(n, cap) for n, cap in
            ((8, 16), (12, 16), (8, 2), (6, 1))] == [8, 4, 2, 1]
    assert mesh1.mesh_dim_names == ("ens", "space")
    assert tuple(mesh1.shape) == (1, 1)
    with pytest.raises(ValueError, match="process group has 1 ranks"):
        make_mesh(2, device="cpu")


def test_row_normal_slabs_are_rows_of_the_full_draw():
    full = row_normal(9, TAGS["noise"], 0, N, (N, N), torch.float64, "cpu")
    for row0, n in ((0, 4), (4, 4), (8, 8), (13, 3)):
        part = row_normal(9, TAGS["noise"], row0, n, (N, N), torch.float64,
                          "cpu")
        assert torch.equal(part, full[row0:row0 + n])
    again = row_normal(9, TAGS["noise"], 0, N, (N, N), torch.float64, "cpu")
    assert torch.equal(full, again)
    other = row_normal(9, TAGS["density"], 0, N, (N, N), torch.float64, "cpu")
    assert not torch.equal(full, other)
    assert abs(full.mean().item()) < 0.1 and abs(full.std().item() - 1) < 0.1
    c = row_complex_normal(9, TAGS["fg_re"], TAGS["fg_im"], 2, 5, (N,),
                           torch.float64, "cpu")
    d = row_draws(9, ("fg_re", "fg_im"), N, dtype=torch.float64,
                  device="cpu")
    assert torch.equal(c.real, d["fg_re"][2:7])
    assert torch.equal(c.imag, d["fg_im"][2:7])


ENTRY_POINTS = {
    "make_pipeline": lambda g, c: make_pipeline(g, c),
    "make_chained_pipeline": lambda g, c: make_chained_pipeline(g, c),
    "make_ensemble_pipeline": lambda g, c: make_ensemble_pipeline(g, c),
    "calibrate_pk_debias": lambda g, c: calibrate_pk_debias(
        g, c, PipelineConfig()),
    "ColaEngine": lambda g, c: ColaEngine(g, c),
    "make_sharded_ensemble_step": lambda g, c: make_sharded_ensemble_step(
        None, g, c),
    "make_mesh": lambda g, c: make_mesh(),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_points_default_to_the_card(monkeypatch, inputs, entry):
    """No device means the CUDA card; without one they raise, naming the
    way to ask for the CPU, instead of running there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match='device="cpu"'):
        ENTRY_POINTS[entry](inputs["grid"], inputs["cosmo"])
