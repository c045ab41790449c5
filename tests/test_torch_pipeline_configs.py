"""The port's other pipeline configurations and entry points against
fastbox_tpu's, on the CPU, at 16^3 in float64.

Each configuration runs fastbox_tpu with ``threefry_noise=True`` and the
port on the same five draws and build-time constants (the harness of
tests/test_torch_pipeline.py): stages at 1e-9, spectra at 1e-8 per bin.
The anisotropic box keeps the 2:2:1 footprint-to-depth shape of the
(4000, 4000, 2000) Mpc configuration at a scale where 16 cells still
resolve the RSD shifts.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from fastbox_tpu.cosmology import build_cosmology as jax_build_cosmology
from fastbox_tpu.grid import GridSpec as JaxGrid
from fastbox_tpu.pipeline import PipelineConfig as JaxConfig
from fastbox_tpu.pipeline import _build_pipeline
from fastbox_tpu.pipeline import make_chained_pipeline as jax_chained
from fastbox_tpu.pipeline import make_pipeline as jax_make
from fastbox_tpu_torch.convert import from_jax_state
from fastbox_tpu_torch.cosmology import build_cosmology
from fastbox_tpu_torch.grid import GridSpec
from fastbox_tpu_torch.pipeline import (PipelineConfig, calibrate_pk_debias,
                                        make_chained_pipeline,
                                        make_ensemble_pipeline, make_pipeline)
from test_torch_pipeline import COSMO, STAGES, Z, jax_draws, jax_state, rel_err

N = 16
CUBE = 1e3
ANISO = (1e3, 1e3, 5e2)
SPECTRA = ("pk_cleaned", "pk_density", "sigma_data")
DEBIAS = tuple(np.linspace(-1e-3, 1e-3, 19))

# name -> (box, fastbox_tpu config, port config)
CONFIGS = {
    "aniso_k5": (ANISO, dict(pallas_pk="on"), dict()),
    "aniso_xla": (ANISO, dict(), dict(pallas_pk="off")),
    "cube_k5": (CUBE, dict(pallas_pk="on"), dict(pallas_pk="on")),
    "instrument": (CUBE, dict(beam_dish_m=13.5, kpar_min=0.05),
                   dict(beam_dish_m=13.5, kpar_min=0.05)),
    "subspace_pca": (CUBE, dict(pca_exact=False), dict(pca_exact=False)),
    "pk_debias": (CUBE, dict(pk_debias=DEBIAS), dict(pk_debias=DEBIAS)),
    "vz_weighting": (CUBE, dict(), dict(pallas_draw="vz")),
    "k9_supplied": (CUBE, dict(), dict(pallas_draw="on")),
}


def port_inputs(box, key, dtype="float64"):
    """(jax grid, jax cosmology, the port's grid, cosmology and amp_half,
    the draws as torch tensors) for one box and key."""
    jgrid = JaxGrid.create(box_scale=box, nsamp=N, redshift=Z)
    jcosmo = jax_build_cosmology(COSMO, redshift=Z)
    _, (amp, _) = _build_pipeline(jgrid, jcosmo, JaxConfig(dtype=dtype))
    cosmo, amp_t = from_jax_state(jax_state(jcosmo, amp))
    grid = GridSpec.create(box_scale=box, nsamp=N, redshift=Z)
    draws = {k: torch.tensor(v) for k, v in jax_draws(key, jgrid).items()}
    return jgrid, jcosmo, grid, cosmo, amp_t, draws


def numpy_out(out):
    return {k: v.numpy() for k, v in out.items()}


def bin_err(got, want):
    """Per-bin relative error, against a floor of 1e-12 of the largest
    bin: the k_par high-pass empties the first bin of the cleaned cube
    (T = 0 at kz = 0), leaving ~1e-23 of rounding there in both packages."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    ok = np.isfinite(want)
    assert np.array_equal(ok, np.isfinite(got))
    w = np.abs(want[ok])
    return np.abs(got[ok] - want[ok]) / np.maximum(w, 1e-12 * w.max())


@pytest.fixture(scope="module", params=list(CONFIGS))
def config_case(request):
    box, jkw, pkw = CONFIGS[request.param]
    key = jax.random.PRNGKey(77)
    jgrid, jcosmo, grid, cosmo, amp, draws = port_inputs(box, key)
    want = jax_make(jgrid, jcosmo, JaxConfig(
        dtype="float64", threefry_noise=True, debug_stages=True, **jkw))(key)
    fn = make_pipeline(grid, cosmo, PipelineConfig(
        dtype="float64", debug_stages=True, **pkw), device="cpu",
        amp_half=amp)
    return ({k: np.asarray(v) for k, v in want.items()},
            numpy_out(fn(draws=draws)))


@pytest.mark.parametrize("stage", STAGES)
def test_stage_matches_jax(config_case, stage):
    want, got = config_case
    assert got[stage].shape == want[stage].shape
    np.testing.assert_allclose(got[stage], want[stage], rtol=1e-9,
                               atol=1e-9 * np.abs(want[stage]).max())


@pytest.mark.parametrize("name", SPECTRA + ("pk_cleaned_err",))
def test_spectra_match_jax(config_case, name):
    want, got = config_case
    if name == "pk_cleaned_err":
        np.testing.assert_allclose(got[name], want[name], rtol=1e-7,
                                   atol=1e-12 * np.nanmax(want[name]),
                                   equal_nan=True)
        return
    err = bin_err(got[name], want[name])
    assert err.size and err.max() < 1e-8, err.max()


def test_anisotropic_f32_within_jax_f32_floor():
    """The port in f32 (K5's twin, float digitize in f32) against
    fastbox_tpu in f64, per populated bin, within 3x fastbox_tpu's own
    f32-vs-f64 error on the same realisation."""
    key = jax.random.PRNGKey(78)
    jgrid, jcosmo, grid, cosmo, amp, draws = port_inputs(ANISO, key)
    out64 = jax_make(jgrid, jcosmo, JaxConfig(
        dtype="float64", threefry_noise=True, pallas_pk="on"))(key)
    out32 = jax_make(jgrid, jcosmo, JaxConfig(
        dtype="float32", threefry_noise=True, draw_dtype="float64",
        pallas_pk="on"))(key)
    port32 = make_pipeline(grid, cosmo, PipelineConfig(dtype="float32"),
                           device="cpu", amp_half=amp)(draws=draws)
    for name in ("pk_cleaned", "pk_density"):
        floor = rel_err(out32[name], out64[name]).max()
        err = rel_err(port32[name], out64[name]).max()
        assert err <= 3.0 * floor, (name, err, floor)


@pytest.fixture(scope="module", params=["off", "on"])
def chain_case(request):
    """fastbox_tpu's chained pipeline over three keys and the port's on the
    same three realisations' draws."""
    keys = jax.random.split(jax.random.PRNGKey(21), 3)
    jgrid, jcosmo, grid, cosmo, amp, _ = port_inputs(CUBE, keys[0])
    want = jax_chained(jgrid, jcosmo, JaxConfig(
        dtype="float64", threefry_noise=True,
        eigh_hoist=request.param))(keys)
    draws = [{k: torch.tensor(v) for k, v in jax_draws(k_, jgrid).items()}
             for k_ in keys]
    cfg = PipelineConfig(dtype="float64", eigh_hoist=request.param)
    got = make_chained_pipeline(grid, cosmo, cfg, device="cpu",
                                amp_half=amp)(draws=draws)
    single = make_pipeline(grid, cosmo, cfg, device="cpu", amp_half=amp)
    return (request.param, {k: np.asarray(v) for k, v in want.items()},
            numpy_out(got), [numpy_out(single(draws=d)) for d in draws])


@pytest.mark.parametrize("name", SPECTRA)
def test_chained_matches_jax(chain_case, name):
    _, want, got, _ = chain_case
    assert got[name].shape == want[name].shape
    assert got[name].shape[0] == 3
    err = rel_err(got[name].reshape(-1), want[name].reshape(-1))
    assert err.size and err.max() < 1e-8, err.max()


def test_chained_equals_single_calls(chain_case):
    """The chain is the single pipeline, stacked: bitwise without the
    hoist; with the batched eigh the cleaned spectra agree to 5e-13, as
    fastbox_tpu holds its hoist (tests/test_pipeline_hoist.py), and the
    density spectrum, which takes no PCA, stays exact."""
    hoist, _, got, singles = chain_case
    for i, one in enumerate(singles):
        np.testing.assert_array_equal(got["pk_density"][i], one["pk_density"])
        np.testing.assert_array_equal(got["sigma_data"][i], one["sigma_data"])
        m = np.isfinite(one["pk_cleaned"])
        np.testing.assert_allclose(got["pk_cleaned"][i][m],
                                   one["pk_cleaned"][m],
                                   rtol=5e-13 if hoist == "on" else 0, atol=0)


@pytest.fixture(scope="module")
def cosmo_port():
    return build_cosmology(COSMO, redshift=Z)


@pytest.mark.parametrize("box", [CUBE, ANISO], ids=["cube", "aniso"])
def test_ensemble_equals_single_calls(cosmo_port, box):
    grid = GridSpec.create(box_scale=box, nsamp=N, redshift=Z)
    cfg = PipelineConfig(dtype="float64")
    ens = make_ensemble_pipeline(grid, cosmo_port, cfg, device="cpu")(
        generators=[torch.Generator().manual_seed(s) for s in (1, 2, 3)])
    single = make_pipeline(grid, cosmo_port, cfg, device="cpu")
    assert ens["pk_cleaned"].shape == (3, 19)
    for i, s in enumerate((1, 2, 3)):
        one = single(torch.Generator().manual_seed(s))
        for k, v in one.items():
            assert torch.equal(ens[k][i].nan_to_num(), v.nan_to_num()), k
    assert not torch.equal(ens["sigma_data"][0], ens["sigma_data"][1])


def test_ensemble_mesh_raises(cosmo_port):
    """A mesh must be a DeviceMesh with an 'ens' axis
    (tests/test_torch_parallel.py runs the real one)."""
    grid = GridSpec.create(box_scale=CUBE, nsamp=N, redshift=Z)
    with pytest.raises(TypeError, match="DeviceMesh"):
        make_ensemble_pipeline(grid, cosmo_port, device="cpu", mesh=object())


@pytest.mark.parametrize("draw", ["on", "vz"])
def test_pallas_draw_with_a_generator(cosmo_port, draw):
    """On the CPU K9's twin draws as the plain path does: 'on' reproduces
    'off' bit for bit; 'vz' has the same delta_k (pk_density exact) and
    only the velocity weight's rounding differs."""
    grid = GridSpec.create(box_scale=CUBE, nsamp=N, redshift=Z)
    run = lambda cfg: make_pipeline(grid, cosmo_port, cfg, device="cpu")(
        torch.Generator().manual_seed(12))
    a = run(PipelineConfig(dtype="float64", pallas_draw=draw))
    b = run(PipelineConfig(dtype="float64"))
    assert torch.equal(a["pk_density"].nan_to_num(),
                       b["pk_density"].nan_to_num())
    tol = 0 if draw == "on" else 1e-9
    torch.testing.assert_close(a["pk_cleaned"], b["pk_cleaned"], rtol=tol,
                               atol=0, equal_nan=True)


def test_box_muller_draw_method_runs(cosmo_port):
    grid = GridSpec.create(box_scale=CUBE, nsamp=N, redshift=Z)
    cfg = PipelineConfig(dtype="float64", draw_method="box_muller")
    fn = make_pipeline(grid, cosmo_port, cfg, device="cpu")
    a = fn(torch.Generator().manual_seed(3))
    b = make_pipeline(grid, cosmo_port, PipelineConfig(dtype="float64"),
                      device="cpu")(
        torch.Generator().manual_seed(3))
    assert torch.isfinite(a["pk_density"]).sum() >= 10
    assert not torch.equal(a["sigma_data"], b["sigma_data"])


def test_pk_debias_length_is_checked(cosmo_port):
    grid = GridSpec.create(box_scale=CUBE, nsamp=N, redshift=Z)
    with pytest.raises(ValueError, match="length 19"):
        make_pipeline(grid, cosmo_port, PipelineConfig(pk_debias=(0.0,)),
                      device="cpu")


def test_calibrate_pk_debias(cosmo_port):
    """The default reference differs only in pk_debias, so the calibration
    is zero; against a reference without noise it is the mean difference
    of the two pipelines on the keys of the given seeds."""
    grid = GridSpec.create(box_scale=CUBE, nsamp=N, redshift=Z)
    fast = PipelineConfig(dtype="float64", pk_debias=DEBIAS)
    zero = calibrate_pk_debias(grid, cosmo_port, fast, seeds=(1, 2),
                               device="cpu")
    assert len(zero) == 19
    np.testing.assert_array_equal(np.nan_to_num(zero), 0.0)
    ref = dataclasses.replace(fast, pk_debias=None, include_noise=False)
    got = calibrate_pk_debias(grid, cosmo_port, fast, ref, seeds=(1, 2),
                              device="cpu")
    f = make_pipeline(grid, cosmo_port, dataclasses.replace(fast,
                                                            pk_debias=None),
                      device="cpu")
    r = make_pipeline(grid, cosmo_port, ref, device="cpu")
    want = np.mean([(f(s)["pk_cleaned"] - r(s)["pk_cleaned"]).numpy()
                    for s in (1, 2)], axis=0)
    np.testing.assert_allclose(got, want, rtol=1e-12, equal_nan=True)
