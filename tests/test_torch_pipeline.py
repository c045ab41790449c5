"""The port's pipeline as a whole against fastbox_tpu's, on the CPU.

fastbox_tpu runs its default pipeline with ``threefry_noise=True`` (every
draw a platform-deterministic ``jax.random`` call); the test rebuilds those
five draws from the same key splits as ``fn_pre`` (fastbox_tpu/pipeline.py
:492, :517, :570, :595-600, :630) and hands them, with fastbox_tpu's
build-time constants (``convert.from_jax_state``), to the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastbox_tpu.cosmology import build_cosmology as jax_build_cosmology
from fastbox_tpu.fields.gaussian import hermitian_half_noise
from fastbox_tpu.grid import GridSpec as JaxGrid
from fastbox_tpu.pipeline import PipelineConfig as JaxConfig
from fastbox_tpu.pipeline import _build_pipeline, make_pipeline as jax_make
from fastbox_tpu_torch.convert import SCALARS, TABLES, from_jax_state
from fastbox_tpu_torch.cosmology import build_cosmology
from fastbox_tpu_torch.grid import GridSpec
from fastbox_tpu_torch.pipeline import (DRAW_NAMES, PipelineConfig,
                                        draw_inputs, make_pipeline)

COSMO = dict(Omega_c=0.25, Omega_b=0.05, h=0.7, n_s=0.95, sigma8=0.8)
Z = 0.8
BOX = 1e3
STAGES = ("delta_x", "vel_z", "delta_s", "fg_cube", "data", "cleaned")


def jax_state(cosmo, amp_half=None) -> dict:
    """fastbox_tpu's Cosmology (+ amp_half) as numpy arrays and floats."""
    state = {k: float(getattr(cosmo, k)) for k in SCALARS}
    for t in TABLES:
        state[f"{t}_lnk"] = np.asarray(getattr(cosmo, t).lnk)
        state[f"{t}_lnp"] = np.asarray(getattr(cosmo, t).lnp)
    if amp_half is not None:
        state["amp_half"] = np.asarray(amp_half)
    return state


def jax_draws(key, grid) -> dict:
    """The five f64 draws of fastbox_tpu's threefry pipeline path."""
    N = grid.N
    k_dens, k_rsd, k_fg, k_alpha, k_noise = jax.random.split(key, 5)
    kf1, kf2 = jax.random.split(k_fg)
    f64 = jnp.float64
    draws = {
        "dens": hermitian_half_noise(k_dens, grid, f64),
        "rsd": jax.random.normal(k_rsd, grid.shape, f64),
        "fg": (jax.random.normal(kf1, (N, N), f64)
               + 1j * jax.random.normal(kf2, (N, N), f64)),
        "alpha": jax.random.normal(k_alpha, (N, N), f64),
        "noise": jax.random.normal(k_noise, grid.shape, f64),
    }
    return {k: np.asarray(v) for k, v in draws.items()}


def rel_err(got, want):
    """Per-bin |got - want| / |want| over the populated (finite) bins."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    ok = np.isfinite(want)
    assert np.array_equal(ok, np.isfinite(got))
    return np.abs(got[ok] - want[ok]) / np.abs(want[ok])


@pytest.fixture(scope="module")
def case():
    """fastbox_tpu's f64 and f32 runs of one realisation at 16^3."""
    jgrid = JaxGrid.create(box_scale=BOX, nsamp=16, redshift=Z)
    jcosmo = jax_build_cosmology(COSMO, redshift=Z)
    cfg64 = JaxConfig(dtype="float64", threefry_noise=True, debug_stages=True)
    # draw_dtype='float64' makes the f32 run consume the f64 stream: the
    # same realisation, rounded to f32 after the draw
    cfg32 = JaxConfig(dtype="float32", threefry_noise=True,
                      draw_dtype="float64")
    key = jax.random.PRNGKey(1234)
    out64 = {k: np.asarray(v) for k, v in
             jax_make(jgrid, jcosmo, cfg64)(key).items()}
    out32 = {k: np.asarray(v) for k, v in
             jax_make(jgrid, jcosmo, cfg32)(key).items()}
    _, (amp64, _) = _build_pipeline(jgrid, jcosmo, cfg64)
    return dict(jgrid=jgrid, jcosmo=jcosmo, draws=jax_draws(key, jgrid),
                state=jax_state(jcosmo, amp64), out64=out64, out32=out32)


def run_port(case, dtype: str, debug: bool = True):
    cosmo, amp = from_jax_state(case["state"])
    grid = GridSpec.create(box_scale=BOX, nsamp=16, redshift=Z)
    fn = make_pipeline(grid, cosmo, PipelineConfig(dtype=dtype,
                                                   debug_stages=debug),
                       amp_half=amp)
    draws = {k: torch.tensor(v) for k, v in case["draws"].items()}
    return {k: v.numpy() for k, v in fn(draws=draws).items()}


@pytest.fixture(scope="module")
def port64(case):
    return run_port(case, "float64")


@pytest.mark.parametrize("stage", STAGES)
def test_stage_f64_matches_jax(case, port64, stage):
    want = case["out64"][stage]
    got = port64[stage]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-9,
                               atol=1e-9 * np.abs(want).max())


@pytest.mark.parametrize("name", ["pk_cleaned", "pk_density", "sigma_data"])
def test_spectra_f64_match_jax(case, port64, name):
    err = rel_err(port64[name], case["out64"][name])
    assert err.size and err.max() < 1e-8, err.max()


def test_k_and_errors_match_jax(case, port64):
    np.testing.assert_allclose(port64["k"], case["out64"]["k"], rtol=1e-12)
    np.testing.assert_allclose(port64["pk_cleaned_err"],
                               case["out64"]["pk_cleaned_err"], rtol=1e-7,
                               atol=0, equal_nan=True)


def test_f32_within_jax_f32_floor(case):
    """Port f32 vs fastbox_tpu f64, per populated bin, within 3x the
    fastbox_tpu-f32-vs-f64 error (the max over bins; conftest's x64 makes
    some fastbox_tpu host constants f64 in its f32 run, so this is a
    floor-class check, not a tight one)."""
    port32 = run_port(case, "float32", debug=False)
    for name in ("pk_cleaned", "pk_density"):
        floor = rel_err(case["out32"][name], case["out64"][name]).max()
        err = rel_err(port32[name], case["out64"][name]).max()
        assert err <= 3.0 * floor, (name, err, floor)
        assert port32[name].dtype == np.float32


def test_own_cosmology_and_generator_run(cosmo_port):
    """With its own tables and a torch.Generator: finite outputs, bins
    that agree with the injected-draw run's shapes, and a realisation that
    depends on the seed only."""
    grid = GridSpec.create(box_scale=BOX, nsamp=16, redshift=Z)
    fn = make_pipeline(grid, cosmo_port, PipelineConfig(dtype="float64"))
    a = fn(torch.Generator().manual_seed(5))
    b = fn(torch.Generator().manual_seed(5))
    c = fn(torch.Generator().manual_seed(6))
    assert a["pk_cleaned"].shape == (19,)
    assert torch.isfinite(a["sigma_data"])
    torch.testing.assert_close(a["pk_cleaned"], b["pk_cleaned"], rtol=0,
                               atol=0, equal_nan=True)
    assert not torch.equal(a["sigma_data"], c["sigma_data"])


def test_draw_inputs_reproduce_generator_run(cosmo_port):
    """Drawing the five arrays up front gives the pipeline's own draws on
    the CPU (same generator, same order)."""
    grid = GridSpec.create(box_scale=BOX, nsamp=16, redshift=Z)
    fn = make_pipeline(grid, cosmo_port, PipelineConfig(dtype="float64"))
    own = fn(torch.Generator().manual_seed(9))
    draws = draw_inputs(grid, torch.Generator().manual_seed(9),
                        torch.float64)
    assert set(draws) == set(DRAW_NAMES)
    sup = fn(draws=draws)
    for k in ("pk_cleaned", "pk_density", "sigma_data"):
        torch.testing.assert_close(sup[k], own[k], rtol=0, atol=0,
                                   equal_nan=True)


@pytest.fixture(scope="module")
def cosmo_port():
    return build_cosmology(COSMO, redshift=Z)


@pytest.mark.parametrize("knob, value", [
    ("noise_scheme", "rows"), ("pallas_draw", "on"), ("fft_pair", True),
    ("eigh_hoist", "on"), ("pca_exact", False), ("draw_method", "box_muller"),
    ("pk_debias", (0.0,)), ("beam_dish_m", 6.0), ("kpar_min", 0.01),
    ("pallas_pk", "v2t"), ("pallas_pk", "on"), ("pallas_pk", "off"),
    ("threefry_noise", True), ("draw_dtype", "float32"),
    ("rsd_method", "nearest"),
])
def test_unported_knobs_raise(knob, value):
    with pytest.raises(NotImplementedError):
        PipelineConfig(**{knob: value})


def test_precision_knobs_accepted_and_non_cubic_raises(cosmo_port):
    PipelineConfig(mm3d_precision="DEFAULT", vel_precision="HIGHEST",
                   dx_precision="HIGH", fwd_precision="HIGH",
                   pca_precision=None)
    grid = GridSpec.create(box_scale=(1e3, 1e3, 2e3), nsamp=16, redshift=Z)
    with pytest.raises(NotImplementedError):
        make_pipeline(grid, cosmo_port)


def test_stage_clock_marks_every_stage(cosmo_port):
    from fastbox_tpu_torch.timing import StageClock

    grid = GridSpec.create(box_scale=BOX, nsamp=16, redshift=Z)
    fn = make_pipeline(grid, cosmo_port, PipelineConfig(dtype="float64"))
    clock = StageClock("cpu")
    fn(torch.Generator().manual_seed(1), clock=clock)
    ms = clock.ms()
    assert list(ms) == ["draw", "velocity_irfft", "lognormal", "rsd",
                        "foregrounds", "noise", "pca", "pk"]
    assert all(v >= 0.0 for v in ms.values())
