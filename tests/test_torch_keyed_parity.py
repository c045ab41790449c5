"""The port's single-device paths from a seed against fastbox_tpu's from
``jax.random.PRNGKey(seed)``, on the CPU, with no draws injected.

A key gives the port fastbox_tpu's own realisation: the same splits, and
whole-array draws within the libraries' erfinv (log, cos, sin)
(tests/test_torch_keyed_draws.py): float64 normals within 2**14 spacings
(~3.6e-12 of the value), float32 ones within 128 (~1.5e-5), uniforms and
Knuth Poisson counts equal.  Tolerances, derived from those:

* float64 fields: 1e-9 of their largest value (a 16^3 field sums 4096
  draws each ~3.6e-12 off);
* float64 pipelines: fastbox_tpu's parity tolerances (pk rtol 1e-7,
  sigma_data 1e-9; tests/test_torch_parallel.py);
* float32 draws (``draw_dtype='float32'`` on float64, and float32
  pipelines): the realisation moves by the f32 draws' ~1e-7 typical and
  1.5e-5 worst difference; pk_density within 3e-5 (twice the worst, P is
  quadratic), the f64 clean's pk_cleaned within 1e-4 (measured 3e-6);
  a float32 pipeline's pk_cleaned within 3x fastbox_tpu's own f32-vs-f64
  error on the key (its conditioning floor, as
  tests/test_torch_pipeline.py holds the injected-draw f32 run);
* Poisson counts at Knuth rates: equal.

The first test shows the fault this closes: before the port read keys, a
seeded ``CosmoBox`` drew torch's stream, another realisation.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastbox_tpu.analysis import inpaint as jinpaint
from fastbox_tpu.box import CosmoBox as JaxBox
from fastbox_tpu.fields import gaussian as jgauss
from fastbox_tpu.filters import ica as jica
from fastbox_tpu.models import foregrounds as jfg
from fastbox_tpu.models import halos as jhalos
from fastbox_tpu.models import noise as jnoise
from fastbox_tpu.pipeline import PipelineConfig as JaxConfig
from fastbox_tpu.pipeline import make_ensemble_pipeline as jax_ensemble
from fastbox_tpu.pipeline import make_pipeline as jax_make
from fastbox_tpu_torch import keys
from fastbox_tpu_torch.analysis import inpaint
from fastbox_tpu_torch.box import CosmoBox, default_cosmo
from fastbox_tpu_torch.fields.cola import realise_density_cola
from fastbox_tpu_torch.filters import gpr, ica
from fastbox_tpu_torch.models import foregrounds, halos, noise
from fastbox_tpu_torch.pipeline import (PipelineConfig, make_chained_pipeline,
                                        make_ensemble_pipeline, make_pipeline)
from test_torch_parallel import assert_outputs_close
from test_torch_pipeline import rel_err
from test_torch_pipeline_configs import CUBE, port_inputs

SEEDS = (7, 2 ** 32 + 5)
FIELD_RTOL = 1e-9
F32_DRAW_PK_DENSITY, F32_DRAW_PK_CLEANED = 3e-5, 1e-4
# name -> PipelineConfig fields of each keyed configuration (both packages)
CONFIGS = {
    "default": dict(dtype="float64"),
    "gate": dict(dtype="float64", threefry_noise=True, draw_dtype="float32"),
    "threefry_noise": dict(dtype="float64", threefry_noise=True),
    "draw_dtype": dict(dtype="float64", draw_dtype="float32"),
    "f32": dict(dtype="float32"),
}


def close(got, want, rtol=FIELD_RTOL):
    """Within rtol of the largest |value| (fields cross zero)."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.nanmax(np.abs(want)))


def boxes(seed, n=16, z=0.8):
    kw = dict(cosmo=default_cosmo, box_scale=1e3, nsamp=n, redshift=z,
              realise_now=False, seed=seed)
    return JaxBox(**kw), CosmoBox(dtype=torch.float64, device="cpu", **kw)


@pytest.mark.parametrize("seed", SEEDS)
def test_seeded_box_density_is_fastbox_tpus(seed):
    """``CosmoBox(seed=s)``'s realisation is fastbox_tpu's for the seed,
    and so are the next ones: the key chain advances alike."""
    jb, tb = boxes(seed)
    for linear in (False, True, False):
        close(tb.realise_density(linear=linear), jb.realise_density(
            linear=linear))
    tb.set_seed(seed)
    jb.set_seed(seed)
    close(tb.realise_density(), jb.realise_density())
    for a, b in zip(tb.realise_velocity(), jb.realise_velocity()):
        close(a, b)
    close(tb.realise_potential(), jb.realise_potential())
    np.testing.assert_array_equal(tb.next_key().numpy(),
                                  np.asarray(jb.next_key(), np.int64))


def test_realise_now_box_matches():
    kw = dict(cosmo=default_cosmo, box_scale=1e3, nsamp=16, redshift=0.8,
              seed=2 ** 32 + 5)
    jb, tb = JaxBox(**kw), CosmoBox(dtype=torch.float64, device="cpu", **kw)
    close(tb.delta_x, jb.delta_x)
    close(tb.phi_k, jb.phi_k)


@pytest.mark.parametrize("seed", SEEDS)
def test_box_rsd_noise_and_foregrounds(seed):
    """The box's sigma_NL draw, its radiometer noise, the foreground
    amplitude and spectral-index maps and the point sources (seeded and
    from the box), in fastbox_tpu's order of keys."""
    jb, tb = boxes(seed)
    jb.realise_density()
    tb.realise_density()
    v = np.asarray(jnp.fft.ifftn(jb.realise_velocity()[2]).real)
    close(tb.redshift_space_density(delta_x=tb.delta_x, velocity_z=v,
                                    sigma_nl=300.0),
          jb.redshift_space_density(delta_x=jb.delta_x, velocity_z=v,
                                    sigma_nl=300.0), 1e-8)
    close(noise.NoiseModel(tb).realise_radiometer_noise(18.0, 2.0, 1.0, 64),
          jnoise.NoiseModel(jb).realise_radiometer_noise(18.0, 2.0, 1.0, 64))
    tf, jf = foregrounds.ForegroundModel(tb), jfg.ForegroundModel(jb)
    close(tf.realise_foreground_amp(57.0, 1.1, 10.0, 4.0),
          jf.realise_foreground_amp(57.0, 1.1, 10.0, 4.0))
    close(tf.realise_spectral_index(2.07, 0.1, 15.0),
          jf.realise_spectral_index(2.07, 0.1, 15.0))
    tp, jp = foregrounds.PointSourceModel(tb), jfg.PointSourceModel(jb)
    # without seed_poisson both packages seed the bright-source shot map
    # afresh (np.random.default_rng(None)): a cutoff of 0.01 Jy has none
    for cut, kw in ((0.1, dict(seed_clustering=1, seed_poisson=2)),
                    (0.01, {})):
        got, tmean = tp.construct_cube(cut, -2.7, 0.1, **kw)
        want, jmean = jp.construct_cube(cut, -2.7, 0.1, **kw)
        close(got, want)
        np.testing.assert_allclose(tmean, np.asarray(jmean), rtol=1e-12)


@pytest.mark.parametrize("lognormal", [False, True])
def test_box_halo_counts_and_catalogues(lognormal):
    """Knuth rates (a mean of ~1.5 a voxel, none from 10): the counts equal
    fastbox_tpu's; the catalogues from the box's randint seed and from
    the padded uniforms too."""
    jb, tb = boxes(31)
    delta = 0.3 * np.random.default_rng(4).standard_normal((16, 16, 16))
    th, jh = (halos.HaloDistribution(tb, (1e12, 1e15), 4),
              jhalos.HaloDistribution(jb, (1e12, 1e15), 4))
    delta_t = torch.as_tensor(delta)
    assert float(halos.halo_rate(delta_t, tb.grid, 6e-6, 1.5,
                                 lognormal).max()) < 10.0
    got = th.halo_count_field(delta_t, 6e-6, 1.5, lognormal)
    want = np.asarray(jh.halo_count_field(delta, 6e-6, 1.5, lognormal))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(
        th.realise_halo_catalogue(got, scatter=True),
        jh.realise_halo_catalogue(want, scatter=True), rtol=1e-15)
    for a, b in zip(halos.realise_halo_catalogue_padded(
            5, got, tb.grid, 8192, scatter=True),
            jhalos.realise_halo_catalogue_padded(
            jax.random.PRNGKey(5), jnp.asarray(want), jb.grid, 8192,
            scatter=True)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-15)


def test_box_cola_draws_fastbox_tpus_white_noise():
    """``realise_density_cola(seed=4)`` through the box runs the engine on
    fastbox_tpu's ``white_noise(PRNGKey(4))`` (the engine itself is held
    to fastbox_tpu's on one white noise in tests/test_torch_box.py), and
    without a seed on the box's next key."""
    jb, tb = boxes(11)
    kw = dict(redshift_init=5.0, n_steps=2, keep_velocities=False)
    got = tb.realise_density_cola(seed=4, **kw)
    w = torch.as_tensor(np.asarray(jgauss.white_noise(
        jax.random.PRNGKey(4), jb.grid, jnp.float64)))
    want = realise_density_cola(None, tb.grid, tb.cosmology, white=w,
                                dtype=torch.float64, **kw)[0]
    close(got, want)
    jkey = jb.next_key()
    got = tb.realise_density_cola(**kw)
    w = torch.as_tensor(np.asarray(jgauss.white_noise(jkey, jb.grid,
                                                      jnp.float64)))
    close(got, realise_density_cola(None, tb.grid, tb.cosmology, white=w,
                                    dtype=torch.float64, **kw)[0])


@pytest.fixture(scope="module")
def jax_runs():
    """fastbox_tpu's pipeline in each of CONFIGS on the seeds' keys, its
    ensemble over them, and the port's inputs built from its state."""
    jgrid, jcosmo, grid, cosmo, amp, _ = port_inputs(CUBE,
                                                     jax.random.PRNGKey(0))
    out = {}
    for name, kw in CONFIGS.items():
        fn = jax_make(jgrid, jcosmo, JaxConfig(**kw))
        out[name] = [{k: np.asarray(v) for k, v in
                      fn(jax.random.PRNGKey(s)).items()} for s in SEEDS]
    ks = jnp.stack([jax.random.PRNGKey(s) for s in SEEDS])
    out["ensemble"] = {k: np.asarray(v) for k, v in jax_ensemble(
        jgrid, jcosmo, JaxConfig(**CONFIGS["default"]))(ks).items()}
    return dict(grid=grid, cosmo=cosmo, amp=amp, out=out)


def port_fn(runs, **kw):
    return make_pipeline(runs["grid"], runs["cosmo"], PipelineConfig(**kw),
                         device="cpu", amp_half=runs["amp"])


def test_keyed_pipeline_f64(jax_runs):
    fn = port_fn(jax_runs, **CONFIGS["default"])
    for seed, want in zip(SEEDS, jax_runs["out"]["default"]):
        assert_outputs_close(fn(seed), want)
        assert_outputs_close(fn.post(fn.pre(seed)), want)


@pytest.mark.parametrize("name", ["gate", "draw_dtype"])
def test_keyed_pipeline_gate_knobs(jax_runs, name):
    """float32 draws in the float64 pipeline: with ``threefry_noise`` all
    five arrays (the truth gate's configuration), without it the density,
    foreground and alpha draws only, the two normal fields being
    ``add_scaled_normal``'s float64 draws."""
    fn = port_fn(jax_runs, **CONFIGS[name])
    for seed, want in zip(SEEDS, jax_runs["out"][name]):
        got = {k: v.numpy() for k, v in fn(seed).items()}
        assert rel_err(got["pk_density"], want["pk_density"]).max() \
            <= F32_DRAW_PK_DENSITY
        assert rel_err(got["pk_cleaned"], want["pk_cleaned"]).max() \
            <= F32_DRAW_PK_CLEANED
        np.testing.assert_allclose(got["sigma_data"], want["sigma_data"],
                                   rtol=F32_DRAW_PK_DENSITY)


def test_keyed_pipeline_threefry_noise(jax_runs):
    """``threefry_noise`` alone: the two normal fields drawn whole in
    float64 and added, fastbox_tpu's float64 parity tolerances."""
    fn = port_fn(jax_runs, **CONFIGS["threefry_noise"])
    for seed, want in zip(SEEDS, jax_runs["out"]["threefry_noise"]):
        assert_outputs_close(fn(seed), want)


@pytest.mark.parametrize("pallas_draw", ["off", "on", "vz"])
def test_keyed_pipeline_f32(jax_runs, pallas_draw):
    """float32, with K9 colouring the key's white noise in its supplied
    mode where ``pallas_draw`` is on (fastbox_tpu ignores the knob off the
    TPU): against fastbox_tpu's float32 run and, for pk_cleaned, within 3x
    its own float32 error against the float64 gate run of the key."""
    fn = port_fn(jax_runs, pallas_draw=pallas_draw, **CONFIGS["f32"])
    for i, seed in enumerate(SEEDS):
        got = {k: v.numpy() for k, v in fn(seed).items()}
        want = jax_runs["out"]["f32"][i]
        oracle = jax_runs["out"]["gate"][i]
        assert got["pk_cleaned"].dtype == np.float32
        assert rel_err(got["pk_density"], want["pk_density"]).max() \
            <= F32_DRAW_PK_DENSITY
        np.testing.assert_allclose(got["sigma_data"], want["sigma_data"],
                                   rtol=F32_DRAW_PK_DENSITY)
        floor = rel_err(want["pk_cleaned"], oracle["pk_cleaned"]).max()
        err = rel_err(got["pk_cleaned"], oracle["pk_cleaned"]).max()
        assert err <= 3.0 * floor, (seed, err, floor)


def test_keyed_chain_and_ensemble(jax_runs):
    """A list of seeds through the chain (with the hoisted eigh) against
    fastbox_tpu's single calls stacked, which its scan reproduces
    (tests/test_pipeline.py::test_chained_pipeline_matches_single), and a
    (K, 2) key tensor through the ensemble against its vmap."""
    grid, cosmo, amp = jax_runs["grid"], jax_runs["cosmo"], jax_runs["amp"]
    want = {k: np.stack([o[k] for o in jax_runs["out"]["default"]])
            for k in jax_runs["out"]["default"][0]}
    chain = make_chained_pipeline(grid, cosmo, PipelineConfig(
        dtype="float64", eigh_hoist="on"), "cpu", amp)
    assert_outputs_close(chain(list(SEEDS)), want)
    ens = make_ensemble_pipeline(grid, cosmo, PipelineConfig(
        dtype="float64"), device="cpu", amp_half=amp)
    got = ens(torch.stack([keys.PRNGKey(s) for s in SEEDS]))
    assert got["pk_cleaned"].shape[0] == len(SEEDS)
    assert_outputs_close(got, jax_runs["out"]["ensemble"])


@pytest.mark.parametrize("name", ["gate", "threefry_noise", "draw_dtype"])
def test_gate_knobs_need_a_key(jax_runs, name):
    """The gate knobs select fastbox_tpu's threefry draws, which a
    torch.Generator cannot give: with one they raise."""
    fn = port_fn(jax_runs, **CONFIGS[name])
    with pytest.raises(ValueError, match="pass a key"):
        fn(torch.Generator().manual_seed(3))


def test_ica_default_key_is_fastbox_tpus(rng):
    """``ica_filter``'s default key is PRNGKey(0): fastbox_tpu's FastICA
    from the same start, the unmixing within float64 rounding."""
    cube = rng.standard_normal((12, 12, 16)) + np.linspace(0, 5, 16)
    want, (wk_j, _, _) = jica.ica_filter(jnp.asarray(cube), 3,
                                         return_filter=True)
    got, (wk, _, _) = ica.ica_filter(torch.as_tensor(cube), 3,
                                     return_filter=True)
    close(got, want)
    close(wk, wk_j, 1e-6)


def test_gpr_default_key_draws_fastbox_tpus_starts(rng):
    """``gpr_filter`` with restarts on its default key starts from
    fastbox_tpu's ``uniform(PRNGKey(0), ..., -3, 3)`` in the field's dtype:
    the same fit as those starts supplied (fastbox_tpu's own fit from
    given starts is held in tests/test_torch_filters.py)."""
    for dtype in (torch.float64, torch.float32):
        cube = torch.as_tensor(rng.standard_normal((6, 6, 12)), dtype=dtype)
        starts = np.asarray(jax.random.uniform(
            jax.random.PRNGKey(0), (2, 5),
            jnp.float64 if dtype == torch.float64 else jnp.float32,
            -3.0, 3.0))
        a = gpr.gpr_filter(cube, opt_num_restarts=2, nsteps=20)
        b = gpr.gpr_filter(cube, opt_num_restarts=2, nsteps=20,
                           starts=torch.as_tensor(starts).double())
        assert torch.equal(a, b)


def test_gaussian_cr_1d_default_key_is_fastbox_tpus(rng):
    nfreq, npix = 24, 3
    freqs = np.linspace(100.0, 124.0, nfreq)
    S = np.exp(-0.5 * ((freqs[:, None] - freqs[None, :]) / 6.0) ** 2) \
        + 1e-6 * np.eye(nfreq)
    N = 1e-3 * np.eye(nfreq)
    d = rng.standard_normal((npix, nfreq))
    w = np.ones((npix, nfreq))
    w[:, 8:12] = 0.0
    for key in (None, 5):
        got = inpaint.gaussian_cr_1d(d, w, S, N, realisations=3,
                                     generator=key, device="cpu")
        want = jinpaint.gaussian_cr_1d(
            d, w, S, N, realisations=3,
            key=None if key is None else jax.random.PRNGKey(key))
        close(got, want, 1e-7)


def test_keyed_rsd_and_noise_functions():
    """``add_scaled_normal(x, scale, key)`` draws jax.random.normal(key,
    x.shape, x.dtype) and adds it through K1's supplied mode."""
    from fastbox_tpu.ops.rsd import add_scaled_normal as jax_asn
    from fastbox_tpu_torch.ops.rsd import add_scaled_normal

    x = np.random.default_rng(2).standard_normal((8, 16, 16)) * 300.0
    scale = np.linspace(50.0, 150.0, 16)
    for seed in SEEDS:
        want, wmax = jax_asn(jnp.asarray(x), jnp.asarray(scale),
                             jax.random.PRNGKey(seed), return_max=True)
        got, gmax = add_scaled_normal(torch.as_tensor(x),
                                      torch.as_tensor(scale), seed,
                                      return_max=True)
        close(got, want)
        np.testing.assert_allclose(float(gmax), float(wmax), rtol=1e-9)
    # the gate knobs are ported; fft_pair is not
    PipelineConfig(threefry_noise=True, draw_dtype="float32")
    with pytest.raises(NotImplementedError):
        PipelineConfig(fft_pair=True)
