"""The port's instrument and sky models (``models/{noise,tracers,halos,
beams}.py``) against fastbox_tpu's, in float64 on the CPU.

Mirrors tests/test_models.py:28-255 (the foreground classes are not ported
yet).  The deterministic parts agree with fastbox_tpu to rtol 1e-10: the
radiometer sigma, the noise on supplied normals, the tracer fits, the halo
rates (fastbox_tpu's Poisson draw stood in by its mean), the host and
padded catalogues on identical counts (exactly), the mass-function bins,
the beam cubes, both convolutions and the Zernike sums; the port's own
draws keep the reference's statistics; ``KatBeamModel`` raises ImportError
without ``katbeam``, in both packages.
"""
import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from fastbox_tpu.box import CosmoBox as JaxBox
from fastbox_tpu.models import beams as jbeams
from fastbox_tpu.models import halos as jhalos
from fastbox_tpu.models import noise as jnoise
from fastbox_tpu.models import tracers as jtracers
from fastbox_tpu_torch.box import CosmoBox, default_cosmo
from fastbox_tpu_torch.models import beams, halos, noise, tracers

RTOL = 1e-10


def boxes(n=16, z=0.8, seed=3, box=1e3):
    """(fastbox_tpu's box, the port's box) of one geometry, float64."""
    kw = dict(cosmo=default_cosmo, box_scale=(box,) * 3, nsamp=n, redshift=z,
              realise_now=False, seed=seed)
    return JaxBox(**kw), CosmoBox(dtype=torch.float64, device="cpu", **kw)


def close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def delta(n=16, seed=3, scale=0.7):
    return np.random.default_rng(seed).standard_normal((n, n, n)) * scale


# ----------------------------------------------------------------------
# Noise
# ----------------------------------------------------------------------
def test_radiometer_sigma_matches_fastbox_tpu():
    jb, tb = boxes()
    np.testing.assert_array_equal(tb.freq_array(), jb.freq_array())
    ang_x, _ = tb.pixel_array()
    args = (18.0, 2.0, 1.0, 64)
    np.testing.assert_array_equal(
        noise.radiometer_sigma(tb.freq_array(), ang_x, *args),
        jnoise.radiometer_sigma(jb.freq_array(), jb.pixel_array()[0], *args))


def test_noise_on_supplied_normals_matches_fastbox_tpu():
    jb, tb = boxes()
    key = jax.random.PRNGKey(4)
    freqs = jb.freq_array()
    sigma = jnoise.radiometer_sigma(freqs, jb.pixel_array()[0], 18.0, 2.0,
                                    1.0, 64)
    want = np.asarray(jnoise.realise_radiometer_noise(key, jb.grid, sigma,
                                                      dtype=jnp.float64))
    normals = torch.as_tensor(np.array(
        jax.random.normal(key, jb.grid.shape, jnp.float64)))
    got = noise.realise_radiometer_noise(None, tb.grid, sigma, torch.float64,
                                         "cpu", normals=normals)
    close(got, want)
    close(noise.NoiseModel(tb).realise_radiometer_noise(
        18.0, 2.0, 1.0, 64, normals=normals), want)


def test_noise_model_shape_and_scaling():
    _, tb = boxes()
    out = noise.NoiseModel(tb).realise_radiometer_noise(18.0, 2.0, 1.0, 64)
    assert out.shape == (16, 16, 16) and out.dtype == torch.float64
    sigma = noise.radiometer_sigma(tb.freq_array(), tb.pixel_array()[0],
                                   18.0, 2.0, 1.0, 64)
    ratio = out.numpy().std(axis=(0, 1)) / sigma
    assert np.all(ratio > 0.6) and np.all(ratio < 1.5)


# ----------------------------------------------------------------------
# Tracers
# ----------------------------------------------------------------------
@pytest.mark.parametrize("z", (0.8, 2.1))
def test_tracers_match_fastbox_tpu(z):
    jb, tb = boxes(z=z)
    t, j = tracers.TracerModel(tb), jtracers.TracerModel(jb)
    assert t.signal_amplitude(2.5, z) == j.signal_amplitude(2.5, z)
    assert t.linear_bias(1.3, z) == j.linear_bias(1.3, z)
    hi_t = tracers.HITracer(tb, OmegaHI0=4e-4)
    hi_j = jtracers.HITracer(jb, OmegaHI0=4e-4)
    assert hi_t.signal_amplitude() == hi_j.signal_amplitude()
    close(hi_t.signal_amplitude(formula="hall"),
          hi_j.signal_amplitude(formula="hall"))
    assert hi_t.bias_HI() == hi_j.bias_HI()
    assert hi_t.Omega_HI(redshift=0.3) == hi_j.Omega_HI(redshift=0.3)
    assert 0.01 < hi_t.signal_amplitude(formula="hall") < 10.0
    with pytest.raises(ValueError, match="No formula"):
        hi_t.signal_amplitude(formula="nope")


# ----------------------------------------------------------------------
# Halos
# ----------------------------------------------------------------------
@pytest.mark.parametrize("lognormal", (False, True))
@pytest.mark.parametrize("per_channel", (False, True))
def test_halo_rates_match_fastbox_tpu(monkeypatch, lognormal, per_channel):
    """fastbox_tpu's count field with its Poisson draw replaced by its mean
    (the rate), run unjitted: the clip only without lognormal, NaNs
    zeroed."""
    jb, tb = boxes(z=0.0)
    d = delta()
    d[3, 4, 5] = np.nan
    nbar, bias = 1e-3, 1.6
    if per_channel:
        nbar = np.linspace(5e-4, 2e-3, 16)
        bias = np.linspace(1.0, 2.0, 16)
    monkeypatch.setattr(jax.random, "poisson", lambda key, lam: lam)
    want = jhalos.halo_count_field.__wrapped__(
        jax.random.PRNGKey(0), jnp.asarray(d), jb.grid, nbar, bias,
        lognormal)
    got = halos.halo_rate(torch.as_tensor(d), tb.grid, nbar, bias, lognormal)
    close(got, want)
    assert bool(torch.all(got >= 0)) or lognormal


@pytest.mark.parametrize("lognormal", (False, True))
def test_halo_count_field_statistics(lognormal):
    _, tb = boxes(z=0.0, seed=5)
    tb.realise_density()
    h = halos.HaloDistribution(tb, mass_range=(1e12, 1e15), mass_bins=10)
    counts = h.halo_count_field(tb.delta_x, nbar=1e-3, bias=1.0,
                                lognormal=lognormal)
    assert counts.shape == (16, 16, 16) and counts.dtype == torch.int64
    assert int(counts.min()) >= 0
    vox = tb.grid.voxel_volume
    assert np.isclose(counts.double().mean().item(), vox * 1e-3, rtol=0.2)


def test_construct_bins_matches_fastbox_tpu():
    jb, tb = boxes(z=0.5)
    want = jhalos.HaloDistribution(jb, (1e12, 1e15), 10).construct_bins(0.5)
    got = halos.HaloDistribution(tb, (1e12, 1e15), 10).construct_bins(0.5)
    for g, w in zip(got, want):
        close(g, w)


def counts_cube(n=16):
    counts = np.zeros((n, n, n), dtype=np.int64)
    counts[1, 2, 3] = 2
    counts[5, 5, 5] = 1
    counts[7, 0, 15] = 11      # beyond max_count = 8: the excess is dropped
    counts[15, 15, 15] = 3
    return counts


@pytest.mark.parametrize("scatter", (False, True))
def test_halo_catalogue_host_matches_fastbox_tpu(scatter):
    jb, tb = boxes(z=0.0)
    c = counts_cube()
    want = jhalos.halo_catalogue_host(c, jb.grid,
                                      rng=np.random.default_rng(8),
                                      scatter=scatter)
    got = halos.halo_catalogue_host(torch.as_tensor(c), tb.grid,
                                    rng=np.random.default_rng(8),
                                    scatter=scatter)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (17, 3)


@pytest.mark.parametrize("max_halos", (8, 12, 40))
@pytest.mark.parametrize("scatter", (False, True))
def test_halo_catalogue_padded_matches_fastbox_tpu(max_halos, scatter):
    """Identical counts, identical catalogues: the overflowing
    voxel keeps 8 halos, slots past max_halos drop, n_valid counts all."""
    jb, tb = boxes(z=0.0)
    c = counts_cube()
    key = jax.random.PRNGKey(6)
    pos_j, mask_j, n_j = jhalos.realise_halo_catalogue_padded(
        key, jnp.asarray(c, jnp.int32), jb.grid, max_halos, scatter=scatter)
    u = torch.as_tensor(np.array(jax.random.uniform(
        key, (max_halos, 3), minval=0.0, maxval=1.0 - 1e-8)))
    pos, mask, n = halos.realise_halo_catalogue_padded(
        None, torch.as_tensor(c), tb.grid, max_halos, scatter=scatter,
        uniforms=u)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(pos_j))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_j))
    assert int(n) == int(n_j) == 17


def test_halo_catalogue_from_the_box_generator():
    _, tb = boxes(z=0.0)
    h = halos.HaloDistribution(tb, (1e12, 1e15), 10)
    cat = h.realise_halo_catalogue(counts_cube(), scatter=True)
    assert cat.shape == (17, 3)
    dx = tb.grid.Lx / 16
    cells = {tuple(r) for r in np.floor(cat / dx).astype(int)}
    assert cells == {(1, 2, 3), (5, 5, 5), (7, 0, 15), (15, 15, 15)}
    with pytest.raises(ValueError, match="scatter_type"):
        h.realise_halo_catalogue(counts_cube(), scatter_type="gauss")
    pos, mask, n = halos.realise_halo_catalogue_padded(
        torch.Generator().manual_seed(1), torch.as_tensor(counts_cube()),
        tb.grid, 20, scatter=True)
    # 11 of the first three voxels' 14 slots (8 of 11 overflow halos),
    # then the last voxel's 3
    assert int(mask.sum()) == 14 and int(n) == 17
    assert bool(torch.all(pos[~mask] == 0))


# ----------------------------------------------------------------------
# Beams
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape", ((8, 8, 4), (8, 6, 3)))
def test_convolve_fft_matches_fastbox_tpu_and_scipy(rng, shape):
    beam = rng.random(shape)
    field = rng.standard_normal(shape)
    got = beams.convolve_fft_cube(torch.as_tensor(beam),
                                  torch.as_tensor(field)).numpy()
    close(got, jbeams.convolve_fft_cube(jnp.asarray(beam),
                                        jnp.asarray(field)), atol=1e-12)
    want = scipy.signal.fftconvolve(beam, field, mode="same", axes=[0, 1])
    want = want / beam.reshape(-1, shape[-1]).sum(axis=0)[None, None, :]
    assert np.allclose(got, want, atol=1e-10)


@pytest.mark.parametrize("shape", ((8, 8, 2), (7, 9, 2)))
def test_convolve_wrap_matches_fastbox_tpu_and_scipy(rng, shape):
    beam = rng.random(shape)
    field = rng.standard_normal(shape)
    got = beams.convolve_wrap_cube(torch.as_tensor(beam),
                                   torch.as_tensor(field)).numpy()
    close(got, jbeams.convolve_wrap_cube(jnp.asarray(beam),
                                         jnp.asarray(field)), atol=1e-12)
    want = np.stack([scipy.signal.convolve2d(beam[:, :, i], field[:, :, i],
                                             mode="same", boundary="wrap")
                     for i in range(shape[-1])], axis=-1)
    want = want / beam.reshape(-1, shape[-1]).sum(axis=0)[None, None, :]
    assert np.allclose(got, want, atol=1e-10)


def test_unit_beam_convolution_identity():
    _, tb = boxes()
    bm = beams.BeamModel(tb)
    out = bm.convolve_real(torch.ones((16, 16, 16), dtype=torch.float64))
    assert np.allclose(out.numpy(), 1.0, atol=1e-8)
    x = np.zeros(3)
    assert np.array_equal(bm.beam_value(x, x, x), np.ones(3))
    with pytest.raises(ValueError, match="same shape"):
        bm.beam_value(x, x, np.zeros(2))


def beam_pair(name, tb, jb):
    if name == "gaussian":
        return (beams.GaussianBeamModel(tb, dish_diameter=13.5),
                jbeams.GaussianBeamModel(jb, dish_diameter=13.5))
    if name == "cosine":
        return (beams.CosineBeamModel(tb, dish_diameter=13.5),
                jbeams.CosineBeamModel(jb, dish_diameter=13.5))
    coeffs = [1.0, 0.0, 0.3, -0.2, 0.1, 0.05]
    return (beams.ZernikeBeamModel(tb, coeffs),
            jbeams.ZernikeBeamModel(jb, coeffs))


@pytest.mark.parametrize("name", ("gaussian", "cosine", "zernike"))
def test_beam_models_match_fastbox_tpu(name):
    jb, tb = boxes()
    bt, bj = beam_pair(name, tb, jb)
    cube = bt.beam_cube()
    close(cube, bj.beam_cube(), atol=1e-14)
    field = delta(seed=9)
    close(bt.convolve_fft(torch.as_tensor(field)),
          bj.convolve_fft(jnp.asarray(field)), atol=1e-12)
    close(bt.convolve_real(torch.as_tensor(field)),
          bj.convolve_real(jnp.asarray(field)), atol=1e-12)
    if name == "gaussian":
        c = cube.numpy()
        assert np.all(c > 0) and np.all(c <= 1.0 + 1e-12)
        assert c[:, :, 8].max() == c[7:9, 7:9, 8].max()
    if name == "cosine":
        assert np.all(np.isfinite(cube.numpy()))
        assert cube.max() <= 1.0 + 1e-9


def test_zernike_matches_fastbox_tpu(rng):
    x = rng.uniform(-1.2, 1.2, 200)
    y = rng.uniform(-1.2, 1.2, 200)
    coeffs = rng.standard_normal(21)
    coeffs[4] = 0.0
    close(beams.zernike_eval(coeffs, x, y),
          jbeams.zernike_eval(coeffs, x, y), atol=1e-12)
    # the reference's first terms: piston, then rho sin, rho cos
    xs = np.linspace(-0.9, 0.9, 11)
    zero = np.zeros_like(xs)
    assert np.allclose(beams.zernike_eval([1.0], xs, zero).numpy(), 1.0)
    assert np.allclose(beams.zernike_eval([0.0, 1.0, 0.0], xs, zero).numpy(),
                       0.0, atol=1e-12)
    assert np.allclose(beams.zernike_eval([0.0, 0.0, 1.0], xs, zero).numpy(),
                       xs, atol=1e-12)
    assert beams.zernike_eval([1.0], np.array([1.5]),
                              np.array([0.0]))[0] == 0.0


def test_kat_beam_model_needs_katbeam():
    if importlib.util.find_spec("katbeam") is not None:
        pytest.skip("katbeam is installed")
    jb, tb = boxes()
    with pytest.raises(ImportError, match="katbeam"):
        jbeams.KatBeamModel(jb)
    with pytest.raises(ImportError, match="katbeam"):
        beams.KatBeamModel(tb)
