"""Foregrounds, radiometer sigma, log-normal and the PCA clean of the port
against fastbox_tpu, in float64 on the CPU (rtol 1e-10)."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import torch

from fastbox_tpu.cosmology import build_cosmology as jax_build_cosmology
from fastbox_tpu.fields.transforms import lognormal as jax_lognormal
from fastbox_tpu.filters.pca import pca_filter as jax_pca
from fastbox_tpu.grid import GridSpec as JaxGrid
from fastbox_tpu.models import foregrounds as jfg
from fastbox_tpu.models.noise import radiometer_sigma as jax_sigma
from fastbox_tpu_torch.fields.transforms import lognormal
from fastbox_tpu_torch.filters import pca_filter
from fastbox_tpu_torch.grid import GridSpec
from fastbox_tpu_torch.models import foregrounds as tfg
from fastbox_tpu_torch.models.noise import radiometer_sigma

COSMO = dict(Omega_c=0.25, Omega_b=0.05, h=0.7, n_s=0.95, sigma8=0.8)
N = 16
T = torch.tensor


def close(got, want, rtol=1e-10):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.fixture(scope="module")
def jcosmo():
    return jax_build_cosmology(COSMO, redshift=0.8)


@pytest.mark.parametrize("sigma", [0.7, 2.5])
def test_gaussian_smooth_wrap(rng, sigma):
    f = rng.standard_normal((N, N))
    got = tfg.gaussian_smooth_wrap(T(f), sigma).numpy()
    close(got, jfg.gaussian_smooth_wrap(jnp.asarray(f), sigma))
    close(got, scipy.ndimage.gaussian_filter(f, sigma, mode="wrap"))


@pytest.mark.parametrize("smoothing", [None, 1.3])
def test_foreground_amp_from_whitenoise(rng, jcosmo, smoothing):
    jg = JaxGrid.create(box_scale=1e3, nsamp=N, redshift=0.8)
    tg = GridSpec.create(box_scale=1e3, nsamp=N, redshift=0.8)
    w = rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))
    args = (jcosmo.chi, 57.0, 1.1, 10.0, smoothing)
    want = jfg.ForegroundModel.foreground_amp_from_whitenoise(
        jnp.asarray(w), jg, *args)
    got = tfg.ForegroundModel.foreground_amp_from_whitenoise(T(w), tg, *args)
    close(got.numpy(), want)


def test_cube_builders(rng):
    amps = rng.uniform(1e3, 1e4, (N, N))
    freqs = np.linspace(800.0, 780.0, N)
    alpha = 2.07 + 2e-4 * rng.standard_normal((N, N))
    want = jfg.ForegroundModel.construct_cube_fn(
        jnp.asarray(amps), jnp.asarray(alpha), jnp.asarray(freqs), 130.0)
    got = tfg.ForegroundModel.construct_cube_fn(T(amps), T(alpha), T(freqs),
                                                130.0)
    close(got.numpy(), want)
    got0 = tfg.ForegroundModel.construct_cube_fn(
        T(amps), T(np.float64(2.07)), T(freqs), 130.0)
    close(got0.numpy(), jfg.ForegroundModel.construct_cube_fn(
        jnp.asarray(amps), jnp.asarray(2.07), jnp.asarray(freqs), 130.0))
    dalpha = alpha - 2.07
    logf = np.log(freqs / 130.0)
    ffac = (freqs / 130.0) ** 2.07
    want = jfg.ForegroundModel.construct_cube_smallalpha_fn(
        *map(jnp.asarray, (amps, dalpha, ffac, logf)))
    got = tfg.ForegroundModel.construct_cube_smallalpha_fn(
        *map(T, (amps, dalpha, ffac, logf)))
    close(got.numpy(), want)


def test_radiometer_sigma_and_lognormal(rng, jcosmo):
    tg = GridSpec.create(box_scale=1e3, nsamp=N, redshift=0.8)
    freqs = tg.freq_array(jcosmo)
    ang, _ = tg.pixel_array(jcosmo)
    np.testing.assert_array_equal(radiometer_sigma(freqs, ang, 18, 2, 1, 64),
                                  jax_sigma(freqs, ang, 18, 2, 1, 64))
    d = 0.5 * rng.standard_normal((N, N, N))
    close(lognormal(T(d)).numpy(), jax_lognormal(jnp.asarray(d)))


@pytest.mark.parametrize("nmodes", [1, 4])
def test_pca_filter_matches_jax(rng, nmodes):
    """Four smooth spectral modes (Legendre polynomials) with pixel-varying
    amplitudes of distinct scales (well separated eigenvalues, so the
    removed subspace is well conditioned) plus unit white noise."""
    x = np.linspace(-1.0, 1.0, N)
    modes = np.polynomial.legendre.legvander(x, 3).T   # (4, N), orthogonal
    amps = rng.standard_normal((N, N, 4)) * np.array([1e3, 1e2, 30.0, 10.0])
    cube = amps @ modes + rng.standard_normal((N, N, N))
    want = np.asarray(jax_pca(jnp.asarray(cube), nmodes, precision="HIGHEST"))
    got = pca_filter(T(cube), nmodes)
    assert got.is_contiguous()
    close(got.numpy(), want)
    cleaned, U, amps = pca_filter(T(cube), nmodes, return_filter=True)
    assert U.shape == (N, nmodes) and amps.shape == (nmodes, N * N)
    torch.testing.assert_close(cleaned, got, rtol=0, atol=0)


def test_top_eigvecs_decomposes_in_f64(rng):
    """A float32 covariance is decomposed in float64 and its eigenvectors
    come back in float32; a batch gives each matrix's single result."""
    from fastbox_tpu_torch.filters.pca import covariance, top_eigvecs

    cubes = [T(rng.standard_normal((N, N, N)) * np.linspace(1, 5, N))
             for _ in range(2)]
    covs = torch.stack([covariance(c) for c in cubes]).float()
    U = top_eigvecs(covs[0], 4)
    assert U.dtype == torch.float32 and U.shape == (N, 4)
    want = torch.flip(torch.linalg.eigh(covs[0].double())[1], (-1,))[:, :4]
    torch.testing.assert_close(U, want.float(), rtol=0, atol=0)
    batched = top_eigvecs(covs, 4)
    for i in range(2):
        torch.testing.assert_close(batched[i], top_eigvecs(covs[i], 4),
                                   rtol=0, atol=0)


def test_f32_clean_runs_in_f64(rng):
    """The port departs on purpose from fastbox_tpu here: for a float32
    field the whole clean (mean spectrum, centring, covariance, eigh,
    projection) runs in float64 and only the cleaned cube is rounded to
    float32, where fastbox_tpu computes it in f32.  Under a foreground
    monopole far above the signal, the f32 mean spectrum's rounding stays
    in every pixel of its channel and biased the card's cleaned P(k) in the
    first retained bin (ROADMAP C2); a float64 covariance alone, or with
    float64 projections, left that bias in place on the card.
    ``covariance`` is the float64 product of the float64-centred data, kept
    in float64 (not rounded to float32) so that the chained pipeline's
    hoisted eigh decomposes the very matrix ``pca_filter`` does.  The f32
    clean is the f64 clean of the same f32 data rounded once; it sits no
    farther from fastbox_tpu's f64 clean than fastbox_tpu's own f32 clean
    does."""
    from fastbox_tpu_torch.filters.pca import covariance

    nfreq = 32
    freqs = np.linspace(1.0, 0.8, nfreq)
    fg = rng.uniform(5e3, 1e4, (N, N, 1)) * freqs ** -2.7 \
        * (1.0 + 0.02 * rng.standard_normal((N, N, 1)) * np.log(freqs))
    cube = (fg + rng.standard_normal((N, N, nfreq))).astype(np.float32)
    d = torch.as_tensor(cube, dtype=torch.float64).reshape(-1, nfreq).T
    x = d - d.mean(dim=-1, keepdim=True)
    got = covariance(T(cube))
    assert got.dtype == torch.float64
    assert torch.equal(got, torch.matmul(x, x.T) / (N * N - 1))

    nmodes = 2
    port32 = pca_filter(T(cube), nmodes)
    assert port32.dtype == torch.float32
    assert torch.equal(port32, pca_filter(T(cube).double(), nmodes).float())
    ref = np.asarray(jax_pca(jnp.asarray(cube, jnp.float64), nmodes,
                             precision="HIGHEST"))
    jax32 = np.asarray(jax_pca(jnp.asarray(cube), nmodes,
                               precision="HIGHEST"))
    assert jax32.dtype == np.float32
    scale = np.abs(ref).max()
    err_port = np.abs(port32.numpy() - ref).max() / scale
    err_jax = np.abs(jax32 - ref).max() / scale
    assert err_port <= err_jax, (err_port, err_jax)
