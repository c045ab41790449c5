"""The field and estimator modules the COLA slice of fastbox_tpu_torch
adds, against fastbox_tpu in float64 on the CPU at 16^3: the white-noise
realisation, 2LPT, painting and compensation, binned P(k) with both cores
and the binned reductions.  Per voxel or per value on the same numpy
inputs, at 1e-12 of the largest value (f64 summation and FFT order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastbox_tpu.cosmology import build_cosmology as jax_cosmology
from fastbox_tpu.fields import gaussian as jgauss
from fastbox_tpu.fields import lpt as jlpt
from fastbox_tpu.grid import GridSpec as JaxGrid
from fastbox_tpu.ops import painting as jpaint
from fastbox_tpu.ops import reduce as jreduce
from fastbox_tpu.ops import spectra as jspectra
from fastbox_tpu_torch.cosmology import build_cosmology
from fastbox_tpu_torch.fields import gaussian, lpt
from fastbox_tpu_torch.grid import GridSpec
from fastbox_tpu_torch.ops import painting, reduce, spectra

COSMO = dict(Omega_c=0.25, Omega_b=0.05, h=0.7, n_s=0.95, sigma8=0.8)
N = 16
RTOL = 1e-12


@pytest.fixture(scope="module")
def cosmos():
    return jax_cosmology(COSMO, redshift=0.0), build_cosmology(COSMO,
                                                               redshift=0.0)


def close(got, want, rtol=RTOL):
    got = np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.nanmax(np.abs(want)))


def grids(box=1e3, n=N):
    return (JaxGrid.create(box_scale=box, nsamp=n),
            GridSpec.create(box_scale=box, nsamp=n))


def jax_white(grid, seed):
    return np.array(jgauss.white_noise(jax.random.PRNGKey(seed), grid,
                                       jnp.float64))


def test_white_noise_field_and_hermitian_projection(cosmos):
    jc, tc = cosmos
    jg, g = grids()
    w = jax_white(jg, 3)
    dx_j, dk_j = jgauss.gaussian_field_from_whitenoise(jnp.asarray(w), jg,
                                                       jc.pk_lin_z0)
    dx, dk = gaussian.gaussian_field_from_whitenoise(torch.as_tensor(w), g,
                                                     tc.pk_lin_z0)
    assert dx.dtype == torch.float64 and dk.dtype == torch.complex128
    close(dx.numpy(), dx_j)
    close(dk.numpy(), dk_j)
    close(gaussian.hermitian_symmetrize(torch.as_tensor(w)).numpy(),
          jgauss.hermitian_symmetrize(jnp.asarray(w)))
    # the torch draw: unit complex normal of the grid's shape, per generator
    a = gaussian.white_noise(torch.Generator().manual_seed(1), g)
    b = gaussian.white_noise(torch.Generator().manual_seed(1), g)
    assert a.shape == g.shape and a.dtype == torch.complex64
    assert torch.equal(a, b)
    assert abs(a.real.std().item() - 1.0) < 0.05
    dx2, _ = gaussian.realise_density(torch.Generator().manual_seed(1), g, tc,
                                      linear=True, dtype=torch.float64)
    assert torch.isfinite(dx2).all() and dx2.std() > 0


@pytest.mark.parametrize("form", ["full", "half"])
def test_lpt_displacements_match(cosmos, form):
    jc, tc = cosmos
    jg, g = grids()
    _, dk = jgauss.gaussian_field_from_whitenoise(jnp.asarray(jax_white(jg, 4)),
                                                  jg, jc.pk_lin_z0)
    dk = np.array(dk)
    if form == "half":
        dk = dk[:, :, : N // 2 + 1].copy()
    psi_j = jlpt.lpt_displacements(jnp.asarray(dk), jg)
    psi = lpt.lpt_displacements(torch.as_tensor(dk), g)
    for a, b in zip(psi, psi_j):
        assert a.shape == (3, N, N, N) and a.is_contiguous()
        close(a.numpy(), b)
    assert lpt.second_order_growth(0.5, 0.9) == \
        jlpt.second_order_growth(0.5, 0.9)


@pytest.mark.parametrize("window", ["ngp", "cic", "tsc"])
def test_painting_matches(rng, window):
    jg, g = grids(box=(300.0, 300.0, 300.0))
    pos = rng.uniform(0.0, 300.0, (500, 3))
    w = rng.uniform(0.5, 1.5, 500)
    close(painting.paint_catalogue(torch.as_tensor(pos), g,
                                   torch.as_tensor(w), window).numpy(),
          jpaint.paint_catalogue(jnp.asarray(pos), jg, jnp.asarray(w),
                                 window))
    comp = painting.compensation(g, window, torch.float64)
    close(comp.numpy(), jpaint.compensation(jg, window, jnp.float64))
    close(painting.compensation(g, window, torch.float64, half=True).numpy(),
          np.asarray(jpaint.compensation(jg, window, jnp.float64))
          [..., : N // 2 + 1])
    for interlaced in (False, True):
        close(painting.overdensity_from_catalogue(
            torch.as_tensor(pos), g, window=window,
            interlaced=interlaced).numpy(),
            jpaint.overdensity_from_catalogue(jnp.asarray(pos), jg,
                                              window=window,
                                              interlaced=interlaced))


@pytest.mark.parametrize("box", [1e3, (1e3, 800.0, 1200.0)])
def test_binned_power_spectrum_both_cores(rng, box):
    """delta_x takes the half-spectrum core, delta_k the full one; the
    anisotropic box classifies by floating |k| instead of the lattice."""
    jg, g = grids(box=box)
    dx = rng.standard_normal((N, N, N))
    dk = np.fft.fftn(dx)
    for kw_j, kw in (({"delta_x": jnp.asarray(dx)},
                      {"delta_x": torch.as_tensor(dx)}),
                     ({"delta_k": jnp.asarray(dk)},
                      {"delta_k": torch.as_tensor(dk)})):
        want = [np.asarray(a) for a in
                jspectra.binned_power_spectrum(jg, nbins=12, **kw_j)]
        got = [a.numpy() for a in
               spectra.binned_power_spectrum(g, nbins=12, **kw)]
        for a, b in zip(got, want):
            assert np.array_equal(np.isnan(a), np.isnan(b))
        close(got[0], want[0])
        close(np.nan_to_num(got[1]), np.nan_to_num(want[1]))
        # sigma comes from E[P^2] - E[P]^2, which cancels to zero in a bin
        # of one mode and leaves sqrt(f64 rounding) of P: 1e-7 of max P
        np.testing.assert_allclose(np.nan_to_num(got[2]),
                                   np.nan_to_num(want[2]), rtol=1e-12,
                                   atol=1e-7 * np.nanmax(want[1]))
    with pytest.raises(ValueError):
        spectra.binned_power_spectrum(g, delta_k=torch.as_tensor(dk),
                                      delta_x=torch.as_tensor(dx))


def test_binned_reductions_match(rng):
    v = rng.standard_normal(5000)
    w = rng.uniform(0.0, 2.0, 5000)
    idx = rng.integers(0, 9, 5000)       # bin 8 is out of range
    got = reduce.binned_sum_sumsq_count(torch.as_tensor(v),
                                        torch.as_tensor(idx), 8)
    want = jreduce.binned_sum_sumsq_count(jnp.asarray(v), jnp.asarray(idx), 8)
    for a, b in zip(got, want):
        close(a.numpy(), b)
    got = reduce.binned_weighted_sum_sumsq_count(
        torch.as_tensor(v), torch.as_tensor(w), torch.as_tensor(idx), 8)
    want = jreduce.binned_weighted_sum_sumsq_count(
        jnp.asarray(v), jnp.asarray(w), jnp.asarray(idx), 8)
    for a, b in zip(got, want):
        close(a.numpy(), b)
