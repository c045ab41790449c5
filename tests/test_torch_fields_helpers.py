"""The port's field helpers against fastbox_tpu's, in float64 on the CPU:
the new ``GridSpec`` members, ``fields.gaussian.realise_velocity`` /
``realise_potential``, ``fields.transforms`` (transfer function, top-hat
windows, smoothing) and ``cosmology.massfunction``, all at 1e-12, on
identical numpy inputs made from a seed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastbox_tpu.cosmology import build_cosmology as jax_build_cosmology
from fastbox_tpu.cosmology import massfunction as jax_mf
from fastbox_tpu.fields import gaussian as jax_gaussian
from fastbox_tpu.fields import transforms as jax_transforms
from fastbox_tpu.grid import GridSpec as JaxGrid
from fastbox_tpu_torch.cosmology import build_cosmology, massfunction
from fastbox_tpu_torch.fields import gaussian, transforms
from fastbox_tpu_torch.grid import GridSpec

COSMO = dict(Omega_c=0.25, Omega_b=0.05, h=0.7, n_s=0.95, sigma8=0.8)
Z = 0.8
TOL = 1e-12
# name -> (box, N): an even cube (Nyquist planes), an odd one, a 4 x 4 x 2
# box
GRIDS = {"cube16": (1e3, 16), "odd15": (750.0, 15),
         "aniso": ((4e3, 4e3, 2e3), 16)}


@pytest.fixture(scope="module")
def cosmos():
    return (jax_build_cosmology(COSMO, redshift=Z),
            build_cosmology(COSMO, redshift=Z))


def grids(name):
    box, n = GRIDS[name]
    return (JaxGrid.create(box_scale=box, nsamp=n, redshift=Z),
            GridSpec.create(box_scale=box, nsamp=n, redshift=Z))


def delta_k(n, seed=4):
    rng = np.random.default_rng(seed)
    return np.fft.fftn(rng.standard_normal((n, n, n)))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=0)


def close_fft(got, want):
    """An inverse FFT's output, within TOL of its largest value (the FFT's
    rounding scales with the output's norm, not with each value)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=TOL,
                               atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("grid_name", list(GRIDS))
def test_grid_members(grid_name):
    jg, tg = grids(grid_name)
    for name in ("scale_factor", "volume", "voxel_volume"):
        assert getattr(tg, name) == getattr(jg, name)
    for dt, jdt in ((torch.float64, jnp.float64), (torch.float32, jnp.float32)):
        for name in ("k2", "kmag"):
            np.testing.assert_array_equal(getattr(tg, name)(dt).numpy(),
                                          np.asarray(getattr(jg, name)(jdt)))
        for got, want in zip(tg.kperp_kpar(dt), jg.kperp_kpar(jdt)):
            assert tuple(got.shape) == want.shape
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("grid_name", list(GRIDS))
def test_realise_velocity(cosmos, grid_name):
    jc, tc = cosmos
    jg, tg = grids(grid_name)
    dk = delta_k(tg.N)
    got = gaussian.realise_velocity(torch.as_tensor(dk), tg, tc)
    want = jax_gaussian.realise_velocity(jnp.asarray(dk), jg, jc)
    assert got.dtype == torch.complex128 and got.shape == (3,) + tg.shape
    close(got.numpy(), want)
    if tg.N % 2 == 0:   # the most negative frequency plane of each axis
        v = got.numpy()
        h = tg.N // 2
        assert not v[0, h].any() and not v[1, :, h].any() \
            and not v[2, :, :, h].any()


@pytest.mark.parametrize("apply_prefactor", [False, True])
@pytest.mark.parametrize("grid_name", ["cube16", "aniso"])
def test_realise_potential(cosmos, grid_name, apply_prefactor):
    jc, tc = cosmos
    jg, tg = grids(grid_name)
    dk = delta_k(tg.N)
    got = gaussian.realise_potential(torch.as_tensor(dk), tg, tc,
                                     apply_prefactor=apply_prefactor)
    want = jax_gaussian.realise_potential(jnp.asarray(dk), jg, jc,
                                          apply_prefactor=apply_prefactor)
    assert got.numpy()[0, 0, 0] == 0.0
    close(got.numpy(), want)


def test_realise_velocity_keeps_complex64(cosmos):
    _, tc = cosmos
    _, tg = grids("cube16")
    dk = torch.as_tensor(delta_k(tg.N)).to(torch.complex64)
    assert gaussian.realise_velocity(dk, tg, tc).dtype == torch.complex64


@pytest.mark.parametrize("grid_name", list(GRIDS))
def test_transforms(grid_name):
    jg, tg = grids(grid_name)
    dk = delta_k(tg.N, seed=6)

    def beam(k_perp, k_par, lib):
        return lib.exp(-0.5 * (k_perp * 40.0) ** 2) * (lib.abs(k_par) > 0.01)

    got = transforms.apply_transfer_fn(torch.as_tensor(dk), tg,
                                       lambda a, b: beam(a, b, torch))
    want = jax_transforms.apply_transfer_fn(jnp.asarray(dk), jg,
                                            lambda a, b: beam(a, b, jnp))
    assert got.is_complex()
    close_fft(got.numpy(), want)
    got = transforms.smooth_field(torch.as_tensor(dk), tg, 8.0, 0.7)
    want = jax_transforms.smooth_field(jnp.asarray(dk), jg, 8.0, 0.7)
    assert got.is_complex()
    close_fft(got.numpy(), want)


def test_transfer_fn_nan_becomes_zero():
    jg, tg = grids("cube16")
    dk = delta_k(tg.N, seed=7)

    def inv(k_perp, k_par):   # NaN at k_perp = 0 (0/0)
        return k_perp / k_perp

    got = transforms.apply_transfer_fn(torch.as_tensor(dk), tg, inv)
    want = jax_transforms.apply_transfer_fn(jnp.asarray(dk), jg, inv)
    assert np.isfinite(got.numpy()).all()
    close_fft(got.numpy(), want)


def test_windows():
    k = np.concatenate([[0.0], np.geomspace(1e-4, 10.0, 60)])
    for name in ("window", "window1"):
        got = getattr(transforms, name)(torch.as_tensor(k), 8.0)
        want = getattr(jax_transforms, name)(jnp.asarray(k), 8.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=1e-15)


@pytest.mark.parametrize("z", [0.0, 0.8])
def test_massfunction(cosmos, z):
    jc, tc = cosmos
    M = np.geomspace(1e10, 1e15, 12)
    assert massfunction.RHO_CRIT0 == jax_mf.RHO_CRIT0
    for name in ("sigma_m", "dndlog10m", "halo_bias"):
        close(getattr(massfunction, name)(tc, M, z),
              getattr(jax_mf, name)(jc, M, z))
