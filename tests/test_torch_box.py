"""The port's ``CosmoBox`` (``box.py``) and survey helper (``utils.py``)
against fastbox_tpu's, in float64 on the CPU.

Mirrors tests/test_box.py.  Both boxes colour the same white noise (drawn
by jax.random and handed to both), so the fields, the velocity and
potential spectra, the RSD remap (the sigma_NL draw supplied as the
normals fastbox_tpu draws), the transfer function, the binned P(k),
sigma_R and the built-in checks agree to rtol 1e-10 (1e-10 of the largest
value for fields); the COLA realisation to 1e-10 of its largest value, as
tests/test_torch_cola.py holds the engine.  The port's own draws are
deterministic in the seed and keep the reference's shapes and bounds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastbox_tpu import utils as jutils
from fastbox_tpu.box import CosmoBox as JaxBox
from fastbox_tpu.fields import gaussian as jgauss
from fastbox_tpu.ops import rsd as jrsd
from fastbox_tpu_torch import utils
from fastbox_tpu_torch.box import CosmoBox, default_cosmo

CUBE = (1e2, 1e2, 1e2)
RTOL = 1e-10


def boxes(n=16, box=CUBE, z=0.0, seed=11):
    kw = dict(cosmo=default_cosmo, box_scale=box, nsamp=n, redshift=z,
              realise_now=False, seed=seed)
    return JaxBox(**kw), CosmoBox(dtype=torch.float64, device="cpu", **kw)


def white(jb, seed=5):
    return np.array(jgauss.white_noise(jax.random.PRNGKey(seed), jb.grid,
                                       jnp.float64))


def close(got, want, rtol=RTOL):
    """Within rtol of the largest |value| (fields cross zero)."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.nanmax(np.abs(want)))


def realised(n=16, box=CUBE, z=0.0, linear=False):
    jb, tb = boxes(n, box, z)
    w = white(jb)
    jb.realise_density_from_whitenoise(w, linear=linear)
    tb.realise_density_from_whitenoise(w, linear=linear)
    return jb, tb


@pytest.mark.parametrize("linear", (False, True))
@pytest.mark.parametrize("box", (CUBE, (1e2, 2e2, 1e3)))
def test_density_from_whitenoise_matches_fastbox_tpu(linear, box):
    jb, tb = realised(box=box, z=1.0, linear=linear)
    assert tb.delta_x.shape == (16, 16, 16)
    assert tb.delta_x.dtype == torch.float64
    close(tb.delta_x, jb.delta_x)
    close(tb.delta_k, jb.delta_k)


def test_gaussian_box():
    b = CosmoBox(cosmo=default_cosmo, box_scale=CUBE, nsamp=16,
                 realise_now=False, seed=11, dtype=torch.float64,
                 device="cpu")
    b.realise_density()
    assert b.delta_x.shape == (16, 16, 16)
    assert b.delta_x.dtype == torch.float64
    assert bool(torch.isfinite(b.delta_x).all())
    # deterministic in the seed: a deferred realisation and realise_now
    # agree bit for bit (a scalar box_scale means a cube)
    eager = CosmoBox(cosmo=default_cosmo, box_scale=1e2, nsamp=16,
                     redshift=0.0, realise_now=True, seed=11,
                     dtype=torch.float64, device="cpu")
    assert torch.equal(b.delta_x, eager.delta_x)
    assert eager.velocity_k[0].shape == (16, 16, 16)
    assert eager.phi_k.shape == (16, 16, 16)
    b.set_seed(11)
    assert torch.equal(b.realise_density(inplace=False), eager.delta_x)
    assert (b.Lx, b.Ly, b.Lz) == CUBE
    for coord in (b.x, b.y, b.z):
        assert coord.size == 16
    assert np.isclose(b.x.max() - b.x.min(), 1e2)
    aniso = CosmoBox(cosmo=default_cosmo, box_scale=(1e2, 2e2, 1e3),
                     nsamp=16, redshift=1.0, realise_now=True, device="cpu")
    assert aniso.delta_x.shape == (16, 16, 16)
    assert aniso.delta_x.dtype == torch.get_default_dtype()
    assert bool(torch.isfinite(aniso.delta_x).all())


def test_velocity_and_potential_match_fastbox_tpu():
    jb, tb = realised(z=0.5)
    for got, want in zip(tb.realise_velocity(), jb.realise_velocity()):
        close(got, want)
    close(tb.realise_potential(), jb.realise_potential())
    close(tb.realise_potential(apply_prefactor=True),
          jb.realise_potential(apply_prefactor=True))
    d = np.array(jb.delta_x)
    for got, want in zip(tb.realise_velocity(delta_x=d, inplace=False),
                         jb.realise_velocity(delta_x=jnp.asarray(d),
                                             inplace=False)):
        close(got, want)
    with pytest.raises(ValueError, match="only specify one"):
        tb.realise_velocity(delta_x=d, delta_k=tb.delta_k)


def test_lognormal_box():
    jb, tb = realised()
    ln = tb.lognormal(tb.delta_x)
    close(ln, jb.lognormal(jb.delta_x))
    assert bool(torch.isfinite(ln).all()) and ln.min() >= -1.0


@pytest.mark.parametrize("method", ("linear", "nearest"))
@pytest.mark.parametrize("sigma_nl", (0.0, 200.0))
def test_redshift_space_density_matches_fastbox_tpu(method, sigma_nl):
    jb, tb = realised()
    jb.realise_velocity()
    tb.realise_velocity()
    v_j = jnp.fft.ifftn(jb.velocity_k[2]).real
    v_t = torch.fft.ifftn(tb.velocity_k[2]).real
    close(v_t, v_j)
    if sigma_nl == 0.0:
        want = jb.redshift_space_density(delta_x=jb.delta_x, velocity_z=v_j,
                                         method=method)
        normals = None
    else:
        key = jax.random.PRNGKey(9)
        Hz = 100.0 * jb.cosmo.h * jb.cosmology.Ea
        want = jrsd.redshift_space_density(jb.delta_x, v_j, jb.grid, Hz,
                                           sigma_nl=sigma_nl, key=key,
                                           method=method)
        normals = np.array(jax.random.normal(key, jb.grid.shape,
                                             jnp.float64))
    got = tb.redshift_space_density(delta_x=tb.delta_x, velocity_z=v_t,
                                    sigma_nl=sigma_nl, method=method,
                                    normals=normals)
    assert got.shape == (16, 16, 16)
    close(got, want)
    if sigma_nl > 0:   # the box's own draw
        own = tb.redshift_space_density(delta_x=tb.delta_x, velocity_z=v_t,
                                        sigma_nl=sigma_nl, method=method)
        assert bool(torch.isfinite(own).all())


def test_box_transfer_function():
    jb, tb = realised()

    def tfn_j(k_perp, k_par):
        return (1.0 - jnp.exp(-0.5 * (k_par / 0.001) ** 2)) \
            * jnp.exp(-0.5 * (k_perp / 0.1) ** 2)

    def tfn_t(k_perp, k_par):
        return (1.0 - torch.exp(-0.5 * (k_par / 0.001) ** 2)) \
            * torch.exp(-0.5 * (k_perp / 0.1) ** 2)

    out = tb.apply_transfer_fn(tb.delta_k, transfer_fn=tfn_t)
    assert out.shape == (16, 16, 16) and bool(torch.isfinite(out).all())
    close(out, jb.apply_transfer_fn(jb.delta_k, transfer_fn=tfn_j))
    close(tb.smooth_field(tb.delta_k, 8.0), jb.smooth_field(jb.delta_k, 8.0))
    k = np.linspace(0.0, 1.0, 9)
    close(tb.window(k, 8.0), jb.window(k, 8.0))
    close(tb.window1(k, 8.0), jb.window1(k, 8.0))


def test_box_power_spectrum_matches_fastbox_tpu():
    jb, tb = realised(n=32, box=(1e3,) * 3)
    for got, want in zip(tb.binned_power_spectrum(),
                         jb.binned_power_spectrum()):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   equal_nan=True)
    for got, want in zip(tb.binned_power_spectrum(delta_x=tb.delta_x,
                                                  nbins=12),
                         jb.binned_power_spectrum(delta_x=jb.delta_x,
                                                  nbins=12)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   equal_nan=True)
    k, pk = tb.theoretical_power_spectrum()
    k_j, pk_j = jb.theoretical_power_spectrum()
    np.testing.assert_array_equal(k, k_j)
    np.testing.assert_allclose(pk, pk_j, rtol=RTOL)
    assert np.isfinite(pk).all()
    assert np.isclose(tb.sigmaR(R=8.0), tb.sigma8())
    np.testing.assert_allclose(tb.sigmaR(R=12.0), jb.sigmaR(R=12.0),
                               rtol=RTOL)
    np.testing.assert_allclose(tb.test_sampling_error(),
                               jb.test_sampling_error(), rtol=RTOL)


def test_box_coordinates():
    jb, tb = boxes(box=(1e3,) * 3, z=0.8)
    ax_lo, ay_lo = tb.pixel_array()
    ax_hi, ay_hi = tb.pixel_array(redshift=0.82)
    for got, want in zip((ax_lo, ay_lo, ax_hi, ay_hi),
                         jb.pixel_array() + jb.pixel_array(redshift=0.82)):
        np.testing.assert_allclose(got, want, rtol=RTOL)
    assert np.isclose(ax_lo[1] - ax_lo[0], ay_lo[1] - ay_lo[0])
    assert ax_lo[1] - ax_lo[0] > ax_hi[1] - ax_hi[0]
    assert (np.diff(tb.freq_array()) < 0.0).all()
    np.testing.assert_allclose(tb.freq_array(redshift=2.0),
                               jb.freq_array(redshift=2.0), rtol=RTOL)


def test_box_kgrid_attributes():
    jb, tb = boxes(n=8, box=(1e2, 2e2, 4e2))
    for name in ("Kx", "Ky", "Kz"):
        np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name))
    np.testing.assert_allclose(tb.k, jb.k, rtol=1e-15)
    assert tb.boxfactor == jb.boxfactor
    assert np.isclose(tb.boxfactor, 8.0**6 / (1e2 * 2e2 * 4e2))
    for attr in ("N", "redshift", "scale_factor", "line_freq", "kmin",
                 "kmax"):
        assert getattr(tb, attr) == getattr(jb, attr)


def test_box_errors():
    with pytest.raises(TypeError):
        CosmoBox(cosmo=[0.7, 0.3], box_scale=CUBE, nsamp=16,
                 realise_now=False, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no CUDA device"):
            CosmoBox(cosmo=default_cosmo, realise_now=False)


def test_box_builtin_tests():
    jb, tb = realised()
    lhs, rhs = tb.test_parseval()
    assert np.isclose(lhs, rhs)
    np.testing.assert_allclose((lhs, rhs), jb.test_parseval(), rtol=RTOL)


def test_box_cola_matches_fastbox_tpu():
    """The same 16^3 COLA realisation (z 3 -> 0 in 3 steps) in both boxes:
    fastbox_tpu's from its seed, the port's from that seed's white noise."""
    jb, tb = boxes(n=16, box=(200.0,) * 3)
    kw = dict(redshift_init=3.0, n_steps=3)
    want = jb.realise_density_cola(seed=4, **kw)
    got = tb.realise_density_cola(white=white(jb, seed=4), **kw)
    for g, w in zip(got, want):
        close(g, w)
    close(tb.delta_k, jb.delta_k)
    only = tb.realise_density_cola(seed=4, keep_velocities=False,
                                   inplace=False, **kw)
    assert only.shape == (16, 16, 16) and bool(torch.isfinite(only).all())


@pytest.mark.parametrize("kw", (dict(freq_range=(900.0, 1100.0)),
                                dict(z_range=(0.3, 0.6))))
def test_comoving_dimensions_from_survey_matches_fastbox_tpu(kw):
    got = utils.comoving_dimensions_from_survey(default_cosmo, (10.0, 5.0),
                                                **kw)
    want = jutils.comoving_dimensions_from_survey(default_cosmo, (10.0, 5.0),
                                                  **kw)
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL)
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL)
    with pytest.raises(ValueError, match="exactly one"):
        utils.comoving_dimensions_from_survey(default_cosmo, (10.0, 5.0))
