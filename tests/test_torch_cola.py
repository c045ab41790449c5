"""The COLA engine of fastbox_tpu_torch against fastbox_tpu, in float64 on
the CPU: the host step schedule, the band ladder and the whole evolution
(the modules under it: tests/test_torch_lpt_spectra.py and
tests/test_torch_lattice_cic.py).

The schedule agrees exactly (the same numpy/scipy code).  The engine runs
at 16^3 in a 200 Mpc box, z 3 -> 0 in 3 steps, on white noise drawn by
jax.random and handed to both packages; its densities and velocities agree
to 1e-10 of the largest value (three chaotic steps amplify the ~1e-16 FFT
differences by up to ~100x) and the ladder's bands exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastbox_tpu.cosmology import build_cosmology as jax_cosmology
from fastbox_tpu.fields import cola as jcola
from fastbox_tpu.fields import gaussian as jgauss
from fastbox_tpu.grid import GridSpec as JaxGrid
from fastbox_tpu_torch.cosmology import build_cosmology
from fastbox_tpu_torch.fields import cola
from fastbox_tpu_torch.grid import GridSpec
from fastbox_tpu_torch.ops import spectra

COSMO = dict(Omega_c=0.25, Omega_b=0.05, h=0.7, n_s=0.95, sigma8=0.8)
N = 16
RTOL = 1e-10


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


def test_step_schedule_matches(cosmos):
    jc, tc = cosmos
    a0, a1, n = 0.0625, 1.0, 16
    rows = cola._step_schedule(tc.params, a0, a1, n)
    a_steps = np.linspace(a0, a1, n + 1)
    a_half = 0.5 * (a_steps[:-1] + a_steps[1:])
    for i, row in enumerate(rows):
        K1, _ = jcola._kick_drift_integrals(jc.params, a_steps[i], a_half[i])
        K2, _ = jcola._kick_drift_integrals(jc.params, a_half[i],
                                            a_steps[i + 1])
        _, Dr = jcola._kick_drift_integrals(jc.params, a_steps[i],
                                            a_steps[i + 1])
        d1a, _, d2a, _ = jcola._growth_scalars(jc.params, a_steps[i])
        d1b, _, d2b, _ = jcola._growth_scalars(jc.params, a_steps[i + 1])
        assert row == (K1, K2, Dr, d1a, d2a, d1b - d1a, d2b - d2a,
                       a_steps[i])
    assert cola._growth_scalars(tc.params, 0.3) == \
        jcola._growth_scalars(jc.params, 0.3)


# (lattice_B, gradient, force_factor): band ladder B=2 (bands 1 and 2);
# B=1, whose last step and final paint escalate to the exact scatter;
# fd4 on the ladder; a 2x force mesh without the lattice.
ENGINE_CASES = [(2, "spectral", 1), (1, "spectral", 1), (1, "fd4", 1),
                (None, "spectral", 2)]


@pytest.mark.parametrize("lattice_B, gradient, force_factor", ENGINE_CASES)
def test_engine_matches_fastbox_tpu(cosmos, lattice_B, gradient,
                                    force_factor):
    jc, tc = cosmos
    jg, g = grids(box=200.0)
    key = jax.random.PRNGKey(5)
    kw = dict(redshift_init=3.0, n_steps=3, keep_velocities=True,
              lattice_B=lattice_B, gradient=gradient,
              force_factor=force_factor, diagnostics=True)
    d_j, v_j, diag_j = jcola.realise_density_cola(
        key, jg, jc, dtype=jnp.float64, lattice_impl="xla", **kw)
    white = torch.as_tensor(np.array(jgauss.white_noise(key, jg,
                                                        jnp.float64)))
    d, v, diag = cola.realise_density_cola(None, g, tc, white=white,
                                           dtype=torch.float64, **kw)
    close(d.numpy(), d_j)
    close(v.numpy(), v_j)
    assert np.array_equal(diag["used_lattice"].numpy(),
                          np.asarray(diag_j["used_lattice"]))
    for k in ("maxdisp", "frac_out", "final_maxdisp"):
        close(diag[k].numpy(), diag_j[k])
    if lattice_B == 1:
        # the exact scatter ran (band index len(bands))
        assert diag["used_lattice"][-1] == 1
        assert diag["final_maxdisp"] >= 1.0


def test_engine_options_and_errors(cosmos):
    _, tc = cosmos
    _, g = grids(box=200.0)
    white = torch.as_tensor(jax_white(JaxGrid.create(200.0, N), 6))
    kw = dict(redshift_init=3.0, n_steps=3, dtype=torch.float64, white=white)
    d_fused, v = cola.realise_density_cola(None, g, tc, **kw)
    d_seq, none = cola.realise_density_cola(None, g, tc, keep_velocities=False,
                                            fuse_force_gather=False, **kw)
    assert none is None and v.shape == (3, N, N, N)
    # the plain three-mesh gather is three gathers: identical fields
    assert torch.equal(d_fused, d_seq)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        cola.realise_density_cola(None, g, tc, lattice_impl="cuda", **kw)
    with pytest.raises(ValueError, match="lattice_impl"):
        cola.realise_density_cola(None, g, tc, lattice_impl="xla", **kw)
    with pytest.raises(ValueError, match="gradient"):
        cola.realise_density_cola(None, g, tc, gradient="fd8", **kw)
    with pytest.raises(TypeError, match="white noise"):
        cola.realise_density_cola(None, g, tc, redshift_init=3.0,
                                  dtype=torch.float32, white=white)


def test_band_pick_is_strict_and_escalates(cosmos):
    """max|d| exactly equal to a band escalates to the next band, and
    beyond the widest band to the exact scatter (None)."""
    _, tc = cosmos
    _, g = grids(box=200.0)
    eng = cola.ColaEngine(g, tc, redshift_init=3.0, lattice_B=3,
                          device="cpu")
    assert eng.bands == (1, 2, 3)
    assert eng.pick_band(0.0) == 1
    assert eng.pick_band(np.nextafter(1.0, 0.0)) == 1
    assert eng.pick_band(1.0) == 2
    assert eng.pick_band(2.0) == 3
    assert eng.pick_band(3.0) is None
    with pytest.raises(FloatingPointError):
        eng.pick_band(float("nan"))
    # bands wider than the grid allows (2b + 2 > N) are dropped
    small = cola.ColaEngine(GridSpec.create(box_scale=50.0, nsamp=6), tc,
                            redshift_init=3.0, lattice_B=3, device="cpu")
    assert small.bands == (1, 2)


def test_cola_recovers_linear_growth(cosmos):
    """Mirror of tests/test_cola.py: z=9 -> 0 at 32^3 in a 1 Gpc box; the
    large-scale P(k) matches linear theory at z=0."""
    _, tc = cosmos
    grid = GridSpec.create(box_scale=1e3, nsamp=32)
    delta, vel = cola.realise_density_cola(
        torch.Generator().manual_seed(1), grid, tc, redshift_init=9.0,
        n_steps=10, dtype=torch.float64)
    assert delta.shape == (32, 32, 32) and torch.isfinite(delta).all()
    assert delta.min() >= -2.0
    assert abs(delta.mean().item()) < 1e-8
    kc, pk, _ = spectra.binned_power_spectrum(grid, delta_x=delta)
    kc, pk = kc.numpy(), pk.numpy()
    pk_lin = tc.pk_lin(torch.as_tensor(kc)).numpy()
    sel = np.isfinite(pk) & (kc < 0.05) & (kc > 0.01)
    assert sel.sum() >= 3
    ratio = pk[sel] / pk_lin[sel]
    assert np.all(ratio > 0.45) and np.all(ratio < 2.0), ratio
    assert torch.isfinite(vel).all()
    assert 30.0 < vel.std().item() < 1500.0
