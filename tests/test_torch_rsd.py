"""K2 and K3 (the RSD remap kernels' plain twins) and redshift_space_density
against fastbox_tpu, in float64 on the CPU.

The twins are held to fastbox_tpu's Pallas kernels run in interpret mode
(as tests/test_pallas_rsd.py runs them) and the remap to
fastbox_tpu.ops.rsd.redshift_space_density, with velocities scaled so the
displacement bound lands in each tier: <= 2 dz, (2 dz, 4 dz], > 4 dz.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from fastbox_tpu.grid import GridSpec as JaxGrid
from fastbox_tpu.ops.pallas.rsd_fused import rsd_remap_wrap_pallas
from fastbox_tpu.ops.pallas.rsd_interp import interp_sorted_pallas
from fastbox_tpu.ops.rsd import redshift_space_density as jax_rsd
from fastbox_tpu_torch.grid import GridSpec
from fastbox_tpu_torch.ops.cuda import rsd_fused as k2
from fastbox_tpu_torch.ops.cuda import rsd_interp as k3
from fastbox_tpu_torch.ops.rsd import pick_band, redshift_space_density

N = 16
HZ = 109.0  # km/s/Mpc, about H(z=0.8)
TIERS = [(1.5, 2), (3.5, 4), (8.0, 0)]  # (max cells moved, expected band)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (chip_smoke.py runs the kernels there)")
    return torch.device("cuda")


def close(got, want, rtol=1e-10):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def remap_inputs(rng, cells):
    """(vals, vel, z, fill, z0, L, 1/H) for N^2 lines of sight of N cells."""
    z = GridSpec.create(box_scale=1e3, nsamp=N).z
    dz = z[1] - z[0]
    vals = rng.standard_normal((N * N, N))
    vel = rng.uniform(-1.0, 1.0, (N * N, N)) * cells * dz * HZ
    fill = 0.5 * (vals[:, 0] + vals[:, -1])
    return vals, vel, z, fill, z[0], z[-1] - z[0], 1.0 / HZ


@pytest.mark.parametrize("band", [2, 4])
def test_remap_wrap_twin_matches_pallas(rng, band):
    vals, vel, z, fill, z0, L, inv_hz = remap_inputs(rng, band - 0.1)
    want = rsd_remap_wrap_pallas(*map(jnp.asarray, (vals, vel, z, fill)),
                                 z0, L, inv_hz, band=band, interpret=True)
    t = lambda a: torch.tensor(np.asarray(a))
    wrap = k2.wrap_params(z0, L, inv_hz, torch.float64, "cpu")
    got = k2.rsd_remap_wrap(t(vals), t(vel), t(z), t(fill), wrap, band)
    close(got.numpy(), want)


def test_interp_sorted_twin_matches_pallas(rng):
    M, C = 256, 32
    s = rng.random((M, C)) * 100.0
    v = rng.standard_normal((M, C))
    s[:, 10] = s[:, 11]                       # duplicate coordinates
    s[:8, :] = 40.0 + 20.0 * rng.random((8, C))   # rows with a narrow hull
    z = np.linspace(0.0, 100.0, 40)
    fill = rng.standard_normal(M)
    ss, vv = lax.sort_key_val(jnp.asarray(s), jnp.asarray(v))
    want = interp_sorted_pallas(ss, vv, jnp.asarray(z), jnp.asarray(fill),
                                interpret=True)
    got = k3.interp_sorted(*(torch.tensor(np.asarray(a)) for a in
                             (ss, vv, z, fill)))
    close(got.numpy(), want)


@pytest.mark.parametrize("cells, band", TIERS)
def test_redshift_space_density_matches_jax(rng, cells, band):
    jgrid = JaxGrid.create(box_scale=1e3, nsamp=N, redshift=0.8)
    grid = GridSpec.create(box_scale=1e3, nsamp=N, redshift=0.8)
    dz = grid.z[1] - grid.z[0]
    delta = np.exp(0.5 * rng.standard_normal(grid.shape)) - 1.0
    vel = rng.uniform(-1.0, 1.0, grid.shape) * cells * dz * HZ
    want = jax_rsd(jnp.asarray(delta), jnp.asarray(vel), jgrid, HZ,
                   sigma_nl=0.0)
    vel_t = torch.as_tensor(vel)
    got = redshift_space_density(torch.as_tensor(delta), vel_t, grid, HZ)
    assert pick_band(vel_t.abs().max() / HZ, dz) == band
    close(got.numpy(), want)


def test_redshift_space_density_sigma_nl_matches_supplied(rng):
    """sigma_nl > 0 with supplied normals == adding them to the velocity."""
    grid = GridSpec.create(box_scale=1e3, nsamp=N, redshift=0.8)
    delta = torch.as_tensor(rng.standard_normal(grid.shape))
    vel = torch.as_tensor(rng.standard_normal(grid.shape) * 300.0)
    nrm = torch.as_tensor(rng.standard_normal(grid.shape))
    a = redshift_space_density(delta, vel, grid, HZ, sigma_nl=120.0,
                               normals=nrm)
    b = redshift_space_density(delta, vel + 120.0 * nrm, grid, HZ)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="method"):
        redshift_space_density(delta, vel, grid, HZ, method="cubic")


@pytest.mark.cuda
@pytest.mark.parametrize("band", [2, 4])
def test_remap_wrap_kernel_equals_twin(cuda, rng, band):
    vals, vel, z, fill, z0, L, inv_hz = remap_inputs(rng, band - 0.1)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                  device=cuda).contiguous()
    wrap = k2.wrap_params(z0, L, inv_hz, torch.float32, cuda)
    args = (t(vals), t(vel), t(z), t(fill), wrap, band)
    assert torch.equal(k2.rsd_remap_wrap_cuda(*args),
                       k2.rsd_remap_wrap_plain(*args))


@pytest.mark.cuda
def test_interp_sorted_kernel_matches_twin(cuda, rng):
    M, C = 256, 32
    s = rng.random((M, C)) * 100.0
    s[:, 10] = s[:, 11]
    s[:, 20:23] = s[:, 22:23]                 # a triple duplicate
    v = rng.standard_normal((M, C))
    order = np.argsort(s, axis=1, kind="stable")
    t = lambda a: torch.as_tensor(a, device=cuda).contiguous()
    ss = t(np.take_along_axis(s, order, 1))
    vv = t(np.take_along_axis(v, order, 1))
    z = t(np.concatenate([np.linspace(0.0, 100.0, 40), s[0, [10, 20]]]))
    fill = t(rng.standard_normal(M))
    got = k3.interp_sorted_cuda(ss, vv, z, fill)
    want = k3.interp_sorted_plain(ss, vv, z, fill)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
