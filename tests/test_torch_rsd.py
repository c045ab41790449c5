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


# Lines of sight the kernels are held at, as chip_smoke.py holds them on the
# card: (box, cells per line) of the cube, 512 cells, the anisotropic box
# (2 Gpc deep) and 62 cells, which is not a multiple of 4 (the direct path).
LINES = {"cube": (4e3, 256), "512": (4e3, 512),
         "anisotropic": ((4e3, 4e3, 2e3), 256), "62": (4e3, 62)}


def line_inputs(rng, line, cells, M=16):
    """remap_inputs' tuple for M lines of sight of LINES[line]."""
    box, C = LINES[line]
    z = GridSpec.create(box_scale=box, nsamp=C).z
    dz = z[1] - z[0]
    vals = rng.standard_normal((M, C))
    vel = rng.uniform(-1.0, 1.0, (M, C)) * cells * dz * HZ
    fill = 0.5 * (vals[:, 0] + vals[:, -1])
    return vals, vel, z, fill, z[0], z[-1] - z[0], 1.0 / HZ


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


@pytest.mark.parametrize("band", [2, 4])
@pytest.mark.parametrize("line", list(LINES))
def test_remap_wrap_twin_matches_pallas_per_line(rng, line, band):
    vals, vel, z, fill, z0, L, inv_hz = line_inputs(rng, line, band - 0.1)
    want = rsd_remap_wrap_pallas(*map(jnp.asarray, (vals, vel, z, fill)),
                                 z0, L, inv_hz, band=band, interpret=True)
    wrap = k2.wrap_params(z0, L, inv_hz, torch.float64, "cpu")
    got = k2.rsd_remap_wrap(*map(torch.tensor, (vals, vel, z, fill)), wrap,
                            band)
    close(got.numpy(), want)


def test_staged_path_rule():
    """K2/K7 take the staged path for 16-byte aligned rows of a multiple of
    4 cells, at most STAGED_MAX_C, at bands 2 and 4; else the direct path."""
    row = lambda C, dtype=torch.float32: torch.empty((4, C), dtype=dtype)
    for C in (4, 132, 256, 512, 4096):
        for dtype in (torch.float32, torch.float64):
            assert k2.staged_path(C, 2, row(C, dtype), row(C, dtype))
            assert k2.staged_path(C, 4, row(C, dtype))
    for C in (62, 130, 257, 4100):
        assert not k2.staged_path(C, 2, row(C))
    for band in (0, 1, 3, 5):
        assert not k2.staged_path(256, band, row(256))
    flat = torch.empty(4 * 256 + 1)
    shifted = flat[1:].view(4, 256)
    assert shifted.is_contiguous()
    assert not k2.staged_path(256, 2, row(256), shifted)


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


@pytest.mark.cuda
@pytest.mark.parametrize("band", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("C, shift", [(256, 0), (512, 0), (132, 0), (62, 0),
                                      (256, 1)])
def test_remap_wrap_kernel_equals_twin_per_line(cuda, rng, band, dtype, C,
                                                shift):
    """Staged rows (256, 512; 132, whose last vector chunk leaves lanes
    idle) and direct ones (62 cells; rows shifted off a 16-byte boundary)."""
    z = GridSpec.create(box_scale=1e3, nsamp=C).z
    dz = z[1] - z[0]
    M = 512
    vals = rng.standard_normal((M, C))
    vel = rng.uniform(-1.0, 1.0, (M, C)) * (band - 0.1) * dz * HZ

    def t(a):
        a = torch.as_tensor(np.asarray(a), dtype=dtype, device=cuda)
        flat = torch.empty(a.numel() + shift, dtype=dtype, device=cuda)
        out = flat[shift:].view(a.shape)
        out.copy_(a)
        return out

    wrap = k2.wrap_params(z[0], z[-1] - z[0], 1.0 / HZ, dtype, cuda)
    args = (t(vals), t(vel), t(z), t(rng.standard_normal(M)), wrap, band)
    assert k2.staged_path(C, band, args[0], args[1]) == (C % 4 == 0
                                                         and not shift)
    assert torch.equal(k2.rsd_remap_wrap_cuda(*args),
                       k2.rsd_remap_wrap_plain(*args))


def _unaligned(t):
    """A contiguous copy of ``t`` starting one element past a 16-byte
    boundary: the kernels' direct paths."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case, staged", [
    ("ascending", True), ("descending", True), ("permuted", True),
    ("100 targets", True), ("98 targets", True), ("62 cells", False),
    ("unaligned", False)])
def test_interp_sorted_kernel_equals_bracket_reference(cuda, rng, dtype, case,
                                                       staged):
    """K3 bit for bit against interp_sorted_bracket (searchsorted and the
    kernel's rounded operations): the staged path's merge walk on
    ascending targets, its bisection on others, and the direct path; rows
    with duplicates and clustered nodes."""
    M, C = 512, 62 if case == "62 cells" else 64
    s = rng.random((M, C)) * 100.0
    s[:, 10] = s[:, 11]
    s[::3, 20:40] = 50.0 + 0.5 * rng.random((len(s[::3]), 20))
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda).contiguous()
    ss = t(np.sort(s, axis=1))
    vv = t(rng.standard_normal((M, C)))
    fill = t(rng.standard_normal(M))
    T = {"100 targets": 100, "98 targets": 98}.get(case, C)
    z = np.linspace(-5.0, 105.0, T)
    if case == "descending":
        z = z[::-1]
    if case == "permuted":
        z = rng.permutation(z)
    z = t(z.copy())
    if case == "unaligned":
        ss, vv = _unaligned(ss), _unaligned(vv)
    assert k3.staged_path(C, T, ss, vv) == staged
    assert torch.equal(k3.interp_sorted_cuda(ss, vv, z, fill),
                       k3.interp_sorted_bracket(ss, vv, z, fill))
