"""``remap_los_batched``, K7 and K8 (their plain twins) and the 'nearest'
remap against fastbox_tpu, in float64 on the CPU.

The batched remap is held to ``fastbox_tpu.ops.rsd.remap_los_batched`` in
each of its branches (the port's branch is checked by counting the kernel
wrappers it calls), the twins to fastbox_tpu's Pallas kernels in
interpret mode (as tests/test_pallas_rsd.py runs them).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastbox_tpu.grid import GridSpec as JaxGrid
from fastbox_tpu.ops.pallas.banded_interp import banded_interp_pallas
from fastbox_tpu.ops.pallas.rsd_fused import rsd_bracket_interp_pallas
from fastbox_tpu.ops.rsd import redshift_space_density as jax_rsd
from fastbox_tpu.ops.rsd import remap_los_batched as jax_remap
from fastbox_tpu_torch.grid import GridSpec
from fastbox_tpu_torch.ops import rsd as rsd_ops
from fastbox_tpu_torch.ops.cuda import banded_interp as k8
from fastbox_tpu_torch.ops.cuda import rsd_fused as k7

N = 16
HZ = 109.0  # km/s/Mpc, about H(z=0.8)

# name -> (max cells moved, s_unwrapped given, method, kernel wrapper run)
BRANCHES = {
    "banded": (1.5, False, "linear", "banded_interp"),
    "exact": (9.0, False, "linear", "interp_sorted"),
    "fused": (3.5, True, "linear", "rsd_bracket_interp"),
    "fused_exact": (9.0, True, "linear", "interp_sorted"),
    "nearest": (3.5, True, "nearest", None),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (chip_smoke.py runs the kernels there)")
    return torch.device("cuda")


def close(got, want, rtol=1e-12):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def los_inputs(rng, cells, M=256, C=N):
    """(vals, s, u, z, fill): M lines of sight of C nodes displaced up to
    ``cells`` cells, u before and s after the periodic wrap."""
    z = np.linspace(-500.0, 500.0, C)
    dz = z[1] - z[0]
    u = z[None] + rng.uniform(-cells * dz, cells * dz, (M, C))
    s = (u - z[0]) % (z[-1] - z[0]) + z[0]
    return rng.standard_normal((M, C)), s, u, z, rng.standard_normal(M)


def sorted_nodes(rng, M=256, C=128, cells=3.6):
    """(ss, vv, z, fill) of rows sorted by coordinate, with a duplicate
    node pair in every row."""
    z = np.arange(C, dtype=np.float64)
    s = z[None] + rng.uniform(-cells, cells, (M, C))
    v = rng.standard_normal((M, C))
    order = np.argsort(s, axis=1, kind="stable")
    ss = np.take_along_axis(s, order, 1)
    ss[:, 10] = ss[:, 11]
    return ss, np.take_along_axis(v, order, 1), z, rng.standard_normal(M)


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_remap_los_batched_matches_jax(rng, monkeypatch, branch):
    cells, unwrapped, method, kernel = BRANCHES[branch]
    vals, s, u, z, fill = los_inputs(rng, cells)
    su = u if unwrapped else None
    want = jax_remap(*map(jnp.asarray, (vals, s, z, fill)), method=method,
                     ztarget_np=z,
                     s_unwrapped=None if su is None else jnp.asarray(su))
    calls = []
    for name in ("banded_interp", "interp_sorted", "rsd_bracket_interp"):
        fn = getattr(rsd_ops, name)
        monkeypatch.setattr(rsd_ops, name, lambda *a, _f=fn, _n=name, **k:
                            calls.append(_n) or _f(*a, **k))
    got = rsd_ops.remap_los_batched(
        *map(torch.tensor, (vals, s, z, fill)), method=method, ztarget_np=z,
        s_unwrapped=None if su is None else torch.tensor(su))
    assert calls == ([kernel] if kernel else [])
    close(got.numpy(), want)


def test_remap_los_batched_rejects_unknown_method(rng):
    vals, s, _, z, fill = los_inputs(rng, 1.0)
    with pytest.raises(ValueError, match="cubic"):
        rsd_ops.remap_los_batched(*map(torch.tensor, (vals, s, z, fill)),
                                  method="cubic")


@pytest.mark.parametrize("band", [2, 4])
def test_banded_interp_twin_matches_pallas(rng, band):
    ss, vv, z, fill = sorted_nodes(rng, cells=band - 0.4)
    want = banded_interp_pallas(*map(jnp.asarray, (ss, vv, z, fill)),
                                band=band, interpret=True)
    got = k8.banded_interp(*map(torch.tensor, (ss, vv, z, fill)), band)
    close(got.numpy(), want)


@pytest.mark.parametrize("band", [2, 4])
def test_bracket_interp_twin_matches_pallas(rng, band):
    z = np.arange(128, dtype=np.float64)
    u = z[None] + rng.uniform(-band, band, (256, 128))
    s = (u - z[0]) % (z[-1] - z[0]) + z[0]
    v = rng.standard_normal((256, 128))
    fill = rng.standard_normal(256)
    want = rsd_bracket_interp_pallas(*map(jnp.asarray, (s, v, z, fill)),
                                     band=band, interpret=True)
    got = k7.rsd_bracket_interp(*map(torch.tensor, (s, v, z, fill)), band)
    close(got.numpy(), want)


# Line lengths of chip_smoke.py's K7 checks (the anisotropic box's lines
# have the cube's 256 cells): 62 is not a multiple of 4 (the direct path).
LINE_CELLS = (256, 512, 62)


@pytest.mark.parametrize("band", [2, 4])
@pytest.mark.parametrize("C", LINE_CELLS)
def test_bracket_interp_twin_matches_pallas_per_line(rng, C, band):
    vals, s, _, z, fill = los_inputs(rng, band - 0.1, M=16, C=C)
    want = rsd_bracket_interp_pallas(*map(jnp.asarray, (s, vals, z, fill)),
                                     band=band, interpret=True)
    got = k7.rsd_bracket_interp(*map(torch.tensor, (s, vals, z, fill)),
                                band)
    close(got.numpy(), want)


def test_bracket_interp_is_k2_after_the_wrap(rng):
    """K2's twin is the wrap followed by K7's twin."""
    vals, _, u, z, fill = los_inputs(rng, 1.5)
    vel = (z[None] - u) * HZ
    wrap = k7.wrap_params(z[0], z[-1] - z[0], 1.0 / HZ, torch.float64, "cpu")
    t = torch.tensor
    a = k7.rsd_remap_wrap(t(vals), t(vel), t(z), t(fill), wrap, 2)
    z0, length, inv_hz = wrap
    s = torch.remainder(t(z)[None] - t(vel) * inv_hz - z0, length) + z0
    b = k7.rsd_bracket_interp(s, t(vals), t(z), t(fill), 2)
    assert torch.equal(a, b)


@pytest.mark.parametrize("cells", [1.5, 8.0])
def test_redshift_space_density_nearest_matches_jax(rng, cells):
    jgrid = JaxGrid.create(box_scale=1e3, nsamp=N, redshift=0.8)
    grid = GridSpec.create(box_scale=1e3, nsamp=N, redshift=0.8)
    dz = grid.z[1] - grid.z[0]
    delta = np.exp(0.5 * rng.standard_normal(grid.shape)) - 1.0
    vel = rng.uniform(-1.0, 1.0, grid.shape) * cells * dz * HZ
    want = jax_rsd(jnp.asarray(delta), jnp.asarray(vel), jgrid, HZ,
                   sigma_nl=0.0, method="nearest")
    got = rsd_ops.redshift_space_density(
        torch.as_tensor(delta), torch.as_tensor(vel), grid, HZ,
        method="nearest")
    close(got.numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_banded_interp_kernel_equals_twin(cuda, rng, dtype):
    ss, vv, z, fill = sorted_nodes(rng)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda).contiguous()
    args = (t(ss), t(vv), t(z), t(fill), 4)
    assert torch.equal(k8.banded_interp_cuda(*args),
                       k8.banded_interp_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("band", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bracket_interp_kernel_equals_twin(cuda, rng, band, dtype):
    z = np.arange(128, dtype=np.float64)
    u = z[None] + rng.uniform(-band, band, (256, 128))
    s = (u - z[0]) % (z[-1] - z[0]) + z[0]
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda).contiguous()
    args = (t(s), t(rng.standard_normal((256, 128))), t(z),
            t(rng.standard_normal(256)), band)
    assert torch.equal(k7.rsd_bracket_interp_cuda(*args),
                       k7.rsd_bracket_interp_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("band", [2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("C", LINE_CELLS + (132,))
def test_bracket_interp_kernel_equals_twin_per_line(cuda, rng, band, dtype,
                                                    C):
    """Staged rows (bands 2 and 4 at 256, 512 and 132 cells) and direct ones
    (62 cells; band 3)."""
    vals, s, _, z, fill = los_inputs(rng, band - 0.1, M=512, C=C)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda).contiguous()
    args = (t(s), t(vals), t(z), t(fill), band)
    assert k7.staged_path(C, band, args[0], args[1]) == (
        C % 4 == 0 and band != 3)
    assert torch.equal(k7.rsd_bracket_interp_cuda(*args),
                       k7.rsd_bracket_interp_plain(*args))
