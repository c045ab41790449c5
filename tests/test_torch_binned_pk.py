"""K4 (the dual binned-P(k) reduction) against fastbox_tpu, in float64.

The plain twin is held to binned_pk_half_dual_pallas_v2 in interpret mode
and to fastbox_tpu.ops.reduce.binned_weighted_dual on the same exact
integer-lattice bin plan (rtol 1e-12); the kernel to its twin on a GPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastbox_tpu.ops.pallas.binned_pk_v2 import binned_pk_half_dual_pallas_v2
from fastbox_tpu.ops.reduce import binned_weighted_dual as jax_bwd
from fastbox_tpu_torch.grid import GridSpec
from fastbox_tpu_torch.ops import spectra
from fastbox_tpu_torch.ops.cuda import binned_pk_v2 as k4
from fastbox_tpu_torch.ops.reduce import binned_weighted_dual


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (chip_smoke.py runs the kernels there)")
    return torch.device("cuda")


def setup(rng, N, nbins=20):
    grid = GridSpec.create(box_scale=1e3, nsamp=N)
    H = N // 2 + 1
    p1 = np.exp(3.0 * rng.standard_normal((N, N, H)))
    p2 = np.exp(3.0 * rng.standard_normal((N, N, H)))
    fi2 = spectra._index_sq(grid)
    thr = spectra.kbin_thresholds(grid, spectra.default_kbins(grid, nbins))
    wz = np.full(H, 2.0)
    wz[0] = wz[-1] = 1.0
    return p1, p2, fi2, thr, wz


def port_args(p1, p2, fi2, thr, wz, dev="cpu", dtype=torch.float64):
    H = p1.shape[2]
    t = lambda a, dt=dtype: torch.as_tensor(a, dtype=dt, device=dev)
    return (t(p1), t(p2), t(fi2, torch.int32), t(fi2, torch.int32),
            t(fi2[:H], torch.int32), t(wz), t(thr, torch.int32))


@pytest.mark.parametrize("N", [16, 32])
def test_twin_matches_pallas_v2_interpret(rng, N):
    p1, p2, fi2, thr, wz = setup(rng, N)
    H = N // 2 + 1
    f = lambda a: jnp.asarray(a, jnp.float64)
    want = binned_pk_half_dual_pallas_v2(
        f(p1), f(p2), f(fi2), f(fi2), f(fi2[:H]), f(wz),
        f(thr.astype(np.float64) - 0.5), interpret=True)
    got = k4.binned_pk_half_dual_v2(*port_args(p1, p2, fi2, thr, wz))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)


def test_twin_matches_jax_one_hot_reduction(rng):
    N = 16
    p1, p2, fi2, thr, wz = setup(rng, N)
    args = port_args(p1, p2, fi2, thr, wz)
    idx = k4.bin_index(*args[2:5], args[6])
    w = np.broadcast_to(wz[None, None, :], p1.shape)
    want = jax_bwd(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(w),
                   jnp.asarray(idx.numpy()), thr.size)
    got = binned_weighted_dual(args[0], args[1], torch.tensor(w), idx,
                               thr.size)
    for g, v in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(v), rtol=1e-12)
    s1, q1, s2 = k4.binned_pk_half_dual_v2(*args)
    for a, b in zip((s1, q1, s2), (got[0], got[1], got[2])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_launch_shape_depends_on_shape_only():
    """(blocks, threads) from the Nx * Ny rows alone; a block's per-warp
    rows of bins (and K4t's block row) fit the 48 KB default at 120 bins."""
    assert k4._launch_shape(256 * 256) == (4096, 256)
    assert k4._launch_shape(16 * 16) == (16, 256)
    assert k4._launch_shape(512 * 512) == (4096, 256)
    assert k4._launch_shape(1) == (1, 256)
    blocks, threads = k4._launch_shape(15 * 15)
    assert blocks * threads // 32 * 2 >= 15 * 15
    assert (threads // 32 + 1) * 3 * 120 * 8 + 120 * 4 <= 48 * 1024


@pytest.mark.cuda
def test_kernel_matches_f64_twin_and_repeats(cuda, rng):
    p1, p2, fi2, thr, wz = setup(rng, 64)
    a32 = port_args(p1, p2, fi2, thr, wz, cuda, torch.float32)
    a64 = port_args(a32[0].double().cpu().numpy(),
                    a32[1].double().cpu().numpy(), fi2, thr, wz, cuda)
    got = k4.binned_pk_half_dual_v2_cuda(*a32)
    again = k4.binned_pk_half_dual_v2_cuda(*a32)
    ref = k4.binned_pk_half_dual_v2_plain(*a64)
    for g, r, a in zip(got, ref, again):
        full = r != 0
        rel = ((g.double() - r) / r)[full].abs().max().item()
        assert rel <= 1e-6 and torch.equal(g, a)
