"""K5 and K6 (the floating-digitize binned-P(k) reductions) against
fastbox_tpu, in float64.

The plain twins are held to ``binned_pk_half_dual_pallas`` and
``binned_pk_pallas`` in interpret mode (rtol 1e-12: both accumulate in
float64, in different orders), on the anisotropic (1e2, 2e2, 3e2) box of
tests/test_pallas.py and on cubic boxes; the kernels to their twins on a
GPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastbox_tpu.ops.pallas.binned_pk import (binned_pk_half_dual_pallas,
                                              binned_pk_pallas)
from fastbox_tpu_torch.grid import GridSpec
from fastbox_tpu_torch.ops import spectra
from fastbox_tpu_torch.ops.cuda import binned_pk as k5
from fastbox_tpu_torch.ops.cuda import binned_pk_v2 as k4
from fastbox_tpu_torch.ops.cuda import launch_counts
from fastbox_tpu_torch.ops.reduce import binned_weighted_dual

BOXES = {"aniso": (1e2, 2e2, 3e2), "cube": 1e3}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (chip_smoke.py runs the kernels there)")
    return torch.device("cuda")


def physical_plan(grid, dtype=torch.float64, device="cpu"):
    """Squared physical wavenumbers and squared edges, as
    tests/test_pallas.py passes them (any box)."""
    kx, ky, kz = grid.kvec(dtype, device)
    bins = spectra.default_kbins(grid, 20)
    return (kx * kx, ky * ky, kz * kz,
            torch.as_tensor(bins ** 2, dtype=dtype, device=device))


def half_inputs(rng, grid):
    N, H = grid.N, grid.N // 2 + 1
    p1 = np.exp(3.0 * rng.standard_normal((N, N, H)))
    p2 = np.exp(3.0 * rng.standard_normal((N, N, H)))
    wz = np.full(H, 2.0)
    wz[0] = wz[-1] = 1.0
    return p1, p2, wz


def jnp64(t):
    return jnp.asarray(np.asarray(t), jnp.float64)


@pytest.mark.parametrize("box", list(BOXES))
@pytest.mark.parametrize("plan", ["physical", "kbin_plan"])
def test_half_dual_twin_matches_pallas_interpret(rng, box, plan):
    grid = GridSpec.create(box_scale=BOXES[box], nsamp=16)
    H = grid.N // 2 + 1
    p1, p2, wz = half_inputs(rng, grid)
    if plan == "physical":
        kx2, ky2, kz2, e2 = physical_plan(grid)
    else:
        kx2, ky2, kz2, e2 = spectra.kbin_plan(
            grid, spectra.default_kbins(grid, 20), torch.float64)
    kz2h = kz2[:H].contiguous()
    want = binned_pk_half_dual_pallas(
        jnp64(p1), jnp64(p2), jnp64(kx2), jnp64(ky2), jnp64(kz2h), jnp64(wz),
        jnp64(e2), interpret=True)
    got = k5.binned_pk_half_dual(torch.tensor(p1), torch.tensor(p2), kx2,
                                 ky2, kz2h, torch.tensor(wz), e2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)


@pytest.mark.parametrize("box", list(BOXES))
def test_full_twin_matches_pallas_interpret(rng, box):
    grid = GridSpec.create(box_scale=BOXES[box], nsamp=16)
    pk = rng.random(grid.shape)
    kx2, ky2, kz2, e2 = physical_plan(grid)
    want = binned_pk_pallas(jnp64(pk), jnp64(kx2), jnp64(ky2), jnp64(kz2),
                            jnp64(e2), interpret=True)
    got = k5.binned_pk_full(torch.tensor(pk), kx2, ky2, kz2, e2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)


def test_kbin_plan_on_a_cube_is_the_integer_lattice(rng):
    """On a cubic grid the plan's float digitize bins every mode exactly as
    K4's integer lattice, so K5's twin equals K4's (sums bitwise, counts
    the hoisted ones)."""
    grid = GridSpec.create(box_scale=1e3, nsamp=32)
    H = grid.N // 2 + 1
    bins = spectra.default_kbins(grid, 20)
    kx2, ky2, kz2, e2 = spectra.kbin_plan(grid, bins, torch.float32)
    thr = spectra.kbin_thresholds(grid, bins)
    fi2 = torch.as_tensor(spectra._index_sq(grid))
    idx_int = k4.bin_index(fi2, fi2, fi2[:H], torch.as_tensor(thr))
    idx_f32 = k5.bin_index_sq(kx2, ky2, kz2[:H], e2)
    assert torch.equal(idx_int, idx_f32)
    p1, p2, wz = half_inputs(rng, grid)
    t = lambda a: torch.tensor(a)
    s1, q1, s2, cw = k5.binned_pk_half_dual(t(p1), t(p2), kx2.double(),
                                            ky2.double(), kz2[:H].double(),
                                            t(wz), e2.double())
    v2 = k4.binned_pk_half_dual_v2(t(p1), t(p2), fi2.int(), fi2.int(),
                                   fi2[:H].int(), t(wz),
                                   torch.as_tensor(thr))
    for a, b in zip((s1, q1, s2), v2):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    np.testing.assert_array_equal(cw.numpy(),
                                  spectra.hoisted_counts(grid, thr, wz))


def test_anisotropic_plan_uses_squared_physical_operands():
    """Off a cube: k*k of grid.kvec in the dtype and the f64-squared edges
    cast to it (fastbox_tpu/pipeline.py:372, :418-421)."""
    grid = GridSpec.create(box_scale=(4e3, 4e3, 2e3), nsamp=16)
    bins = spectra.default_kbins(grid, 20)
    assert spectra.kbin_thresholds(grid, bins) is None
    kx2, ky2, kz2, e2 = spectra.kbin_plan(grid, bins, torch.float32)
    kx, ky, kz = grid.kvec(torch.float32)
    for a, b in ((kx2, kx * kx), (ky2, ky * ky), (kz2, kz * kz)):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    assert torch.equal(e2, torch.tensor(bins.astype(np.float64) ** 2,
                                        dtype=torch.float32))


def test_launch_shape_depends_on_shape_only():
    assert k5._launch_shape(256 * 256 * 129, 20, 4) == (1024, 128)
    assert k5._launch_shape(256 ** 3, 20, 3) == (1024, 128)
    blocks, threads = k5._launch_shape(512 * 512 * 257, 120, 4)
    assert threads == 32 and 4 * 120 * 33 * 8 + 120 * 8 <= 227 * 1024


def test_cpu_tensors_take_the_twin_and_the_launcher_refuses_them(rng):
    grid = GridSpec.create(box_scale=BOXES["aniso"], nsamp=8)
    kx2, ky2, kz2, e2 = physical_plan(grid)
    pk = torch.tensor(rng.random(grid.shape))
    before = dict(launch_counts())
    k5.binned_pk_full(pk, kx2, ky2, kz2, e2)
    assert launch_counts() == before
    with pytest.raises(ValueError, match="CUDA"):
        k5.binned_pk_full_cuda(pk, kx2, ky2, kz2, e2)
    with pytest.raises(ValueError, match="axes"):
        k5.binned_pk_full_cuda(pk, kx2, ky2, kz2[:5], e2)


@pytest.mark.cuda
@pytest.mark.parametrize("box", list(BOXES))
def test_half_dual_kernel_matches_f64_twin_and_repeats(cuda, rng, box):
    grid = GridSpec.create(box_scale=BOXES[box], nsamp=64)
    H = grid.N // 2 + 1
    p1, p2, wz = half_inputs(rng, grid)
    kx2, ky2, kz2, e2 = physical_plan(grid, torch.float32, cuda)
    a32 = [torch.tensor(a, dtype=torch.float32, device=cuda)
           for a in (p1, p2)]
    args = (kx2, ky2, kz2[:H].contiguous(),
            torch.tensor(wz, dtype=torch.float32, device=cuda), e2)
    got = k5.binned_pk_half_dual_cuda(*a32, *args)
    again = k5.binned_pk_half_dual_cuda(*a32, *args)
    # an f64 index_add_ reduction of the same values on the f32 bins
    idx = k5.bin_index_sq(kx2, ky2, args[2], e2)
    w = torch.broadcast_to(args[3][None, None, :], a32[0].shape).reshape(-1)
    s1, q1, s2, _, cw = binned_weighted_dual(
        a32[0].reshape(-1).double(), a32[1].reshape(-1).double(), w.double(),
        idx, e2.shape[0])
    for g, r, a in zip(got, (s1, q1, s2, cw), again):
        full = r != 0
        assert ((g.double() - r) / r)[full].abs().max().item() <= 1e-6
        assert torch.equal(g, a)


@pytest.mark.cuda
def test_full_kernel_matches_twin(cuda, rng):
    grid = GridSpec.create(box_scale=BOXES["aniso"], nsamp=64)
    pk = torch.tensor(rng.random(grid.shape), device=cuda)
    kx2, ky2, kz2, e2 = physical_plan(grid, torch.float64, cuda)
    got = k5.binned_pk_full_cuda(pk, kx2, ky2, kz2, e2)
    ref = k5.binned_pk_full_plain(pk, kx2, ky2, kz2, e2)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-13, atol=0)
    assert launch_counts()[k5.NAME_FULL] >= 1
