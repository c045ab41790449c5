"""K4t (K4's telescoped mode) and its twin against fastbox_tpu.

The telescoped twin is held to binned_pk_half_dual_pallas_v2(telescoped=
True) in interpret mode on the exact integer lattice (edges thr - 0.5), to
the non-telescoped twin, and in float32 to a float64 numpy oracle beside
fastbox_tpu's own float32 error; the kernel to its twin on a GPU.  The
inputs are uniformly scaled powers, as in tests/test_binned_pk_v2.py: a
prefix difference loses eps * prefix / bin, which stays small only while
no single mode dominates the prefix of a later bin.  The pipeline's
``pallas_pk='v2t'`` path is in test_torch_pipeline_v2t.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastbox_tpu.ops.pallas.binned_pk_v2 import binned_pk_half_dual_pallas_v2
from fastbox_tpu_torch.ops.cuda import _build
from fastbox_tpu_torch.ops.cuda import binned_pk_v2 as k4
from test_torch_binned_pk import cuda, port_args, setup  # noqa: F401


def uniform_case(rng, N, dtype=np.float64):
    """setup()'s lattice and thresholds with powers uniform in [0.1, 5)."""
    _, _, fi2, thr, wz = setup(rng, N)
    H = N // 2 + 1
    p1, p2 = (rng.uniform(0.1, 5.0, (N, N, H)).astype(dtype)
              for _ in range(2))
    return p1, p2, fi2, thr, wz


def jax_v2t(p1, p2, fi2, thr, wz, dtype):
    H = p1.shape[2]
    f = lambda a: jnp.asarray(a, dtype)
    return binned_pk_half_dual_pallas_v2(
        f(p1), f(p2), f(fi2), f(fi2), f(fi2[:H]), f(wz),
        f(thr.astype(np.float64) - 0.5), telescoped=True, interpret=True)


@pytest.mark.parametrize("N", [16, 32])
def test_twin_matches_pallas_v2t_interpret(rng, N):
    case = uniform_case(rng, N)
    want = jax_v2t(*case, jnp.float64)
    got = k4.binned_pk_half_dual_v2(*port_args(*case), telescoped=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)


@pytest.mark.parametrize("N", [16, 32])
def test_f32_twin_within_jax_f32_error(rng, N):
    """Both float32 reductions against a float64 numpy oracle: the port
    forms its prefixes in float64, the TPU kernel in float32, so the port
    may be at most max(2x fastbox_tpu's error, 1e-6) off."""
    p1, p2, fi2, thr, wz = uniform_case(rng, N, np.float32)
    H = N // 2 + 1
    m = (fi2[:, None, None].astype(np.int64) + fi2[None, :, None]
         + fi2[:H][None, None, :])
    idx = np.searchsorted(thr, m.ravel(), side="right")
    w = np.broadcast_to(wz[None, None, :], m.shape).ravel()
    a, b = p1.astype(np.float64).ravel(), p2.astype(np.float64).ravel()
    oracle = [np.bincount(idx, weights=t, minlength=thr.size + 1)[:thr.size]
              for t in (w * a, w * a * a, w * b)]
    jax32 = jax_v2t(p1, p2, fi2, thr, wz, jnp.float32)
    port32 = k4.binned_pk_half_dual_v2(
        *port_args(p1, p2, fi2, thr, wz, dtype=torch.float32), telescoped=True)
    for got, jx, want in zip(port32, jax32, oracle):
        assert got.dtype == torch.float32
        ok = want != 0
        err = np.abs(got.numpy().astype(np.float64)[ok] - want[ok]) / want[ok]
        jerr = (np.abs(np.asarray(jx, np.float64)[ok] - want[ok])
                / want[ok])
        assert err.max() <= max(2.0 * jerr.max(), 1e-6), (err.max(),
                                                          jerr.max())


@pytest.mark.parametrize("N", [16, 32])
def test_telescoped_twin_matches_binned_twin(rng, N):
    """In float64 the differenced prefixes equal the per-bin sums up to
    the cancellation of the prefix: 1e-13 of S_b, which at 32^3 is 1e-13
    of each bin (at 16^3 a bin of a few modes sits under a prefix of
    thousands)."""
    args = port_args(*uniform_case(rng, N))
    tel = k4.binned_pk_half_dual_v2(*args, telescoped=True)
    plain = k4.binned_pk_half_dual_v2(*args)
    for t, p in zip(tel, plain):
        prefix = torch.cumsum(p, 0)
        assert torch.all((t - p).abs() <= 1e-13 * prefix), (t - p).abs().max()
        if N == 32:
            ok = p != 0
            assert ((t - p)[ok] / p[ok]).abs().max() <= 1e-13


def test_wrapper_argument_errors(rng):
    args = port_args(*uniform_case(rng, 16))
    p1, p2, kx2, ky2, kz2h, wz, thr = args
    cuda_fn = k4.binned_pk_half_dual_v2_cuda
    with pytest.raises(ValueError, match="must be \\(Nx, Ny, H\\)"):
        cuda_fn(p1, p2[:-1], kx2, ky2, kz2h, wz, thr, telescoped=True)
    with pytest.raises(ValueError, match="kz2h \\(H,\\)"):
        cuda_fn(p1, p2, kx2, ky2, kz2h[:-1], wz, thr, telescoped=True)
    with pytest.raises(ValueError, match="1..120 thresholds"):
        cuda_fn(p1, p2, kx2, ky2, kz2h, wz, torch.arange(121, dtype=torch.int32),
                telescoped=True)
    # a CPU tensor never reaches the kernel: the CUDA entry refuses it
    with pytest.raises(ValueError, match="one CUDA device"):
        cuda_fn(*args, telescoped=True)
    with pytest.raises(ValueError, match="unsupported device"):
        k4.binned_pk_half_dual_v2(p1.to("meta"), *args[1:], telescoped=True)
    _build.reset_launch_counts()
    k4.binned_pk_half_dual_v2(*args, telescoped=True)
    assert _build.launch_counts() == {}


@pytest.mark.cuda
def test_kernel_matches_f64_twin_and_repeats(cuda, rng):  # noqa: F811
    p1, p2, fi2, thr, wz = uniform_case(rng, 64)
    a32 = port_args(p1, p2, fi2, thr, wz, cuda, torch.float32)
    a64 = port_args(a32[0].double().cpu().numpy(),
                    a32[1].double().cpu().numpy(), fi2, thr, wz, cuda)
    _build.reset_launch_counts()
    got = k4.binned_pk_half_dual_v2_cuda(*a32, telescoped=True)
    again = k4.binned_pk_half_dual_v2_cuda(*a32, telescoped=True)
    assert _build.launch_counts() == {k4.NAME_T: 2}
    ref = k4.binned_pk_half_dual_v2_plain(*a64, telescoped=True)
    for g, r, a in zip(got, ref, again):
        full = r != 0
        rel = ((g.double() - r) / r)[full].abs().max().item()
        assert rel <= 1e-6 and torch.equal(g, a)
