"""K9 (the fused colored half-spectrum draw) and the Box-Muller draw.

On the CPU the wrappers take the plain twins: held, in supplied mode, to
numpy of the Pallas kernel bodies (fastbox_tpu/ops/pallas/half_draw.py
:60-67 and :85-96) exactly; in generated mode to the port's own
``hermitian_half_noise`` on the same generator.  ``bm_from_uniforms`` is
held to fastbox_tpu's ``bm_pair`` on JAX's own uniforms.  The kernel runs
only on a GPU (tests marked ``cuda``; chip_smoke.py runs it on the card).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastbox_tpu.parallel.rng import bm_pair
from fastbox_tpu_torch.fields import gaussian
from fastbox_tpu_torch.grid import GridSpec
from fastbox_tpu_torch.ops.cuda import half_draw as k9
from fastbox_tpu_torch.ops.cuda import launch_counts

N = 16
H = N // 2 + 1
DTYPES = {"float32": (np.float32, torch.float32),
          "float64": (np.float64, torch.float64)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (chip_smoke.py runs the kernels there)")
    return torch.device("cuda")


def velocity_vectors(grid, np_dt, vel_fac=80.0):
    """kx2col (R,), kyz2row and kznumrow (C,) as fastbox_tpu's pipeline
    builds them for 'vz' (pipeline.py:462-472), in numpy."""
    kx, ky, kz = (np.asarray(v, np.float64) for v in grid.kvec(torch.float64))
    kzh = kz[:H]
    kyz2 = (ky[:, None] ** 2 + kzh[None, :] ** 2).reshape(-1)
    kznum = np.where(np.arange(H) == N // 2, 0.0, vel_fac * kzh)
    kznum = np.broadcast_to(kznum[None, :], (N, H)).reshape(-1)
    return (kx ** 2).astype(np_dt), kyz2.astype(np_dt), kznum.astype(np_dt)


def supplied(rng, np_dt):
    amp = rng.uniform(0.0, 5.0, (N, N * H)).astype(np_dt)
    wr = (rng.standard_normal((N, N * H)) * np.sqrt(0.5)).astype(np_dt)
    wi = (rng.standard_normal((N, N * H)) * np.sqrt(0.5)).astype(np_dt)
    return amp, wr, wi


@pytest.mark.parametrize("dt", list(DTYPES))
def test_supplied_twin_equals_pallas_body_in_numpy(rng, dt):
    np_dt, t_dt = DTYPES[dt]
    grid = GridSpec.create(box_scale=(1e3, 1e3, 5e2), nsamp=N)
    amp, wr, wi = supplied(rng, np_dt)
    kx2, kyz2, kznum = velocity_vectors(grid, np_dt)
    # numpy of _kernel_vz with s * n_re == white's real part
    re, im = wr * amp, wi * amp
    k2 = kx2[:, None] + kyz2[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        w = np.where(k2 > 0.0, kznum[None, :] / np.where(k2 > 0.0, k2, 1.0),
                     0.0).astype(np_dt)
    vre, vim = -im * w, re * w
    white = torch.complex(torch.tensor(wr), torch.tensor(wi))
    t = torch.tensor
    delta = k9.colored_half_draw(t(amp), white=white)
    d2, vz = k9.colored_half_draw_vz(t(amp), t(kx2), t(kyz2), t(kznum),
                                     white=white)
    assert delta.dtype == d2.dtype == gaussian.complex_dtype(t_dt)
    for got, want in ((delta.real, re), (delta.imag, im), (d2.real, re),
                      (d2.imag, im), (vz.real, vre), (vz.imag, vim)):
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_on_and_vz_draw_the_same_delta(dt):
    """'on' and 'vz' from one generator seed give the same delta_k."""
    _, t_dt = DTYPES[dt]
    grid = GridSpec.create(box_scale=1e3, nsamp=N)
    amp = torch.rand((N, N, H), generator=torch.Generator().manual_seed(1),
                     dtype=t_dt)
    vecs = [torch.tensor(v) for v in velocity_vectors(grid, DTYPES[dt][0])]
    a = gaussian.colored_half_noise(torch.Generator().manual_seed(5), grid,
                                    amp, t_dt)
    b, vz = gaussian.colored_half_noise_vz(torch.Generator().manual_seed(5),
                                           grid, amp, *vecs, t_dt)
    assert torch.equal(a, b) and vz.shape == a.shape


def test_generated_twin_equals_hermitian_half_noise_times_amp():
    """On the CPU the colored draw consumes the generator exactly as the
    plain draw does, planes included: the same delta_k, bit for bit."""
    grid = GridSpec.create(box_scale=1e3, nsamp=N)
    amp = torch.rand((N, N, H), generator=torch.Generator().manual_seed(2),
                     dtype=torch.float64)
    got = gaussian.colored_half_noise(torch.Generator().manual_seed(8), grid,
                                      amp, torch.float64)
    want = gaussian.hermitian_half_noise(torch.Generator().manual_seed(8),
                                         grid, torch.float64) * amp
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(4096,), (64, 64)])
def test_bm_from_uniforms_matches_jax_bm_pair(shape):
    k1, k2 = jax.random.split(jax.random.PRNGKey(11))
    tiny = jnp.finfo(jnp.float64).tiny
    u1 = jax.random.uniform(k1, shape, jnp.float64, minval=tiny, maxval=1.0)
    u2 = jax.random.uniform(k2, shape, jnp.float64)
    want = bm_pair(k1, k2, shape, jnp.float64)
    got = gaussian.bm_from_uniforms(torch.tensor(np.asarray(u1)),
                                    torch.tensor(np.asarray(u2)))
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-15


def test_box_muller_draw_statistics_and_planes():
    """draw_method='box_muller': unit-normal parts (moments within 5 sigma)
    and the Hermitian planes of the half-spectrum draw."""
    g = torch.Generator().manual_seed(4)
    z = gaussian._complex_normal(g, (64, 64, 64), torch.float64,
                                 method="box_muller")
    for part in (z.real, z.imag):
        x = part.reshape(-1)
        n = x.numel()
        var = x.var(correction=0).item()
        assert abs(x.mean().item()) < 5 / n**0.5
        assert abs(var - 1) < 5 * (2 / n) ** 0.5
        assert abs((x**4).mean().item() / var**2 - 3) < 5 * (96 / n) ** 0.5
    grid = GridSpec.create(box_scale=1e3, nsamp=32)
    h = gaussian.hermitian_half_noise(g, grid, torch.float64,
                                      method="box_muller")
    back = torch.fft.rfftn(torch.fft.irfftn(h, s=grid.shape))
    torch.testing.assert_close(back, h, rtol=0, atol=1e-12)


def test_twins_need_a_source_and_the_launcher_refuses_cpu():
    amp = torch.ones((4, 8))
    before = dict(launch_counts())
    k9.colored_half_draw(amp, torch.Generator().manual_seed(0))
    assert launch_counts() == before
    with pytest.raises(ValueError, match="Generator"):
        k9.colored_half_draw(amp)
    with pytest.raises(ValueError, match="CUDA"):
        k9.colored_half_draw_cuda(amp, white=torch.ones((4, 8),
                                                        dtype=torch.complex64))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", list(DTYPES))
def test_kernel_supplied_mode_is_bitwise_the_twin(cuda, rng, dt):
    np_dt, _ = DTYPES[dt]
    grid = GridSpec.create(box_scale=(1e3, 1e3, 5e2), nsamp=N)
    amp, wr, wi = supplied(rng, np_dt)
    vecs = [torch.tensor(v, device=cuda)
            for v in velocity_vectors(grid, np_dt)]
    amp = torch.tensor(amp, device=cuda)
    white = torch.complex(torch.tensor(wr), torch.tensor(wi)).to(cuda)
    assert torch.equal(k9.colored_half_draw_cuda(amp, white=white),
                       k9.colored_half_draw_plain(amp, white=white))
    for a, b in zip(k9.colored_half_draw_vz_cuda(amp, *vecs, white=white),
                    k9.colored_half_draw_vz_plain(amp, *vecs, white=white)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_generated_mode(cuda):
    amp = torch.ones((256, 256 * 129), device=cuda)
    seed = torch.tensor([9], dtype=torch.int64, device=cuda)
    a = k9.colored_half_draw_cuda(amp, seed=seed)
    b, _ = k9.colored_half_draw_vz_cuda(
        amp, torch.ones(256, device=cuda), torch.ones(256 * 129, device=cuda),
        torch.ones(256 * 129, device=cuda), seed=seed)
    assert torch.equal(a, b)
    x = torch.view_as_real(a).reshape(-1).double() / np.sqrt(0.5)
    n = x.numel()
    assert abs(x.mean().item()) < 5 / n**0.5
    assert abs(x.var().item() - 1) < 5 * (2 / n) ** 0.5
    assert launch_counts()[k9.NAME] >= 1 and launch_counts()[k9.NAME_VZ] >= 1


def _unaligned(t):
    """A contiguous copy of ``t`` starting one element past a 16-byte
    boundary: the element path."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("n", [16, 7, 9])
def test_kernel_paths_supplied_bitwise_and_generated_same_bits(cuda, rng, dt,
                                                                n):
    """Supplied mode bitwise on the vector and element paths (n = 9 has C
    odd); in generated mode the element path draws the vector path's bits,
    and a mode's normals depend only on its row and column."""
    np_dt, t_dt = DTYPES[dt]
    h = n // 2 + 1
    grid = GridSpec.create(box_scale=1e3, nsamp=n)
    amp = torch.tensor(rng.uniform(0.0, 5.0, (n, n * h)).astype(np_dt),
                       device=cuda)
    white = torch.complex(*(torch.tensor(
        (rng.standard_normal((n, n * h)) * np.sqrt(0.5)).astype(np_dt))
        for _ in range(2))).to(cuda)
    kx, ky, kz = (np.asarray(v, np.float64) for v in grid.kvec(torch.float64))
    kyz2 = (ky[:, None] ** 2 + kz[None, :h] ** 2).reshape(-1)
    kznum = np.broadcast_to(80.0 * kz[None, :h], (n, h)).reshape(-1)
    vecs = [torch.tensor(v.astype(np_dt), device=cuda)
            for v in (kx ** 2, kyz2, kznum)]
    for am in (amp, _unaligned(amp)):
        assert torch.equal(k9.colored_half_draw_cuda(am, white=white),
                           k9.colored_half_draw_plain(am, white=white))
        for a, b in zip(k9.colored_half_draw_vz_cuda(am, *vecs, white=white),
                        k9.colored_half_draw_vz_plain(am, *vecs,
                                                      white=white)):
            assert torch.equal(a, b)
    seed = torch.tensor([77], dtype=torch.int64, device=cuda)
    one = torch.ones((n, n * h + 8), dtype=t_dt, device=cuda)
    wide = k9.colored_half_draw_cuda(one, seed=seed)
    ones = torch.ones_like(amp)
    for am in (ones, _unaligned(ones)):
        d = k9.colored_half_draw_cuda(am, seed=seed)
        d2, _ = k9.colored_half_draw_vz_cuda(am, *vecs, seed=seed)
        assert torch.equal(d, wide[:, :n * h]) and torch.equal(d, d2)
