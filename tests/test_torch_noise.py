"""K1 (add_scaled_normal) and the half-spectrum draws of the port.

On the CPU the wrapper takes the plain twin: checked against
fastbox_tpu.ops.rsd.add_scaled_normal's CPU path (x + scale * jax normals)
fed the same normals, and for its own statistics.  The kernel itself runs
only on a GPU (tests marked ``cuda``; chip_smoke.py runs them on the card).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastbox_tpu.ops.rsd import add_scaled_normal as jax_add_scaled_normal
from fastbox_tpu_torch.fields.gaussian import hermitian_half_noise
from fastbox_tpu_torch.grid import GridSpec
from fastbox_tpu_torch.ops.cuda import _build, launch_counts
from fastbox_tpu_torch.ops.cuda import noise as k1
from fastbox_tpu_torch.ops.rsd import add_scaled_normal


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (chip_smoke.py runs the kernels there)")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(16, 16, 16), (8, 32)])
@pytest.mark.parametrize("return_max", [False, True])
def test_supplied_normals_match_jax(rng, shape, return_max):
    x = rng.standard_normal(shape) * 300.0
    scale = rng.uniform(50.0, 150.0, shape[-1])
    key = jax.random.PRNGKey(7)
    want = jax_add_scaled_normal(jnp.asarray(x), jnp.asarray(scale), key,
                                 return_max=return_max)
    normals = np.asarray(jax.random.normal(key, shape, jnp.float64))
    got = add_scaled_normal(torch.tensor(x), torch.tensor(scale),
                            normals=torch.tensor(normals),
                            return_max=return_max)
    if return_max:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=1e-12)
        got, want = got[0], want[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


def test_generated_statistics_at_32cubed():
    n = 32**3
    x = torch.zeros((32 * 32, 32), dtype=torch.float64)
    scale = torch.linspace(1.0, 3.0, 32, dtype=torch.float64)
    out, mx = add_scaled_normal(x, scale, torch.Generator().manual_seed(3),
                                return_max=True)
    z = (out / scale).reshape(-1)
    mean, var = z.mean().item(), z.var(correction=0).item()
    kurt = (z**4).mean().item() / var**2
    assert abs(mean) < 5 / n**0.5
    assert abs(var - 1.0) < 5 * (2 / n) ** 0.5
    assert abs(kurt - 3.0) < 5 * (96 / n) ** 0.5
    assert mx.item() == out.abs().max().item()


def test_cpu_tensor_takes_the_twin_and_needs_a_source():
    before = launch_counts().get(k1.NAME, 0)
    x = torch.zeros((4, 8))
    out = add_scaled_normal(x, torch.ones(8), torch.Generator().manual_seed(0))
    assert out.shape == x.shape
    assert launch_counts().get(k1.NAME, 0) == before
    with pytest.raises(ValueError):
        add_scaled_normal(x, torch.ones(8))


def test_cuda_launcher_refuses_cpu_tensors():
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        k1.add_scaled_normal_cuda(x, torch.ones(8), normals=torch.ones(4, 8))


def test_hermitian_half_noise_structure_and_variance():
    grid = GridSpec.create(box_scale=1e3, nsamp=32, redshift=0.8)
    h = hermitian_half_noise(torch.Generator().manual_seed(1), grid,
                             torch.float64)
    assert h.shape == (32, 32, 17) and h.dtype == torch.complex128
    # the kz=0 and Nyquist planes are Hermitian: the rfft round trip keeps h
    back = torch.fft.rfftn(torch.fft.irfftn(h, s=grid.shape))
    torch.testing.assert_close(back, h, rtol=0, atol=1e-12)
    inner = h[:, :, 1:-1]
    assert abs(inner.real.var().item() - 0.5) < 0.05
    assert abs(inner.imag.var().item() - 0.5) < 0.05


@pytest.mark.cuda
def test_kernel_supplied_mode_equals_twin(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((4096, 256), generator=g, device=cuda)
    s = torch.rand(256, generator=g, device=cuda) + 0.5
    n = torch.randn((4096, 256), generator=g, device=cuda)
    a, am = k1.add_scaled_normal_cuda(x, s, normals=n, return_max=True)
    b, bm = k1.add_scaled_normal_plain(x, s, normals=n, return_max=True)
    assert torch.equal(a, b) and am.item() == bm.item()


@pytest.mark.cuda
def test_kernel_generated_mode(cuda):
    x = torch.zeros((4096, 256), device=cuda)
    one = torch.ones(256, device=cuda)
    seed = torch.tensor([5], dtype=torch.int64, device=cuda)
    a, am = k1.add_scaled_normal_cuda(x, one, seed=seed, return_max=True)
    b = k1.add_scaled_normal_cuda(x, one, seed=seed)
    assert torch.equal(a, b) and am.item() == a.abs().max().item()
    n = a.numel()
    assert abs(a.double().mean().item()) < 5 / n**0.5
    assert abs(a.double().var().item() - 1) < 5 * (2 / n) ** 0.5
    assert _build.launch_counts()[k1.NAME] >= 2
