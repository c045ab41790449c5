"""K10's plain twin (fastbox_tpu_torch/ops/cuda/mmdft.py) against
fastbox_tpu's factored-DFT Pallas kernel in interpret mode and numpy.

The cases of tests/test_pallas_dft.py: both supported radix splits, both
axes, both signs (the inverse with its 1/C), shape [6, 8, 40] with C on
the axis, and the ragged (256, 4, 257).  The bound, 2e-6 of max|y|, is that
file's.  The kernel's host plan (radices and twiddle table of its Stockham
FFT) is checked here on the CPU, with a numpy emulation of its passes; the
``cuda``-marked tests hold the kernel to the twin and complex128
``torch.fft`` on a GPU at every supported length.
"""
import numpy as np
import pytest
import torch

from fastbox_tpu.ops.pallas import mmdft as jmmdft
from fastbox_tpu_torch.ops.cuda import mmdft

BOUND = 2e-6
LENGTHS = [256, 512, 768, 1024, 1536, 2048]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (chip_smoke.py runs the kernels there)")
    return torch.device("cuda")


def planes(rng, shape):
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return x.real.astype(np.float32), x.imag.astype(np.float32)


def numpy_ref(xr, xi, axis, sign):
    x = xr.astype(np.float64) + 1j * xi.astype(np.float64)
    return np.fft.fft(x, axis=axis) if sign < 0 else np.fft.ifft(x, axis=axis)


def as_complex(yr, yi):
    return np.asarray(yr, np.float64) + 1j * np.asarray(yi, np.float64)


def twin(xr, xi, axis, sign):
    yr, yi = mmdft.dft_c2c_axis_plain(torch.from_numpy(xr),
                                      torch.from_numpy(xi), axis, sign,
                                      inverse_scale=sign > 0)
    assert yr.dtype == yi.dtype == torch.float32
    return as_complex(yr.numpy(), yi.numpy())


def test_supported_length_matches_jax():
    got = [mmdft.supported_length(C) for C in range(1, 4097)]
    want = [jmmdft.supported_length(C) for C in range(1, 4097)]
    assert got == want
    assert [C for C in range(1, 4097) if got[C - 1]] == [256, 512, 768, 1024,
                                                         1536, 2048]
    assert mmdft._split(512) == (4, 128) and mmdft._split(256) == (2, 128)


@pytest.mark.parametrize("C", LENGTHS)
@pytest.mark.parametrize("sign, inverse_scale",
                         [(-1, False), (1, True), (1, False)])
def test_consts_bitwise_equal_jax(C, sign, inverse_scale):
    got = mmdft._consts(C, sign, inverse_scale)
    want = jmmdft._consts(C, sign, inverse_scale)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        assert np.array_equal(g, w)


@pytest.mark.parametrize("C", [256, 512])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("sign", [-1, +1])
def test_twin_matches_pallas_and_numpy(C, axis, sign, rng):
    shape = [6, 8, 40]
    shape[axis] = C
    xr, xi = planes(rng, shape)
    got = twin(xr, xi, axis, sign)
    yr, yi = jmmdft.dft_c2c_axis_pallas(xr, xi, axis, sign,
                                        inverse_scale=sign > 0,
                                        interpret=True)
    pallas = as_complex(yr, yi)
    ref = numpy_ref(xr, xi, axis, sign)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() / scale < BOUND
    assert np.abs(got - pallas).max() / scale < BOUND


def test_twin_ragged_minor_axis(rng):
    """M = 257, the half axis at 512^3."""
    xr, xi = planes(rng, (256, 4, 257))
    got = twin(xr, xi, 0, -1)
    yr, yi = jmmdft.dft_c2c_axis_pallas(xr, xi, 0, -1, interpret=True)
    ref = numpy_ref(xr, xi, 0, -1)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() / scale < BOUND
    assert np.abs(got - as_complex(yr, yi)).max() / scale < BOUND


@pytest.mark.parametrize("C, axis", [(1024, 0), (768, 1), (2048, 1)])
def test_twin_longer_lengths_match_numpy(C, axis, rng):
    """Lengths the pipeline does not reach (n2 of 256 and 384, n2 = 512)."""
    shape = [3, 4, 5]
    shape[axis] = C
    xr, xi = planes(rng, shape)
    for sign in (-1, 1):
        ref = numpy_ref(xr, xi, axis, sign)
        err = np.abs(twin(xr, xi, axis, sign) - ref).max() / np.abs(ref).max()
        assert err < BOUND


def test_twin_float64_matches_numpy(rng):
    x = rng.standard_normal((512, 3, 7)) + 1j * rng.standard_normal((512, 3, 7))
    yr, yi = mmdft.dft_c2c_axis_plain(torch.from_numpy(x.real.copy()),
                                      torch.from_numpy(x.imag.copy()), 0, -1)
    assert yr.dtype == torch.float64
    ref = np.fft.fft(x, axis=0)
    assert np.abs(as_complex(yr, yi) - ref).max() / np.abs(ref).max() < 1e-13


def test_dispatch_and_checks(rng):
    xr, xi = (torch.from_numpy(a) for a in planes(rng, (256, 2, 3)))
    calls = []
    orig = mmdft.dft_c2c_axis_plain

    def spy(*a, **kw):
        calls.append(a[2])
        return orig(*a, **kw)

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(mmdft, "dft_c2c_axis_plain", spy)
        mmdft.dft_c2c_axis(xr, xi, 0, -1)
    finally:
        mp.undo()
    assert calls == [0]
    with pytest.raises(ValueError, match="length"):
        mmdft.dft_c2c_axis(xr, xi, 1, -1)
    with pytest.raises(ValueError, match="axis"):
        mmdft.dft_c2c_axis(xr, xi, 2, -1)
    with pytest.raises(ValueError, match="sign"):
        mmdft.dft_c2c_axis(xr, xi, 0, 0)
    with pytest.raises(TypeError):
        mmdft.dft_c2c_axis(xr.half(), xi.half(), 0, -1)
    with pytest.raises(ValueError, match="CUDA"):
        mmdft.dft_c2c_axis_cuda(xr, xi, 0, -1)


def test_device_consts_cached_once():
    a = mmdft._device_consts(256, -1, False, torch.float32,
                             torch.device("cpu"))
    b = mmdft._device_consts(256, -1, False, torch.float32,
                             torch.device("cpu"))
    assert a is b and a[:2] == (2, 128)
    assert a[2].shape == (128 * 128,) and a[4].shape == (256,)


@pytest.mark.parametrize("C", LENGTHS)
def test_fft_plan_every_length(C):
    """Radices of the kernel's passes multiply to C, each divides the E
    values a thread holds, and the block (C / E threads per column) fits
    the kernel's 512 threads."""
    radices, E = mmdft._fft_plan(C)
    assert int(np.prod(radices)) == C
    assert set(radices) <= {2, 3, 4, 8, 16}
    assert all(E % r == 0 for r in radices) and C % E == 0
    assert C // E <= 512 and len(radices) <= 8


@pytest.mark.parametrize("C", LENGTHS)
@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fft_twiddles_equal_numpy(C, sign, dtype):
    re, im = mmdft._fft_twiddles(C, sign, dtype)
    w = np.exp(sign * 2j * np.pi * np.arange(C) / C)
    assert re.dtype == im.dtype == np.dtype(dtype) and re.shape == (C,)
    assert np.array_equal(re, w.real.astype(dtype))
    assert np.array_equal(im, w.imag.astype(dtype))


def stockham(x, sign, inverse_scale):
    """The kernel's passes (csrc/mmdft.cu) in numpy, thread by thread: per
    pass of radix R, thread t's butterfly b (j = t + b Tc) reads rows
    j + r C/R, twiddles by table entry r (j % Ns) C/(Ns R), takes a radix-R
    DFT and writes rows (j / Ns) Ns R + j % Ns + r Ns.  The first pass reads
    x, the last writes y, the others go through the shared tile, except
    that when E is the product of the last two radices the last pass takes
    its inputs from the thread's registers, v[b + r E/R]."""
    C = x.shape[0]
    radices, E = mmdft._fft_plan(C)
    re, im = mmdft._fft_twiddles(C, sign, "float64")
    tw = re + 1j * im
    Tc, P = C // E, len(radices)
    fuse = P >= 3 and E == radices[-2] * radices[-1]
    v = np.zeros((Tc, E) + x.shape[1:], complex)   # each thread's registers
    tile, y, Ns = None, np.full_like(x, np.nan), 1
    for p, R in enumerate(radices):
        dft = np.exp(sign * 2j * np.pi * np.outer(np.arange(R), np.arange(R))
                     / R)
        r = np.arange(R)
        if fuse and p == P - 1:
            assert Ns == Tc * (E // R)
            v = v[:, (np.arange(E // R)[:, None] + r * (E // R)).ravel()]
        else:
            src = x if p == 0 else tile
            v = np.stack([np.concatenate([src[t + b * Tc + r * (C // R)]
                                          for b in range(E // R)])
                          for t in range(Tc)])
        out = np.full_like(x, np.nan)
        for t in range(Tc):
            for b in range(E // R):
                j = t + b * Tc
                w = tw[r * (j % Ns) * (C // (Ns * R))]
                v[t, b * R:(b + 1) * R] = dft @ (v[t, b * R:(b + 1) * R]
                                                 * w[:, None])
                out[(j // Ns) * Ns * R + j % Ns + r * Ns] = \
                    v[t, b * R:(b + 1) * R]
        if p == P - 1:
            y = out
        elif not (fuse and p == P - 2):
            tile = out
        Ns *= R
    return y / C if inverse_scale else y


@pytest.mark.parametrize("C", LENGTHS)
def test_fft_plan_emulated_matches_numpy(C, rng):
    x = rng.standard_normal((C, 3)) + 1j * rng.standard_normal((C, 3))
    for sign in (-1, 1):
        want = np.fft.fft(x, axis=0) if sign < 0 else np.fft.ifft(x, axis=0)
        got = stockham(x, sign, sign > 0)
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-13


def _kernel_cases():
    """The earlier cases (both radix splits of the twin, both axes, a
    ragged 257-wide tile), then every supported length on both axes, each
    also on a column count that the kernel's tile width does not divide."""
    yield from [((256, 6, 40), 0), ((6, 256, 40), 1), ((512, 4, 257), 0),
                ((3, 512, 129), 1)]
    for C in LENGTHS:
        yield (C, 6, 40), 0
        yield (6, C, 40), 1
        yield (C, 3, 7), 0
        yield (5, C, 3), 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape, axis", list(_kernel_cases()))
@pytest.mark.parametrize("sign", [-1, +1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_twin_and_fft(cuda, rng, shape, axis, sign, dtype):
    """Within 2e-6 of max|y| (f32) or 1e-13 (f64) of complex128 torch.fft
    and of the twin.  The twin's factored f64 DFT is itself up to ~1.6e-13
    off at 768 and 1536 (measured on the CPU), so in f64 the kernel-twin
    distance is held to the bound plus the twin's own error."""
    xr, xi = planes(rng, shape)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda)
    kr, ki = mmdft.dft_c2c_axis_cuda(t(xr), t(xi), axis, sign, sign > 0)
    pr, pi = mmdft.dft_c2c_axis_plain(t(xr), t(xi), axis, sign, sign > 0)
    got = as_complex(kr.cpu(), ki.cpu())
    twin = as_complex(pr.cpu(), pi.cpu())
    x = torch.complex(t(xr).double(), t(xi).double())
    ref = (torch.fft.fft(x, dim=axis) if sign < 0
           else torch.fft.ifft(x, dim=axis)).cpu().numpy()
    scale = np.abs(ref).max()
    bound = BOUND if dtype == torch.float32 else 1e-13
    twin_own = 0.0 if dtype == torch.float32 else \
        np.abs(twin - ref).max() / scale
    assert np.abs(got - ref).max() / scale < bound
    assert np.abs(got - twin).max() / scale < bound + twin_own


@pytest.mark.cuda
def test_kernel_dispatch_counts(cuda, rng):
    from fastbox_tpu_torch.ops.cuda import _build

    xr, xi = (torch.as_tensor(a, device=cuda) for a in planes(rng, (4, 256, 9)))
    _build.reset_launch_counts()
    mmdft.dft_c2c_axis(xr, xi, 1, -1)
    assert _build.launch_counts() == {"dft_c2c_axis": 1}
