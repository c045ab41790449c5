"""The K10 route of the cube transforms (fastbox_tpu_torch/ops/{mmfft,
fft_safe}.py) against fastbox_tpu's FASTBOX_PALLAS_DFT route, on the CPU.

fastbox_tpu takes its route on the CPU only when told to: ``PALLAS_DFT``
and ``_PALLAS_INTERPRET`` set on ``ops/mmfft.py`` (the kernel in interpret
mode, as tests/test_pallas_dft.py runs it) and ``fft_safe._native_allowed``
returning False (its ``PREFER_MM`` off the CPU).  The port takes it with
``mmfft.PALLAS_DFT`` alone, on K10's twin.  Spies count the kernel calls
by axis in both packages.  The slice as a whole is the 256^3 pipeline
(4 Gpc, z = 0.8, f32) on fastbox_tpu's threefry draws, as in
tests/test_torch_pipeline.py.
"""
import contextlib

import jax
import numpy as np
import pytest
import torch

from fastbox_tpu.cosmology import build_cosmology as jax_build_cosmology
from fastbox_tpu.grid import GridSpec as JaxGrid
from fastbox_tpu.ops import fft_safe as jfft_safe
from fastbox_tpu.ops import mmfft as jmmfft
from fastbox_tpu.ops import spectra as jspectra
from fastbox_tpu.ops.pallas import mmdft as jmmdft
from fastbox_tpu.pipeline import PipelineConfig as JaxConfig
from fastbox_tpu.pipeline import _build_pipeline, make_pipeline as jax_make
from fastbox_tpu_torch.convert import from_jax_state
from fastbox_tpu_torch.grid import GridSpec
from fastbox_tpu_torch.ops import fft_safe, mmfft, spectra
from fastbox_tpu_torch.ops.cuda import mmdft
from fastbox_tpu_torch.pipeline import PipelineConfig, make_pipeline
from test_torch_pipeline import COSMO, jax_draws, jax_state, rel_err

BOUND = 2e-6          # tests/test_pallas_dft.py's, of max|y|
N, BOX, Z = 256, 4e3, 0.8


@contextlib.contextmanager
def jax_route():
    """fastbox_tpu on its K10 route; yields the kernel's calls by axis."""
    calls = []
    orig = jmmdft.dft_c2c_axis_pallas

    def spy(xr, xi, axis, *a, **kw):
        calls.append(axis)
        return orig(xr, xi, axis, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmmfft, "PALLAS_DFT", True)
        mp.setattr(jmmfft, "_PALLAS_INTERPRET", True)
        mp.setattr(jfft_safe, "_native_allowed", lambda: False)
        mp.setattr(jmmdft, "dft_c2c_axis_pallas", spy)
        yield calls


@contextlib.contextmanager
def port_route(on: bool = True):
    """The port with ``mmfft.PALLAS_DFT = on``; yields the twin's calls by
    axis."""
    calls = []
    orig = mmdft.dft_c2c_axis_plain

    def spy(xr, xi, axis, *a, **kw):
        calls.append(axis)
        return orig(xr, xi, axis, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mmfft, "PALLAS_DFT", on)
        mp.setattr(mmdft, "dft_c2c_axis_plain", spy)
        yield calls


def max_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got.astype(np.complex128) - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("shape, axes", [((256, 256, 8), [0, 1]),
                                         ((16, 256, 16), [1])])
def test_rfftn3_irfftn3_match_jax_route(rng, shape, axes):
    """(256, 256, 8): both leading axes on the kernel; (16, 256, 16): axis
    0 on the dense planar branch in both packages."""
    x = rng.standard_normal(shape).astype(np.float32)
    with jax_route() as jcalls:
        ja = jmmfft.rfftn_any(jax.numpy.asarray(x), (0, 1, 2))
        jy = jmmfft.irfftn_any(ja, shape[2], (0, 1, 2))
    with port_route() as calls:
        a = mmfft.rfftn3(torch.from_numpy(x))
        y = mmfft.irfftn3(a, shape)
    assert jcalls == calls == axes + axes
    assert a.dtype == torch.complex64 and y.dtype == torch.float32
    assert a.shape == (shape[0], shape[1], shape[2] // 2 + 1)
    ref = np.fft.rfftn(x.astype(np.float64))
    assert max_err(a.numpy(), ref) < BOUND
    assert max_err(a.numpy(), np.asarray(ja)) < BOUND
    assert max_err(y.numpy(), np.asarray(jy)) < BOUND
    assert max_err(y.numpy(), x) < 4 * BOUND


def test_route_raises_off_its_domain():
    x = torch.zeros((16, 16, 16))
    with pytest.raises(ValueError, match="axis-1 length 16"):
        mmfft.rfftn3(x)
    with pytest.raises(TypeError, match="float32"):
        mmfft.rfftn3(torch.zeros((16, 256, 16), dtype=torch.float64))
    with pytest.raises(ValueError, match="rank-3"):
        mmfft.rfftn3(torch.zeros((256, 16)))
    with pytest.raises(TypeError, match="complex64"):
        mmfft.irfftn3(torch.zeros((16, 256, 9), dtype=torch.complex128),
                      (16, 256, 16))
    with pytest.raises(ValueError, match="half spectrum"):
        mmfft.irfftn3(torch.zeros((16, 256, 16), dtype=torch.complex64),
                      (16, 256, 16))
    with pytest.raises(ValueError, match="axis-1"):
        mmfft._dft_pair_leading(torch.zeros((256, 16, 3)),
                                torch.zeros((256, 16, 3)), 1, -1, False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(256, 256, 32), (16, 16, 16)])
def test_facade_flag_off_is_torch_fft(rng, dtype, shape):
    x = torch.as_tensor(rng.standard_normal(shape), dtype=dtype)
    with port_route(on=False) as calls:
        a = fft_safe.rfftn(x)
        y = fft_safe.irfftn(a, shape)
    assert calls == []
    assert torch.equal(a, torch.fft.rfftn(x))
    assert torch.equal(y, torch.fft.irfftn(a, s=shape))


@pytest.mark.parametrize("dtype, shape, routed", [
    (torch.float32, (256, 256, 32), True),
    (torch.float64, (256, 256, 32), False),
    (torch.float32, (16, 16, 16), False),
    (torch.float32, (16, 256, 16), True),
])
def test_facade_flag_on_routes_f32_supported_lengths(rng, dtype, shape,
                                                     routed):
    x = torch.as_tensor(rng.standard_normal(shape), dtype=dtype)
    with port_route() as calls:
        a = fft_safe.rfftn(x)
        y = fft_safe.irfftn(a, shape)
    ref = torch.fft.rfftn(x)
    if routed:
        axes = [0, 1] if shape[0] == 256 else [1]
        assert calls == axes + axes
        assert max_err(a.numpy(), ref.numpy()) < BOUND
        assert max_err(y.numpy(), x.numpy()) < 4 * BOUND
    else:
        assert calls == []
        assert torch.equal(a, ref)
        assert torch.equal(y, torch.fft.irfftn(ref, s=shape))


def test_facade_rank_checks():
    with pytest.raises(ValueError, match="rank-3"):
        fft_safe.rfftn(torch.zeros((4, 4)))
    with pytest.raises(ValueError, match="rank-3"):
        fft_safe.irfftn(torch.zeros((4, 3), dtype=torch.complex64), (4, 4))


# ----------------------------------------------------------------------
# The slice as a whole: the 256^3 pipeline on the route
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def slice256():
    """fastbox_tpu's f64 run (native FFTs) and its f32 run on the K10
    route, and the port's f32 run on the route, on the same draws."""
    jgrid = JaxGrid.create(box_scale=BOX, nsamp=N, redshift=Z)
    jcosmo = jax_build_cosmology(COSMO, redshift=Z)
    cfg64 = JaxConfig(dtype="float64", threefry_noise=True)
    cfg32 = JaxConfig(dtype="float32", threefry_noise=True,
                      draw_dtype="float64", debug_stages=True)
    key = jax.random.PRNGKey(2026)
    keep = ("pk_cleaned", "pk_density", "delta_x", "vel_z")
    out64 = {k: np.asarray(v) for k, v in
             jax_make(jgrid, jcosmo, cfg64)(key).items() if k in keep}
    with jax_route() as jcalls:
        out32 = {k: np.asarray(v) for k, v in
                 jax_make(jgrid, jcosmo, cfg32)(key).items() if k in keep}
    _, (amp64, _) = _build_pipeline(jgrid, jcosmo, cfg64)
    cosmo, amp = from_jax_state(jax_state(jcosmo, amp64))
    del amp64
    draws = {k: torch.tensor(v) for k, v in jax_draws(key, jgrid).items()}
    fn = make_pipeline(GridSpec.create(box_scale=BOX, nsamp=N, redshift=Z),
                       cosmo, PipelineConfig(dtype="float32",
                                             debug_stages=True),
                       device="cpu", amp_half=amp)
    with port_route() as calls:
        port = {k: v.numpy() for k, v in fn(draws=draws).items()
                if k in keep}
    return dict(out64=out64, out32=out32, port=port, jcalls=jcalls,
                calls=calls)


def test_slice_takes_the_route_in_both_packages(slice256):
    """Three cube transforms (delta_x, vel_z, the cleaned cube), each on
    both leading axes."""
    assert slice256["calls"] == [0, 1] * 3
    assert slice256["jcalls"] == [0, 1] * 3


@pytest.mark.parametrize("stage", ["delta_x", "vel_z"])
def test_slice_fields_match_jax_route(slice256, stage):
    got = slice256["port"][stage]
    want = slice256["out32"][stage]
    assert got.dtype == np.float32 and got.shape == (N, N, N)
    assert max_err(got, want) < BOUND


@pytest.mark.parametrize("name", ["pk_cleaned", "pk_density"])
def test_slice_spectra_within_jax_route_floor(slice256, name):
    """Per populated bin against fastbox_tpu f64, within 3x fastbox_tpu's
    own route-f32-vs-f64 error."""
    want = slice256["out64"][name]
    floor = rel_err(slice256["out32"][name], want).max()
    err = rel_err(slice256["port"][name], want).max()
    assert err <= 3.0 * floor, (name, err, floor)


def test_binned_power_spectrum_on_the_route(rng):
    """ops/spectra.binned_power_spectrum(delta_x=) at 256^3, both packages
    on their routes (one R2C each)."""
    x = rng.standard_normal((N, N, N)).astype(np.float32)
    jgrid = JaxGrid.create(box_scale=BOX, nsamp=N, redshift=Z)
    with jax_route() as jcalls:
        _, jpk, jsig = jspectra.binned_power_spectrum(
            jgrid, delta_x=jax.numpy.asarray(x))
    grid = GridSpec.create(box_scale=BOX, nsamp=N, redshift=Z)
    with port_route() as calls:
        _, pk, sig = spectra.binned_power_spectrum(
            grid, delta_x=torch.from_numpy(x))
    assert calls == jcalls == [0, 1]
    assert rel_err(pk.numpy(), np.asarray(jpk)).max() < 1e-5
    assert rel_err(sig.numpy(), np.asarray(jsig)).max() < 1e-4
