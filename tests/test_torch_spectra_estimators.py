"""The port's nbodykit-replacement estimators (``ops/spectra.py``:
power_spectrum, power_multipoles, correlation_function,
correlation_multipoles and their helpers), ``ops/reduce.binned_sums`` and
``ops/fft_safe.fftn``/``ifftn`` against fastbox_tpu's, on identical numpy
cubes made from a seed, on the CPU.

Values are held in float64 at rtol 1e-10 (atol 1e-8: odd multipoles and
cross terms cancel to roundoff on both sides, where rtol means nothing),
the bounds of tests/test_parallel_spectra.py.  Mode counts are held
exactly in float64 and in float32: the default linear edges (dk = 2 k_f
from 0) put every lattice mode with i^2 + j^2 + l^2 = (2j)^2 on an edge,
and float32 bins some of those differently from float64, so the port's
float32 |k| must round as fastbox_tpu's does.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastbox_tpu.grid import GridSpec as JaxGrid
from fastbox_tpu.ops import fft_safe as jax_fft
from fastbox_tpu.ops import reduce as jax_reduce
from fastbox_tpu.ops import spectra as js
from fastbox_tpu_torch.grid import GridSpec
from fastbox_tpu_torch.ops import fft_safe, reduce, spectra

# name -> (box, N): 16^3 and 32^3 cubes, an odd 15^3 one, a 4 x 4 x 2 box
GRIDS = {"cube16": (1e3, 16), "cube32": (4e3, 32), "odd15": (750.0, 15),
         "aniso": ((4e3, 4e3, 2e3), 16)}
DTYPES = {"f64": (np.float64, torch.float64),
          "f32": (np.float32, torch.float32)}
RTOL, ATOL = 1e-10, 1e-8

# each case runs on two of the grids, and every grid carries each option
POWER_CASES = {
    "auto": (("cube16", "cube32"), dict()),
    "cross_nmu4": (("odd15", "aniso"), dict(cross=True, nmu=4)),
    "offaxis_nmu4_with_zero": (("cube32", "odd15"),
                               dict(nmu=4, los=(1, 1, 1),
                                    exclude_zero=False)),
    "cross_kbins_set": (("aniso", "cube16"),
                        dict(cross=True, dk=0.011, kmin=0.004, kmax=0.1,
                             exclude_zero=False)),
    "offaxis_nmu1": (("cube16", "aniso"), dict(los=(1, 1, 1), dk=0.02)),
}
MULTIPOLE_CASES = {
    "auto_z": dict(poles=(0, 1, 2, 3, 4)),
    "cross_offaxis": dict(cross=True, poles=(0, 1, 2, 3, 4), los=(1, 1, 1)),
    "kbins_set": dict(poles=(0, 2), dk=0.015, kmin=0.003, kmax=0.08,
                      los=(0, 1, 1)),
}
CORR_CASES = {
    "auto": dict(),
    "cross_dr": dict(cross=True, dr=40.0),
    "rmax_set": dict(dr=25.0, rmin=10.0, rmax=300.0),
}
CORR_POLE_CASES = {
    "auto_z": dict(poles=(0, 1, 2, 3, 4), dr=40.0),
    "cross_offaxis": dict(cross=True, poles=(0, 1, 2, 3, 4), los=(1, 1, 1),
                          dr=30.0, rmax=400.0),
}


def grids(name):
    box, n = GRIDS[name]
    return (JaxGrid.create(box_scale=box, nsamp=n),
            GridSpec.create(box_scale=box, nsamp=n))


def cubes(n, np_dtype, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, n, n)).astype(np_dtype) for _ in (0, 1)]


def call_both(jfn, tfn, grid_name, dtype_name, kw):
    """(fastbox_tpu's dict as numpy, the port's dict as numpy) of one
    estimator on the same cube(s)."""
    kw = dict(kw)
    cross = kw.pop("cross", False)
    jg, tg = grids(grid_name)
    np_dtype, _ = DTYPES[dtype_name]
    a, b = cubes(tg.N, np_dtype)
    second_j = jnp.asarray(b) if cross else None
    second_t = torch.as_tensor(b) if cross else None
    want = jfn(jg, jnp.asarray(a), second_j, **kw)
    got = tfn(tg, torch.as_tensor(a), second_t, **kw)
    assert set(got) == set(want)
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()})


def assert_matches(want, got, dtype_name):
    """Every value at RTOL/ATOL in float64; in float32 the bin edges and
    mode counts exactly (the values carry each library's FFT rounding)."""
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, k
    np.testing.assert_array_equal(got["modes"], want["modes"])
    if dtype_name == "f32":
        edges = "k_edges" if "k_edges" in want else "r_edges"
        np.testing.assert_array_equal(got[edges], want[edges])
        return
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   equal_nan=True, err_msg=k)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("case,grid_name", [
    (case, g) for case, (gs, _) in POWER_CASES.items() for g in gs])
def test_power_spectrum(case, grid_name, dtype_name):
    want, got = call_both(js.power_spectrum, spectra.power_spectrum,
                          grid_name, dtype_name, POWER_CASES[case][1])
    assert_matches(want, got, dtype_name)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("grid_name", ["odd15", "aniso"])
@pytest.mark.parametrize("case", list(MULTIPOLE_CASES))
def test_power_multipoles(case, grid_name, dtype_name):
    want, got = call_both(js.power_multipoles, spectra.power_multipoles,
                          grid_name, dtype_name, MULTIPOLE_CASES[case])
    assert_matches(want, got, dtype_name)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("grid_name", ["odd15", "aniso"])
@pytest.mark.parametrize("case", list(CORR_CASES))
def test_correlation_function(case, grid_name, dtype_name):
    want, got = call_both(js.correlation_function,
                          spectra.correlation_function, grid_name,
                          dtype_name, CORR_CASES[case])
    assert_matches(want, got, dtype_name)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("grid_name", ["odd15", "aniso"])
@pytest.mark.parametrize("case", list(CORR_POLE_CASES))
def test_correlation_multipoles(case, grid_name, dtype_name):
    want, got = call_both(js.correlation_multipoles,
                          spectra.correlation_multipoles, grid_name,
                          dtype_name, CORR_POLE_CASES[case])
    assert_matches(want, got, dtype_name)


def test_default_edges_hold_their_edge_sitters_as_jax_f32_does():
    """32^3 in the 4 Gpc box: 280 modes (k = 0 among them) sit on a default
    edge, i^2 + j^2 + l^2 = (2j)^2.  float32 bins 22 of them differently
    from float64; the port's float32 |k| equals fastbox_tpu's bit for bit,
    so each lands in fastbox_tpu's float32 bin and the counts agree."""
    jg, tg = grids("cube32")
    fi = np.asarray(tg.fft_index)
    m = fi[:, None, None] ** 2 + fi[None, :, None] ** 2 \
        + fi[None, None, :] ** 2
    on_edge = np.isin(m, (2 * np.arange(tg.N)) ** 2).ravel()
    assert on_edge.sum() == 280
    edges = js._linear_kbins(jg)
    np.testing.assert_array_equal(spectra._linear_kbins(tg), edges)
    k32 = tg.kmag(torch.float32).numpy().ravel()
    np.testing.assert_array_equal(k32, np.asarray(jg.kmag(jnp.float32))
                                  .ravel())
    bins = {name: np.searchsorted(edges.astype(dt), k, side="right")
            for name, dt, k in (("f32", np.float32, k32),
                                ("f64", np.float64,
                                 tg.kmag(torch.float64).numpy().ravel()))}
    assert (bins["f32"] != bins["f64"])[on_edge].sum() == 22
    modes = {}
    for name in DTYPES:
        want, got = call_both(js.power_spectrum, spectra.power_spectrum,
                              "cube32", name, {})
        np.testing.assert_array_equal(got["modes"], want["modes"])
        modes[name] = got["modes"]
    assert not np.array_equal(modes["f32"], modes["f64"])


@pytest.mark.parametrize("grid_name", list(GRIDS))
def test_helpers_match(grid_name):
    jg, tg = grids(grid_name)
    for kw in (dict(), dict(dk=0.01, kmin=0.002, kmax=0.05)):
        np.testing.assert_array_equal(spectra._linear_kbins(tg, **kw),
                                      js._linear_kbins(jg, **kw))
    for los in ((0, 0, 1), (1, 1, 1), (0, -2, 5)):
        assert spectra._norm_los(los) == js._norm_los(los)
        for dt, jdt in ((torch.float64, jnp.float64),
                        (torch.float32, jnp.float32)):
            np.testing.assert_array_equal(
                spectra._mu_k(tg, dt, los).numpy(),
                np.asarray(js._mu_k(jg, jnp.dtype(jdt), los)))
    with pytest.raises(ValueError, match="nonzero"):
        spectra._norm_los((0, 0, 0))
    mu = np.linspace(-1.0, 1.0, 41)
    for ell in range(5):
        np.testing.assert_allclose(
            spectra._legendre(ell, torch.as_tensor(mu)).numpy(),
            np.asarray(js._legendre(ell, jnp.asarray(mu))), rtol=1e-15,
            atol=1e-15)
    with pytest.raises(NotImplementedError):
        spectra._legendre(5, torch.as_tensor(mu))
    for got, want in zip(spectra._rgrid(tg, torch.float64),
                         js._rgrid(jg, jnp.float64)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_binned_sums_and_c2c_facade():
    rng = np.random.default_rng(5)
    v = rng.standard_normal(5000)
    idx = rng.integers(0, 12, 5000)    # 10 and 11 are dropped
    np.testing.assert_allclose(
        reduce.binned_sums(torch.as_tensor(v), torch.as_tensor(idx),
                           10).numpy(),
        np.asarray(jax_reduce.binned_sums(jnp.asarray(v), jnp.asarray(idx),
                                          10)), rtol=1e-12)
    x = rng.standard_normal((8, 8, 8)) + 1j * rng.standard_normal((8, 8, 8))
    np.testing.assert_allclose(fft_safe.fftn(torch.as_tensor(x)).numpy(),
                               np.asarray(jax_fft.fftn(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(fft_safe.ifftn(torch.as_tensor(x)).numpy(),
                               np.asarray(jax_fft.ifftn(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="rank-3"):
        fft_safe.fftn(torch.zeros(4, 4))
