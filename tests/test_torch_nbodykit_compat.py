"""The port's nbodykit-style wrappers (``ops/nbodykit_compat.py``) against
fastbox_tpu's on identical numpy inputs made from a seed, in float64 on the
CPU: FFTPower ('1d', '2d', poles, cross, off-axis los), FFTCorr (with and
without poles, cross) and ArrayCatalog.to_mesh (TSC compensated and
interlaced, CIC plain), at rtol 1e-10 (atol 1e-8 for the cancelling odd
poles and cross terms), mode counts exact."""
import numpy as np
import pytest
import torch

from fastbox_tpu.ops import nbodykit_compat as jnb
from fastbox_tpu_torch.ops import nbodykit_compat as nb

BOX = 1e3
N = 16
RTOL, ATOL = 1e-10, 1e-8


def fields(seed=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((N, N, N)), rng.standard_normal((N, N, N))


def assert_result(got, want):
    if want is None:
        assert got is None
        return
    assert isinstance(got, nb._Result) and set(got) == set(want)
    for k in want:
        assert isinstance(got[k], np.ndarray), k
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=RTOL,
                                   atol=ATOL, equal_nan=True, err_msg=k)
    np.testing.assert_array_equal(got.modes, np.asarray(want["modes"]))


POWER = {
    "1d": dict(),
    "2d_poles": dict(mode="2d", Nmu=4, poles=(0, 1, 2, 3, 4)),
    "cross_offaxis": dict(mode="2d", Nmu=3, second=True, los=(1, 2, 2),
                          dk=0.02, kmin=0.005),
}
CORR = {
    "1d": dict(dr=40.0),
    "poles_cross": dict(dr=30.0, rmax=300.0, poles=(0, 2), second=True,
                        los=(0, 1, 1)),
}


@pytest.mark.parametrize("case", list(POWER))
def test_fftpower(case):
    a, b = fields()
    kw = dict(POWER[case])
    second = kw.pop("second", False)
    got = nb.FFTPower(nb.ArrayMesh(a, BOX, device="cpu"),
                      second=nb.ArrayMesh(b, BOX, device="cpu")
                      if second else None, **kw)
    want = jnb.FFTPower(jnb.ArrayMesh(a, BOX),
                        second=jnb.ArrayMesh(b, BOX) if second else None,
                        **kw)
    assert got.attrs == want.attrs
    assert_result(got.power, want.power)
    assert_result(got.poles, want.poles)


@pytest.mark.parametrize("case", list(CORR))
def test_fftcorr(case):
    a, b = fields(5)
    kw = dict(CORR[case])
    second = b if kw.pop("second", False) else None
    got = nb.FFTCorr(nb.ArrayMesh(torch.as_tensor(a), (BOX,) * 3),
                     second=second, **kw)
    want = jnb.FFTCorr(jnb.ArrayMesh(a, BOX), second=second, **kw)
    assert got.attrs == want.attrs
    assert_result(got.corr, want.corr)
    assert_result(got.poles, want.poles)


@pytest.mark.parametrize("window,compensated,interlaced",
                         [("tsc", True, True), ("cic", False, False)])
def test_catalog_to_mesh(window, compensated, interlaced):
    rng = np.random.default_rng(11)
    pos = rng.random((3000, 3)) * BOX
    kw = dict(Nmesh=N, BoxSize=BOX, window=window, compensated=compensated,
              interlaced=interlaced)
    got = nb.ArrayCatalog({"Position": pos}, device="cpu").to_mesh(**kw)
    want = jnb.ArrayCatalog({"Position": pos}).to_mesh(**kw)
    assert got.BoxSize == want.BoxSize and got.grid.N == N
    np.testing.assert_allclose(got.field.numpy(), np.asarray(want.field),
                               rtol=RTOL, atol=1e-12)
    assert_result(nb.FFTPower(got).power, jnb.FFTPower(want).power)


def test_devices_and_arguments(monkeypatch):
    a, _ = fields()
    t = torch.as_tensor(a)
    assert nb.ArrayMesh(t, BOX).field is t      # a tensor stays put
    # numpy goes to the card unless told otherwise; without one, it raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="no CUDA device"):
        nb.ArrayMesh(a, BOX)
    with pytest.raises(ValueError, match="no CUDA device"):
        nb.ArrayCatalog({"Position": np.zeros((4, 3))})
    with pytest.raises(TypeError, match="ArrayMesh"):
        nb.FFTPower(t)
    res = nb._Result(k=1)
    assert res.k == 1
    with pytest.raises(AttributeError):
        res.power
