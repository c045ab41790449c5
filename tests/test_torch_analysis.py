"""The port's ``analysis`` package, ``timing.stage`` and ``Cosmology.H``/``pk``
against fastbox_tpu's, on the CPU, on identical inputs.

Tolerances, each of the largest value compared unless stated:
- datacube: ``replace_nan_with_channel_mean`` 1e-14; ``interpolate_onto_grid``
  1e-12 against fastbox_tpu and against scipy's ``RegularGridInterpolator``,
  NaNs in the same places (1e-6 for a float32 field against fastbox_tpu,
  whose channel means round in another summation order);
  ``grid_catalogue``'s counts and bin arrays equal to fastbox_tpu's and
  ``np.histogramdd``'s, weighted grids equal to fastbox_tpu's (both add in
  input order) and within the dtype's summation rounding of
  ``np.histogramdd``'s (which adds in float64).
- voids: labels equal to fastbox_tpu's, ties included; the centroids, radii
  and stack 1e-12, with the same failures.
- inpaint: ``gaussian_cr_1d`` on fastbox_tpu's own normals 1e-8 at
  ``cg_tol`` 1e-12 and 1e-5 at the default 1e-8: the CG matrices here have
  condition numbers near 9e3, so two CGs that round differently and stop
  at a relative residual of tol may differ by up to ~cond x tol (measured:
  9.6e-10 at 1e-12); LSSA 1e-12;
  ``trim_flagged_channels`` equal.
- forecast: every function 1e-10 relative, with the same INF_NOISE cuts.
- ``Cosmology.H`` and ``pk`` 1e-12 relative.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.interpolate
import torch

import fastbox_tpu.analysis as ja
import fastbox_tpu_torch.analysis as ta
from fastbox_tpu import timing as jtiming
from fastbox_tpu.analysis.inpaint import _psd_sqrt as jsqrt
from fastbox_tpu.analysis.voids import _steepest_descent_labels as jdescent
from fastbox_tpu.box import CosmoBox as JaxBox
from fastbox_tpu.cosmology import build_cosmology as jbuild
from fastbox_tpu_torch import timing as ttiming
from fastbox_tpu_torch.analysis.inpaint import _psd_sqrt as tsqrt
from fastbox_tpu_torch.analysis.voids import (
    _steepest_descent_labels as tdescent)
from fastbox_tpu_torch.box import CosmoBox, default_cosmo
from fastbox_tpu_torch.cosmology import build_cosmology as tbuild

CPU = "cpu"


def frac_err(got, want) -> float:
    """max|got - want| / max|want| over finite values, with NaNs required in
    the same places."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    return float(np.abs(got[ok] - want[ok]).max() / np.abs(want[ok]).max())


# ----------------------------------------------------------------------
# Datacube
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_replace_nan_with_channel_mean(rng, dtype):
    f = rng.standard_normal((6, 7, 5)).astype(dtype)
    f[1, 2, 0] = f[3, 3, 2] = f[0, 0, 2] = np.nan
    f[:, :, 4] = np.nan
    f[2, 2, 4] = 1.5                      # one good value in the channel
    got = ta.replace_nan_with_channel_mean(torch.as_tensor(f)).numpy()
    want = np.asarray(ja.replace_nan_with_channel_mean(jnp.asarray(f)))
    assert got.dtype == want.dtype
    eps = 1e-14 if dtype == np.float64 else 1e-6
    assert frac_err(got, want) <= eps
    assert got[1, 2, 0] == pytest.approx(np.nanmean(f[:, :, 0]), rel=eps)
    assert np.all(got[:, :, 4] == 1.5)


def regrid_case(rng, dtype):
    x = np.linspace(0.0, 1.0, 8)
    y = np.linspace(-2.0, 2.0, 9)
    z = np.sort(rng.uniform(0.0, 3.0, 10))      # non-uniform nodes
    f = rng.standard_normal((8, 9, 10)).astype(dtype)
    f.ravel()[rng.choice(f.size, 7, replace=False)] = np.nan
    xn = np.linspace(-0.1, 0.95, 6)              # past the lower edge
    yn = np.linspace(-2.0, 2.0, 5)               # on both edges
    zn = np.linspace(0.2, 3.2, 7)                # past the upper edge
    return f, (x, y, z), (xn, yn, zn)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_interpolate_onto_grid_matches_fastbox_tpu_and_scipy(rng, dtype):
    f, orig, new = regrid_case(rng, dtype)
    got = ta.interpolate_onto_grid(torch.as_tensor(f), orig, new).numpy()
    want = np.asarray(ja.interpolate_onto_grid(jnp.asarray(f), orig, new))
    assert got.dtype == want.dtype == np.float64   # float64 coordinates
    # a float32 field's channel means round in each package's summation
    # order, so its filled values agree to float32 rounding
    eps = 1e-12 if dtype == np.float64 else 1e-6
    assert frac_err(got, want) <= eps
    filled = ta.replace_nan_with_channel_mean(torch.as_tensor(f)).numpy()
    interp = scipy.interpolate.RegularGridInterpolator(
        orig, filled, method="linear", bounds_error=False, fill_value=np.nan)
    X, Y, Z = np.meshgrid(*new, indexing="ij")
    ref = interp(np.stack([X.ravel(), Y.ravel(), Z.ravel()], -1)).reshape(
        X.shape)
    assert np.isnan(got).any() and not np.isnan(got).all()
    assert frac_err(got, ref) <= 1e-12


def test_interpolate_onto_grid_float32_coordinates(rng):
    f, orig, new = regrid_case(rng, np.float32)
    orig32 = tuple(c.astype(np.float32) for c in orig)
    new32 = tuple(c.astype(np.float32) for c in new)
    got = ta.interpolate_onto_grid(torch.as_tensor(f), orig32, new32,
                                   device=CPU).numpy()
    want = np.asarray(ja.interpolate_onto_grid(jnp.asarray(f), orig32, new32))
    assert got.dtype == want.dtype == np.float32
    assert frac_err(got, want) <= 1e-6


def catalogue(rng, n, dtype):
    """Half uniform in [0, 1)^3, half in Gaussian blobs (some outside)."""
    u = rng.random((n // 2, 3))
    centres = rng.random((8, 3))
    c = centres[rng.integers(0, 8, n - n // 2)] + 0.05 * rng.standard_normal(
        (n - n // 2, 3))
    pts = np.concatenate([u, c]).astype(dtype)
    pts[0] = (1.0, 1.0, 1.0)      # the top edge, inclusive
    pts[1] = (0.0, 0.0, 0.0)
    return pts.T, rng.random(n).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("limits", [None, (0.0, 1.0)])
@pytest.mark.parametrize("weighted", [False, True])
def test_grid_catalogue_matches_fastbox_tpu_and_histogramdd(rng, dtype,
                                                            limits, weighted):
    (x, y, z), w = catalogue(rng, 3000, dtype)
    w = w if weighted else None
    lim = {} if limits is None else dict(xlim=limits, ylim=limits,
                                         zlim=limits)
    bins = dict(nx=5, ny=6, nz=7)
    got, gbins = ta.grid_catalogue(x, y, z, w=w, device=CPU, **lim, **bins)
    want, wbins = ja.grid_catalogue(x, y, z, w=w, **lim, **bins)
    want = np.asarray(want)
    assert got.dtype == torch.from_numpy(want).dtype
    assert np.array_equal(got.numpy(), want)
    for a, b in zip(gbins, wbins):
        assert np.array_equal(a, b)
    rng_ = [limits or (float(a.min()), float(a.max())) for a in (x, y, z)]
    hist, _ = np.histogramdd(np.vstack([x, y, z]).T.astype(np.float64),
                             bins=(5, 6, 7), range=rng_, weights=w)
    if weighted:
        eps = np.finfo(dtype).eps * 3000
        assert np.abs(got.numpy() - hist).max() <= eps * np.abs(hist).max()
    else:
        assert np.array_equal(got.numpy(), hist)


def test_grid_catalogue_on_tensors_stays_on_their_device(rng):
    (x, y, z), _ = catalogue(rng, 500, np.float64)
    got, _ = ta.grid_catalogue(*(torch.as_tensor(a) for a in (x, y, z)),
                               nx=4, ny=4, nz=4)
    assert got.device.type == "cpu"
    assert int(got.sum()) == 500      # limits from the data: every point in
    with pytest.raises(ValueError):
        ta.grid_catalogue(x, y, z, nx=4, ny=4, device=CPU)


# ----------------------------------------------------------------------
# Voids
# ----------------------------------------------------------------------
def two_void_field():
    """tests/test_analysis.py's two Gaussian depressions in a flat field."""
    n = 24
    xx, yy, zz = np.meshgrid(*(np.arange(n),) * 3, indexing="ij")
    f = np.zeros((n, n, n))
    for cx, cy, cz in [(6, 6, 6), (17, 17, 17)]:
        r2 = (xx - cx) ** 2 + (yy - cy) ** 2 + (zz - cz) ** 2
        f -= np.exp(-r2 / 18.0)
    return f


def smooth_field(seed, n=20, passes=2, dtype=np.float64):
    f = np.random.default_rng(seed).normal(size=(n, n, n))
    for _ in range(passes):
        for ax in range(3):
            f = (f + np.roll(f, 1, ax) + np.roll(f, -1, ax)) / 3.0
    return f.astype(dtype)


def count_field(seed, n=16):
    """An integer count field from grid_catalogue: many equal values."""
    rng = np.random.default_rng(seed)
    (x, y, z), _ = catalogue(rng, 3 * n**3, np.float64)
    grid, _ = ja.grid_catalogue(x, y, z, nx=n, ny=n, nz=n, xlim=(0.0, 1.0),
                                ylim=(0.0, 1.0), zlim=(0.0, 1.0))
    return np.asarray(grid)


FIELDS = {
    "two_voids": two_void_field,
    "smooth_f64": lambda: smooth_field(5),
    "smooth_f32": lambda: smooth_field(5, dtype=np.float32),
    "counts": lambda: count_field(9),
}


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_watershed_labels_equal_fastbox_tpu(name):
    f = FIELDS[name]()
    for thr in (np.inf, 0.0):
        mask = ~(f > thr)
        want = ja.watershed_labels(f, mask)
        got = ta.watershed_labels(torch.as_tensor(f), torch.as_tensor(mask))
        assert got.dtype == torch.int64
        assert np.array_equal(got.numpy(), want)
    assert want.max() > 1


def test_descent_ties_take_the_first_neighbour():
    """Plateaus: a voxel points to the first strictly lowest neighbour in
    the order axis 0, 1, 2 (roll +1, then -1), and to itself on a tie with
    its own value; a NaN neighbour makes a voxel its own root."""
    f = np.zeros((5, 4, 3))
    f[2, 1, 1] = -1.0
    f[3, 2, 1] = -1.0
    f[0, 0, 0] = np.nan
    for mask in (np.ones(f.shape, bool), f < 0.5):
        want = np.asarray(jdescent(jnp.asarray(f), jnp.asarray(mask)))
        got = tdescent(torch.as_tensor(f), torch.as_tensor(mask)).numpy()
        assert np.array_equal(got, want)


@pytest.mark.parametrize("name", sorted(FIELDS))
@pytest.mark.parametrize("markers", ["none", "int", "array"])
@pytest.mark.parametrize("merge", [0.0, 0.05])
def test_apply_watershed_equal_fastbox_tpu(name, markers, merge):
    f = FIELDS[name]()
    thr = -0.05 if name == "two_voids" else 0.0
    if markers == "none":
        mk = None
    elif markers == "int":
        mk = 27
    else:
        mk = np.zeros(f.shape, np.int64)
        pts = np.random.default_rng(4).integers(0, f.shape[0], (12, 3))
        mk[tuple(pts.T)] = np.arange(1, 13)
        n = f.shape[0]
        mk[(n // 4,) * 3], mk[(3 * n // 4,) * 3] = 13, 14   # two minima
    kw = dict(markers=mk, mask_threshold=thr, merge_threshold=merge,
              verbose=False)
    want = ja.apply_watershed(f, **kw)
    got = ta.apply_watershed(torch.as_tensor(f), **kw)
    assert isinstance(got, np.ndarray)
    assert np.array_equal(got, want)
    assert np.array_equal(ta.apply_watershed(f, device=CPU, **kw), want)
    assert want.max() >= 1
    if merge == 0.0:
        assert len(np.unique(want)) > 2     # unmerged: several regions


def test_apply_watershed_normalises_on_numpy_mean():
    """A float32 count field: the mean is numpy's and the division one
    float32 operation, so f / mean - 1 equals numpy's bit for bit."""
    f = count_field(3).astype(np.float32) + np.float32(0.1)
    got = ta.apply_watershed(torch.as_tensor(f), merge_threshold=0.2,
                             verbose=False)
    want = ja.apply_watershed(f, merge_threshold=0.2, verbose=False)
    assert np.array_equal(got, want)


def test_watershed_finds_two_voids_verbose(capsys):
    f = two_void_field()
    labels = ta.apply_watershed(f, mask_threshold=-0.05,
                                merge_threshold=0.05, device=CPU)
    out = capsys.readouterr().out
    assert "Running watershed algorithm" in out and "No. regions" in out
    assert labels[6, 6, 6] != labels[17, 17, 17]
    assert labels[6, 6, 6] > 0 and labels[17, 17, 17] > 0
    assert 0 in np.unique(labels)


@pytest.fixture(scope="module")
def void_case():
    f = two_void_field()
    labels = ja.apply_watershed(f, mask_threshold=-0.05,
                                merge_threshold=0.05, verbose=False)
    cat = ja.trim_by_volume(labels, nmin=10, nmax=10**6)
    cat = cat[cat > 0]
    jbox = JaxBox(cosmo=default_cosmo, box_scale=(1e2,) * 3, nsamp=24,
                  realise_now=False)
    tbox = CosmoBox(cosmo=default_cosmo, box_scale=(1e2,) * 3, nsamp=24,
                    realise_now=False, device=CPU)
    return f, labels, cat, jbox, tbox


def test_trim_by_volume_equal(void_case):
    f, labels, cat, _, _ = void_case
    got = ta.trim_by_volume(torch.as_tensor(labels), nmin=10, nmax=10**6)
    assert np.array_equal(got[got > 0], cat)
    assert cat.size >= 2


@pytest.mark.parametrize("kind", ["uniform", "density", "minimum"])
def test_void_centroid_equal(void_case, kind):
    f, labels, cat, jbox, tbox = void_case
    want = ja.void_centroid(cat, labels, jbox, field=f, kind=kind)
    got = ta.void_centroid(cat, torch.as_tensor(labels), tbox,
                           field=torch.as_tensor(f), kind=kind)
    assert set(got) == set(want)
    for lbl in want:
        assert frac_err(got[lbl], want[lbl]) <= 1e-12


def test_void_radii_and_stack_equal(void_case):
    f, labels, cat, jbox, tbox = void_case
    want = ja.void_radii(cat, labels, jbox)
    got = ta.void_radii(cat, labels, tbox)
    assert set(got) == set(want)
    for lbl in want:
        assert abs(got[lbl] - want[lbl]) <= 1e-12 * want[lbl]
    ws, wf = ja.stack_voids(cat, labels, jbox, f, grid_pix=9)
    gs, gf = ta.stack_voids(cat, labels, tbox, torch.as_tensor(f),
                            grid_pix=9)
    assert gf == wf
    assert np.array_equal(np.ma.getmaskarray(gs), np.ma.getmaskarray(ws))
    assert frac_err(gs.filled(np.nan), ws.filled(np.nan)) <= 1e-12
    with pytest.raises(ValueError):
        ta.void_centroid(cat, labels, tbox, field=f, kind="bogus")


# ----------------------------------------------------------------------
# Inpainting
# ----------------------------------------------------------------------
def gcr_case(rng, npix=5, nfreq=24):
    freqs = np.linspace(100.0, 124.0, nfreq)
    S = np.asarray(ja.simple_signal_cov(freqs, 1.0, 6.0))
    L = np.linalg.cholesky(S + 1e-8 * np.eye(nfreq))
    signal = (L @ rng.standard_normal((nfreq, npix))).T
    # correlated noise, so (w N^-1 w)^1/2 is not diagonal
    a = 0.3 * rng.standard_normal((nfreq, nfreq))
    N = 1e-3 * (np.eye(nfreq) + a @ a.T / nfreq)
    d = signal + rng.multivariate_normal(np.zeros(nfreq), N, npix)
    w = (rng.random((npix, nfreq)) > 0.1).astype(float)
    w[:, 8:12] = 0.0
    return freqs, S, N, d, w


def jax_omegas(key, realisations, npix, nfreq):
    """fastbox_tpu's draws (inpaint.py:88-93), rebuilt for supplying."""
    keys = jax.random.split(key, realisations)
    oN, oS = [], []
    for i in range(realisations):
        kN, kS = jax.random.split(keys[i])
        oN.append(jax.random.normal(kN, (npix, nfreq), dtype=jnp.float64))
        oS.append(jax.random.normal(kS, (npix, nfreq), dtype=jnp.float64))
    return np.stack(oN), np.stack(oS)


def test_simple_signal_cov_and_psd_sqrt(rng):
    freqs = np.linspace(100.0, 130.0, 16)
    want = np.asarray(ja.simple_signal_cov(freqs, 2.0, 5.0, ridge_var=1e-6))
    got = ta.simple_signal_cov(freqs, 2.0, 5.0, ridge_var=1e-6, device=CPU)
    assert got.dtype == torch.float64
    assert frac_err(got.numpy(), want) <= 1e-14
    M = np.stack([want, want * 3.0 + np.eye(16)])
    got = tsqrt(torch.as_tensor(M)).numpy()
    for i in range(2):
        assert frac_err(got[i], np.asarray(jsqrt(jnp.asarray(M[i])))) <= 1e-12
        assert frac_err(got[i] @ got[i], M[i]) <= 1e-10


@pytest.mark.parametrize("add_noise", [True, False])
@pytest.mark.parametrize("cg_tol,bound", [(1e-12, 1e-8), (1e-8, 1e-5)])
def test_gaussian_cr_1d_on_fastbox_tpu_normals(rng, add_noise, cg_tol, bound):
    freqs, S, N, d, w = gcr_case(rng)
    R = 3
    key = jax.random.PRNGKey(5)
    want = np.asarray(ja.gaussian_cr_1d(d, w, S, N, realisations=R,
                                        add_noise=add_noise, key=key,
                                        cg_tol=cg_tol))
    got = ta.gaussian_cr_1d(d, w, S, N, realisations=R, add_noise=add_noise,
                            omegas=jax_omegas(key, R, *d.shape),
                            cg_tol=cg_tol, device=CPU)
    assert got.shape == want.shape == (R,) + d.shape
    assert frac_err(got.numpy(), want) <= bound


def test_gcr_cg_maxiter_matches():
    """A CG cut at a few iterations stops every pixel where JAX's does."""
    freqs, S, N, d, w = gcr_case(np.random.default_rng(2))
    key = jax.random.PRNGKey(1)
    want = np.asarray(ja.gaussian_cr_1d(d, w, S, N, key=key, cg_maxiter=3))
    got = ta.gaussian_cr_1d(d, w, S, N, omegas=jax_omegas(key, 1, *d.shape),
                            cg_maxiter=3, device=CPU)
    assert frac_err(got.numpy(), want) <= 1e-10


def test_gcr_inpaints_flagged_channels(rng):
    """tests/test_analysis.py's check, drawing from a torch.Generator."""
    nfreq, npix = 32, 3
    freqs = np.linspace(100.0, 132.0, nfreq)
    S = ta.simple_signal_cov(freqs, 1.0, 8.0, device=CPU).numpy()
    L = np.linalg.cholesky(S + 1e-8 * np.eye(nfreq))
    signal = (L @ rng.standard_normal((nfreq, npix))).T
    noise_var = 1e-4
    N = noise_var * np.eye(nfreq)
    d = signal + np.sqrt(noise_var) * rng.standard_normal((npix, nfreq))
    w = np.ones((npix, nfreq))
    w[:, 12:17] = 0.0

    gen = torch.Generator().manual_seed(0)
    sol = ta.gaussian_cr_1d(d, w, S, N, realisations=4, add_noise=False,
                            generator=gen, device=CPU).numpy()
    assert sol.shape == (4, npix, nfreq)
    err = np.abs(sol.mean(axis=0)[:, 12:17] - signal[:, 12:17])
    assert np.median(err) < 0.5
    again = ta.gaussian_cr_1d(d, w, S, N, realisations=4, add_noise=False,
                              generator=torch.Generator().manual_seed(0),
                              device=CPU).numpy()
    assert np.array_equal(sol, again)


def test_trim_flagged_channels():
    w = np.array([1.0, 0.0, 1.0, 1.0])
    x = np.arange(4.0)
    M = np.arange(16.0).reshape(4, 4)
    for a in (x, M):
        assert np.array_equal(ta.trim_flagged_channels(w, a),
                              ja.trim_flagged_channels(w, a))
    with pytest.raises(ValueError):
        ta.trim_flagged_channels(w, np.arange(3.0))


def lssa_case(rng, nfreq=48):
    freqs = np.linspace(100.0, 147.0, nfreq)
    tau = np.fft.fftfreq(nfreq, d=freqs[1] - freqs[0]) * 1e3
    d = (rng.standard_normal(nfreq) + 1j * rng.standard_normal(nfreq)
         + (2.0 - 1.0j) * np.exp(2.0j * np.pi * (tau[5] / 1e3) * freqs))
    w = (rng.random(nfreq) > 0.2).astype(float)
    invcov = np.diag(w) + 0.01 * np.eye(nfreq)
    taper = np.hanning(nfreq) + 0.1
    return freqs, tau, d, w, invcov, taper


@pytest.mark.parametrize("amp_phase", [True, False])
@pytest.mark.parametrize("defaults", [True, False])
def test_lssa_fit_modes_equal(rng, amp_phase, defaults):
    freqs, tau, d, w, invcov, taper = lssa_case(rng)
    kw = (dict() if defaults else dict(tau=tau, taper=taper))
    want = ja.lssa_fit_modes(jnp.asarray(d), jnp.asarray(freqs / 1e3),
                             invcov=jnp.asarray(invcov),
                             fit_amp_phase=amp_phase, **kw)
    got = ta.lssa_fit_modes(d, freqs / 1e3, invcov=invcov,
                            fit_amp_phase=amp_phase, device=CPU, **kw)
    for g, wnt in zip(got, want):
        assert frac_err(g.numpy(), np.asarray(wnt)) <= 1e-12


def test_lssa_recovers_single_mode_and_pspec(rng):
    freqs, tau, d, w, invcov, taper = lssa_case(rng)
    d = (2.0 + 1.0j) * np.exp(2.0j * np.pi * (tau[5] / 1e3) * freqs)
    tau_t, A_re, A_im = ta.lssa_fit_modes(
        torch.as_tensor(d), torch.as_tensor(freqs / 1e3),
        invcov=torch.eye(freqs.size, dtype=torch.float64),
        fit_amp_phase=False, tau=torch.as_tensor(tau))
    assert abs(float(A_re[5]) - 2.0) < 1e-6
    assert abs(float(A_im[5]) - 1.0) < 1e-6
    got = ta.lssa_pspec(A_re, A_im, w, tau, freqs)
    want = np.asarray(ja.lssa_pspec(jnp.asarray(A_re.numpy()),
                                    jnp.asarray(A_im.numpy()), w, tau, freqs))
    assert frac_err(got.numpy(), want) <= 1e-12
    assert int(torch.argmax(got)) == 5


@pytest.mark.parametrize("tau", [50.0, -120.0, 0.0])
def test_lssa_decorr_matrix_equal(tau):
    w = np.ones(32)
    w[5:9] = 0.0
    freqs = np.linspace(100.0, 131.0, 32)
    rot, eig = ta.lssa_decorr_matrix(w, tau, freqs, device=CPU)
    jrot, jeig = ja.lssa_decorr_matrix(w, tau, freqs)
    assert frac_err(rot.numpy(), np.asarray(jrot)) <= 1e-12
    assert frac_err(eig.numpy(), np.asarray(jeig)) <= 1e-12
    assert np.allclose(rot.numpy() @ rot.numpy().T, np.eye(2), atol=1e-12)


# ----------------------------------------------------------------------
# Forecasts
# ----------------------------------------------------------------------
def rel(got, want) -> float:
    """Largest relative difference over finite values; infinities (a beam
    factor that underflows) must match."""
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape
    fin = np.isfinite(want)
    assert np.array_equal(got[~fin], want[~fin])
    return float(np.max(np.abs(got[fin] - want[fin]) / np.abs(want[fin])))


def test_forecast_scalars_equal():
    jf, tf = ja.forecast, ta.forecast
    for expt in ("inst_meerkatuhf", "inst_gbt", "inst_hirax"):
        assert getattr(tf, expt) == getattr(jf, expt)
        assert rel(tf.sigmaT(getattr(tf, expt)),
                   jf.sigmaT(getattr(jf, expt))) <= 1e-10
    z = np.linspace(0.1, 2.0, 7)
    for name in ("Tb", "bias_HI", "bias_gal"):
        assert rel(getattr(tf, name)(z), getattr(jf, name)(z)) <= 1e-10
    assert rel(tf.lmax_for_redshift(default_cosmo, z, kmax0=0.14),
               jf.lmax_for_redshift(default_cosmo, z, kmax0=0.14)) <= 1e-10
    assert rel(tf.lmin_for_redshift(default_cosmo, 0.8, 6.0),
               jf.lmin_for_redshift(default_cosmo, 0.8, 6.0)) <= 1e-10
    for deg in (False, True):
        got, want = (f.number_density_to_area_density(
            default_cosmo, 1e-3, 0.7, 0.9, degrees=deg) for f in (tf, jf))
        assert rel(got, want) <= 1e-10


@pytest.mark.parametrize("expt", ["inst_meerkatuhf", "inst_hirax"])
@pytest.mark.parametrize("cutoff", [False, True])
def test_noise_im_equal(expt, cutoff):
    jf, tf = ja.forecast, ta.forecast
    ells = np.arange(10.0, 2000.0, 40.0)
    zmin, zmax = np.array([0.5, 0.7, 0.9]), np.array([0.7, 0.9, 1.1])
    got = tf.noise_im(default_cosmo, getattr(tf, expt), ells, zmin, zmax,
                      kmax_cutoff=cutoff)
    want = jf.noise_im(default_cosmo, getattr(jf, expt), ells, zmin, zmax,
                       kmax_cutoff=cutoff)
    assert np.array_equal(got == tf.INF_NOISE, want == jf.INF_NOISE)
    assert rel(got, want) <= 1e-10
    if cutoff or expt == "inst_hirax":
        assert np.any(got == tf.INF_NOISE)


def test_forecast_pipeline_equal():
    """tests/test_analysis.py's sequence on both packages."""
    jf, tf = ja.forecast, ta.forecast
    ells = np.arange(10, 300, 10).astype(float)
    out = {}
    for f in (jf, tf):
        t_gal = f.tracer_spectro(default_cosmo, 0.7, 0.9, "galaxy")
        t_im = f.TracerSpectro(default_cosmo, 0.7, 0.9, kind="im")
        cl = [f.angular_cl(default_cosmo, a, b, ells) for a, b in
              ((t_gal, t_gal), (t_im, t_im), (t_gal, t_im))]
        Nell = f.noise_im(default_cosmo, f.inst_meerkatuhf, ells, 0.7, 0.9)
        shot = 1.0 / f.number_density_to_area_density(default_cosmo, 1e-3,
                                                       0.7, 0.9)
        F = f.fisher_bandpowers(ells, 10.0, 0.1, *cl, shot, Nell[:, 0])
        zs = np.linspace(0.5, 1.2, 9)
        out[f] = cl + [Nell, F] + list(t_gal.kernel(zs)) + list(
            t_im.kernel(zs))
    for g, wnt in zip(out[tf], out[jf]):
        assert rel(np.where(wnt == 0, 1.0, g), np.where(wnt == 0, 1.0, wnt)) \
            <= 1e-10
    cl_gal, cl_im, cl_x = out[tf][:3]
    assert np.all(cl_x**2 <= cl_gal * cl_im * (1.0 + 1e-8))
    assert np.all(out[tf][4] > 0)


# ----------------------------------------------------------------------
# timing.stage / Timings and Cosmology.H / pk
# ----------------------------------------------------------------------
def stage_lines(mod, capsys, sync):
    timings = mod.Timings()
    with mod.stage("(1) Realise", timings=timings) as s:
        s["sync"] = sync
    with mod.stage("(2) Quiet", verbose=False, timings=timings, sync=sync):
        pass
    out = capsys.readouterr().out
    return re.sub(r"\d+\.\d+", "#", out), re.sub(r"\d+\.\d+", "#",
                                                  timings.report()), timings


def test_stage_prints_and_fills_timings_as_fastbox_tpu(capsys):
    sync = [torch.ones(3), {"a": torch.zeros(2), "b": (torch.ones(1),)}]
    got = stage_lines(ttiming, capsys, sync)
    want = stage_lines(jtiming, capsys, [jnp.ones(3)])
    assert got[:2] == want[:2]
    assert got[0] == "(1) Realise...\n\t(1) Realise complete (# sec)\n"
    assert [n for n, _ in got[2].records] == ["(1) Realise", "(2) Quiet"]
    assert all(dt >= 0.0 for _, dt in got[2].records)


def test_stage_names_the_block_in_the_profiler():
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with ttiming.stage("analysis-stage", verbose=False,
                           sync=torch.ones(2)):
            torch.ones(4).sum()
    assert "analysis-stage" in {e.key for e in prof.key_averages()}


@pytest.mark.parametrize("z", [0.0, 0.8])
def test_cosmology_H_and_pk_equal(z):
    k = np.logspace(-3, 1, 25)
    jc = jbuild(default_cosmo, redshift=z)
    tc = tbuild(default_cosmo, redshift=z, device=CPU)
    assert rel(tc.H, jc.H) <= 1e-12
    for linear in (False, True):
        got = tc.pk(torch.as_tensor(k), linear=linear).numpy()
        want = np.asarray(jc.pk(jnp.asarray(k), linear=linear))
        assert rel(got, want) <= 1e-12
