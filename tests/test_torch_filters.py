"""The port's foreground cleaners (``filters/``) against fastbox_tpu's, on the
CPU.

In float64, on the same cubes (tests/test_filters.py's foreground-dominated
mock), each cleaned cube agrees with fastbox_tpu's to a stated fraction of
its largest value: 1e-12 for the mean-spectrum and bandpass filters, 1e-10
for band-power PCA, NMF's initialisation and the closed-form GPR, 1e-9 for
ICA (whose rotation W differs between the packages: the cleaned cube does
not depend on it), NMF after its multiplicative updates, the linear and RBF
kernel PCA and the Adam-fitted GPR from fastbox_tpu's own starting points,
and 1e-6 for the cubic kernel PCA (measured: 2.7e-8, the cube of a kernel
~1e4).  A float32 cube is cleaned in float64 and rounded once, so its
result equals the float64 clean of the same values rounded, bit for bit.
Where fastbox_tpu's linear algebra returns non-finite values (a singular
solve or inverse, a Cholesky of a matrix that is not positive definite),
the port returns NaNs rather than raising.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastbox_tpu.filters as jf
import fastbox_tpu_torch.filters as tf
from fastbox_tpu.box import CosmoBox as JaxBox
from fastbox_tpu_torch.box import CosmoBox, default_cosmo

T = torch.as_tensor


def module(name):
    """A filters submodule (the package's ``nmf`` is the function)."""
    return sys.modules[name]


jnmf, tnmf = module("fastbox_tpu.filters.nmf"), module(
    "fastbox_tpu_torch.filters.nmf")
jgpr, tgpr = module("fastbox_tpu.filters.gpr"), module(
    "fastbox_tpu_torch.filters.gpr")


def mock_cube(rng, n=12, nfreq=16):
    """FG-dominated cube: smooth power-law spectra + small noise
    (tests/test_filters.py:11-18)."""
    freqs = np.linspace(100.0, 150.0, nfreq)
    amp = 50.0 + 10.0 * rng.standard_normal((n, n))
    beta = -2.7 + 0.01 * rng.standard_normal((n, n))
    fg = amp[:, :, None] * (freqs / freqs[0])[None, None, :] ** beta[:, :, None]
    return fg + 0.1 * rng.standard_normal((n, n, nfreq))


def close(got, want, frac):
    """|got - want| <= frac * max|want| everywhere."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= frac, err


def f32_is_rounded_f64(fn, cube, **kw):
    """``fn`` of a float32 cube is ``fn`` of the same values in float64,
    rounded once."""
    c32 = T(cube).float()
    got = fn(c32, **kw)
    assert got.dtype == torch.float32
    assert torch.equal(got, fn(c32.double(), **kw).float())


def test_mean_spectrum_filter(rng):
    cube = mock_cube(rng)
    got = tf.mean_spectrum_filter(T(cube))
    close(got, jf.mean_spectrum_filter(jnp.asarray(cube)), 1e-12)
    assert got.reshape(-1, 16).mean(0).abs().max() < 1e-10
    f32_is_rounded_f64(tf.mean_spectrum_filter, cube)


def test_angular_bandpass_filter(rng):
    cube = rng.standard_normal((16, 12, 4))
    for kmin, kmax, d in ((0.1, 0.3, 1.0), (0.0, 0.2, 2.0)):
        got = tf.angular_bandpass_filter(T(cube), kmin, kmax, d=d)
        assert got.dtype == torch.complex128
        close(got, jf.angular_bandpass_filter(jnp.asarray(cube), kmin, kmax,
                                              d=d), 1e-12)
    got = tf.angular_bandpass_filter(T(cube).float(), 0.1, 0.3)
    assert got.dtype == torch.complex64
    close(got, jf.angular_bandpass_filter(jnp.asarray(cube, jnp.float32),
                                          0.1, 0.3), 1e-6)
    np.testing.assert_array_equal(
        module("fastbox_tpu_torch.filters.bandpass")._kperp_fftfreq(16, 12, 1.5),
        module("fastbox_tpu.filters.bandpass")._kperp_fftfreq(16, 12, 1.5))


@pytest.mark.parametrize("modes", (2, [3, 1, 2]))
def test_bandpower_pca_filter(rng, modes):
    cube = mock_cube(rng)
    got = tf.bandpower_pca_filter(T(cube), 3, modes)
    close(got, jf.bandpower_pca_filter(jnp.asarray(cube), 3, modes), 1e-10)
    f32_is_rounded_f64(tf.bandpower_pca_filter, cube, nbands=3, modes=modes)
    with pytest.raises(ValueError):
        tf.bandpower_pca_filter(T(cube), 2, [1, 2, 3])


def test_bandpower_drops_the_corner_modes(rng):
    """With no modes removed the bands sum to the mean-free cube without
    its |k_perp| = max k corner modes: the last band is half-open."""
    cube = mock_cube(rng, n=8)
    got = tf.bandpower_pca_filter(T(cube), 3, 0)
    x = np.asarray(tf.mean_spectrum_filter(T(cube)))
    kx = np.fft.fftfreq(8)
    k = np.sqrt(kx[:, None] ** 2 + kx[None, :] ** 2)
    fk = np.fft.fftn(x, axes=(0, 1))
    fk[k >= k.max()] = 0.0
    close(got, np.fft.ifftn(fk, axes=(0, 1)).real, 1e-12)
    close(got, jf.bandpower_pca_filter(jnp.asarray(cube), 3, 0), 1e-12)


def test_ica_filter(rng):
    """From fastbox_tpu's starting matrix, and from the port's generator:
    the cleaned cube is fastbox_tpu's and the PCA clean's
    (tests/test_filters.py:62-70)."""
    cube = mock_cube(rng)
    want = jf.ica_filter(jnp.asarray(cube), 3, key=jax.random.PRNGKey(0))
    w0 = np.array(jax.random.normal(jax.random.PRNGKey(0), (3, 3)))
    close(tf.ica_filter(T(cube), 3, w0=T(w0)), want, 1e-9)
    got = tf.ica_filter(T(cube), 3)
    close(got, want, 1e-9)
    close(got, tf.pca_filter(T(cube), 3), 1e-9)
    cleaned, (WK, mixing, sources) = tf.ica_filter(T(cube), 3,
                                                   return_filter=True)
    assert WK.shape == (3, 16) and mixing.shape == (16, 3)
    assert sources.shape == (3, 144)
    f32_is_rounded_f64(tf.ica_filter, cube, nmodes=3)


def test_fastica_unmixes_known_sources(rng):
    """tests/test_filters.py:245-267 on the port: 3 independent
    non-Gaussian sources recovered from a random mixture, up to
    permutation and sign."""
    nsamp = 4000
    s1 = np.sign(rng.standard_normal(nsamp))
    s2 = rng.uniform(-np.sqrt(3), np.sqrt(3), nsamp)
    s3 = rng.laplace(0.0, 1.0 / np.sqrt(2.0), nsamp)
    S = np.stack([s1, s2, s3])
    A = rng.standard_normal((3, 3)) + 3.0 * np.eye(3)
    X = T(A @ S)
    W, K, mean = tf.fastica(X, torch.Generator().manual_seed(3),
                            n_components=3, max_iter=500)
    rec = ((W @ K) @ (X - mean)).numpy()
    C = np.corrcoef(np.vstack([rec, S]))[:3, 3:]
    assert (np.abs(C).max(axis=0) > 0.95).all(), C
    assert sorted(np.abs(C).argmax(axis=1)) == [0, 1, 2], C


def test_nmf_filter(rng):
    """NNDSVDa and the multiplicative updates (measured: 3.6e-15 for the
    initialisation, 2.1e-13 after 50-300 updates)."""
    cube = mock_cube(rng)
    x = cube.reshape(-1, 16).T
    for a, b in zip(tnmf._nndsvda_init(T(x), 3),
                    jnmf._nndsvda_init(jnp.asarray(x), 3)):
        close(a, b, 1e-10)
    for it in (0, 200):
        close(tf.nmf_filter(T(cube), 3, max_iter=it),
              jf.nmf_filter(jnp.asarray(cube), 3, max_iter=it), 1e-9)
    cleaned, (W, H) = tf.nmf_filter(T(cube), 3, return_filter=True,
                                    max_iter=300)
    assert (W >= 0).all() and (H >= 0).all()
    assert cleaned.pow(2).mean().sqrt() < 0.05 * T(cube).pow(2).mean().sqrt()
    f32_is_rounded_f64(tf.nmf_filter, cube, nmodes=3)


def test_nndsvda_sign_invariance(monkeypatch):
    """A joint sign flip of a singular pair leaves NNDSVDa unchanged."""
    rng = np.random.default_rng(5)
    X = T(np.abs(rng.standard_normal((6, 9))) + 0.1)
    U, S, Vt = torch.linalg.svd(X, full_matrices=False)
    flip = torch.tensor([1.0, -1.0, 1.0, -1.0, -1.0, 1.0], dtype=X.dtype)
    W, H = tnmf._nndsvda_init(X, 4)
    monkeypatch.setattr(torch.linalg, "svd", lambda A, full_matrices=False:
                        (U * flip, S, Vt * flip[:, None]))
    Wf, Hf = tnmf._nndsvda_init(X, 4)
    close(Wf, W, 1e-15)
    close(Hf, H, 1e-15)


@pytest.mark.parametrize("kw,frac", (({"kernel": "linear"}, 1e-9),
                                     ({"kernel": "rbf", "gamma": 0.3}, 1e-9),
                                     ({"kernel": "poly3", "gamma": 0.01}, 1e-6)))
def test_kernel_pca_filters(rng, kw, frac):
    cube = mock_cube(rng, n=8)
    close(tf.kernel_pca_filter_legacy(T(cube), 3, **kw),
          jf.kernel_pca_filter_legacy(jnp.asarray(cube), 3, **kw), frac)
    close(tf.kernel_pca_filter(T(cube), 3, **kw),
          jf.kernel_pca_filter(jnp.asarray(cube), 3, **kw), frac)
    for fn in (tf.kernel_pca_filter, tf.kernel_pca_filter_legacy):
        f32_is_rounded_f64(fn, cube, nmodes=3, **kw)


def test_kernel_pca_pieces(rng):
    kp = module("fastbox_tpu_torch.filters.kpca")
    jk = module("fastbox_tpu.filters.kpca")
    X = rng.standard_normal((10, 4))
    for kind in ("linear", "rbf", "poly3"):
        close(kp._kernel(T(X), T(X[:6]), kind, 0.2),
              jk._kernel(jnp.asarray(X), jnp.asarray(X[:6]), kind, 0.2),
              1e-13)
    with pytest.raises(ValueError, match="Unknown kernel"):
        kp._kernel(T(X), T(X), "cosine", 1.0)
    proj_t, dual_t = kp._kpca_fit(T(X), 2, "rbf", 0.2, 1.0)
    proj_j, dual_j = jk._kpca_fit(jnp.asarray(X), 2, "rbf", 0.2, 1.0)
    close(proj_t.abs(), np.abs(np.asarray(proj_j)), 1e-10)   # signs
    close(dual_t, dual_j, 1e-10)
    shape, x, Xs = kp._prepare(T(mock_cube(rng, n=4)))
    assert shape == (4, 4, 16) and x.shape == (16, 16)
    assert torch.equal(Xs, x.T)


def test_singular_systems_give_nan_not_errors():
    """fastbox_tpu's solve / inv / cholesky return non-finite values on a
    singular or indefinite matrix; the port's return NaNs, and raise
    nothing."""
    kp = module("fastbox_tpu_torch.filters.kpca")
    lsq = module("fastbox_tpu_torch.filters.lsq")
    A = np.array([[1.0, 2.0], [2.0, 4.0]])
    B = np.array([[1.0, 0.5], [3.0, 1.0]])
    assert not np.isfinite(np.asarray(jnp.linalg.solve(A, B))).any()
    assert torch.isnan(kp._solve(T(A), T(B))).all()
    good = np.array([[2.0, 1.0], [1.0, 3.0]])
    batch = np.stack([good, A])
    want = np.asarray(jnp.linalg.inv(batch))
    got = lsq._inv(T(batch))
    assert not np.isfinite(want[1]).any() and torch.isnan(got[1]).all()
    close(got[0], want[0], 1e-15)
    indef = np.array([[1.0, 2.0], [2.0, 1.0]])
    # fastbox_tpu: NaN on and below the diagonal
    assert np.isnan(np.tril(np.asarray(jnp.linalg.cholesky(indef)))).sum() == 3
    L, ok = tgpr._cholesky(T(np.stack([good, indef])))
    assert ok.tolist() == [True, False] and torch.isnan(L[1]).all()
    close(L[0], np.linalg.cholesky(good), 1e-15)


def lsq_data(rng, npix=32, nfreq=16):
    freqs = np.linspace(100.0, 200.0, nfreq)
    beta = -2.8 + 0.05 * rng.standard_normal(npix)
    amp = 40.0 + 5.0 * rng.random(npix)
    data = amp[:, None] * (freqs / freqs[0])[None, :] ** beta[:, None]
    return data + 0.01 * rng.standard_normal(data.shape), freqs


def test_lsq_synchrotron_fit(rng):
    data, freqs = lsq_data(rng)
    noise = 0.5 + rng.random(data.shape)
    got = tf.lsq_synchrotron_fit(T(data), T(noise), freqs, -2.1)
    want = jf.lsq_synchrotron_fit(jnp.asarray(data), jnp.asarray(noise),
                                  jnp.asarray(freqs), -2.1)
    for name in ("beta", "sync_amp", "ff_amp", "model"):
        close(got[name], want[name], 1e-10)
    resid = got["model"].numpy() - data
    assert np.sqrt(np.mean(resid**2)) < 0.05 * np.sqrt(np.mean(data**2))
    c32 = T(data).float()
    f32 = tf.lsq_synchrotron_fit(c32, T(noise), freqs, -2.1)
    f64 = tf.lsq_synchrotron_fit(c32.double(), T(noise), freqs, -2.1)
    for name in f32:
        assert torch.equal(f32[name], f64[name].float())


def test_lsq_fitting_on_a_box(rng):
    """run_fit and give_hest (the mean point-source temperature from
    PointSourceModel) on a box's cube.  The residual is ~1e-4 of the data,
    so its rounding is held to 1e-8 of its largest value (measured:
    1.2e-9); the spectral indices to 1e-10."""
    kw = dict(cosmo=default_cosmo, box_scale=(1e3,) * 3, nsamp=8,
              redshift=0.8, realise_now=False, seed=3)
    jb, tb = JaxBox(**kw), CosmoBox(dtype=torch.float64, device="cpu", **kw)
    freqs = tb.freq_array()
    amp = 400.0 + 40.0 * rng.random((8, 8))
    beta = -2.7 + 0.05 * rng.standard_normal((8, 8))
    cube = amp[:, :, None] * (freqs / freqs[0])[None, None, :] \
        ** beta[:, :, None] + 0.01 * rng.standard_normal((8, 8, 8))
    res_t, b_t = tf.LSQfitting(tb).give_hest(T(cube), -2.1, -2.7, 0.1, 0.1)
    res_j, b_j = jf.LSQfitting(jb).give_hest(jnp.asarray(cube), -2.1, -2.7,
                                             0.1, 0.1)
    assert res_t.shape == (8, 8, 8) and b_t.shape == (8, 8)
    close(res_t, res_j, 1e-8)
    close(b_t, b_j, 1e-10)
    tpsmean = np.linspace(1.0, 2.0, 8).reshape(8, 1)
    noise = 1.0 + rng.random((64, 8))
    r_t, s_t = tf.LSQfitting(tb).run_fit(T(cube), freqs, 64, tpsmean, -2.1,
                                         noise=T(noise))
    r_j, s_j = jf.LSQfitting(jb).run_fit(jnp.asarray(cube), freqs, 64,
                                         tpsmean, -2.1,
                                         noise=jnp.asarray(noise))
    close(r_t, r_j, 1e-8)
    close(s_t, s_j, 1e-10)


def test_gpr_closed_form(rng):
    """Fixed hyperparameters: exact linear algebra, against fastbox_tpu
    and an independent numpy posterior mean
    (tests/test_filters.py:199-242)."""
    n, nfreq = 5, 20
    cube = mock_cube(rng, n=n, nfreq=nfreq)
    fixed = [2.5, 0.4, 1e-3, 5e-3, 1e-2]
    for kinds in (("rbf", "exponential"), ("matern32", "matern52")):
        specs_t = [tf.KernelSpec(kinds[0], (1e-8, 1e8)),
                   tf.KernelSpec(kinds[1], (1e-8, 1e8), (1e-6, 1e2))]
        specs_j = [jf.KernelSpec(kinds[0], (1e-8, 1e8)),
                   jf.KernelSpec(kinds[1], (1e-8, 1e8), (1e-6, 1e2))]
        got, params = tf.gpr_filter(T(cube), kernels=specs_t,
                                    fixed_params=fixed, return_filter=True)
        want, params_j = jf.gpr_filter(jnp.asarray(cube), kernels=specs_j,
                                       fixed_params=fixed, return_filter=True)
        assert params == params_j
        close(got, want, 1e-10)
    d = cube.reshape(-1, nfreq).T
    x = d - d.mean(axis=1, keepdims=True)
    nu = np.linspace(0.0, 1.0, nfreq)
    dist = np.abs(nu[:, None] - nu[None, :])
    K_fg = 2.5 * np.exp(-0.5 * (dist / 0.4) ** 2)
    K_tot = K_fg + 1e-3 * np.exp(-dist / 5e-3) + 1e-2 * np.eye(nfreq)
    want = (x - K_fg @ np.linalg.solve(K_tot, x)).T.reshape(cube.shape)
    got = tf.gpr_filter(T(cube), kernels=specs_t[:0] + [
        tf.KernelSpec("rbf", (1e-8, 1e8)),
        tf.KernelSpec("exponential", (1e-8, 1e8), (1e-6, 1e2))],
        fixed_params=fixed)
    close(got, want, 1e-10)
    with pytest.raises(ValueError):
        tf.gpr_filter(T(cube), kernels=specs_t, fixed_params=[1.0, 2.0])
    with pytest.raises(TypeError):
        tf.gpr_filter(T(cube), kernels=["rbf"])
    for kind in ("white", "bias", "rbf"):
        nu_t = torch.linspace(0.0, 1.0, 7, dtype=torch.float64)
        close(tgpr._kern_matrix(kind, nu_t, 0.7, 0.3),
              jgpr._kern_matrix(kind, jnp.linspace(0.0, 1.0, 7), 0.7, 0.3),
              1e-14)
    with pytest.raises(ValueError, match="Unknown GPR kernel"):
        tgpr._kern_matrix("cosine", nu_t, 1.0, 1.0)


@pytest.mark.parametrize("restarts", (0, 2))
def test_gpr_fitted_from_fastbox_tpu_starts(rng, restarts):
    """Adam from fastbox_tpu's starting points (zeros, then its
    PRNGKey(0) uniforms, given as ``starts=``): the same hyperparameters
    and cleaned cube (measured 7e-12)."""
    cube = mock_cube(rng, n=6, nfreq=24)
    starts = np.array(jax.random.uniform(
        jax.random.PRNGKey(0), (restarts, 5), jnp.float64, minval=-3.0,
        maxval=3.0)) if restarts else None
    got, p_t = tf.gpr_filter(T(cube), nsteps=200, opt_num_restarts=restarts,
                             starts=None if starts is None else T(starts),
                             return_filter=True)
    want, p_j = jf.gpr_filter(jnp.asarray(cube), nsteps=200,
                              opt_num_restarts=restarts, return_filter=True)
    close(got, want, 1e-9)
    assert set(p_t) == set(p_j)
    for k in p_t:
        assert abs(p_t[k] - p_j[k]) <= 1e-9 * abs(p_j[k]), k
    d = cube.reshape(-1, 24).T
    x = d - d.mean(axis=1, keepdims=True)
    assert got.pow(2).mean().sqrt() < 0.5 * np.sqrt(np.mean(x**2))
    if restarts:
        with pytest.raises(ValueError, match="starts must be"):
            tf.gpr_filter(T(cube), nsteps=2, opt_num_restarts=restarts,
                          starts=T(starts[:1]))
        f32_is_rounded_f64(tf.gpr_filter, cube, nsteps=20,
                           opt_num_restarts=restarts)


def test_gpr_failed_starts_are_not_chosen(rng):
    """A start whose kernel matrix is not positive definite ends with a NaN
    loss and is passed over; when every start fails, fastbox_tpu and the
    port both end non-finite, and the port raises nothing."""
    cube = mock_cube(rng, n=4, nfreq=12)
    d = cube.reshape(-1, 12).T
    x = d - d.mean(axis=1, keepdims=True)
    bounds = [(1e8, 1e9), (1e-3, 1e2), (1e-40, 1e2)]   # bias, ls, noise
    # start 0 puts the noise at 1e-19 under a 3e8 constant kernel: its
    # Cholesky fails; start 1 (theta_noise = 20) has noise ~1e2
    theta, loss = tgpr._fit_gpr(T(x), T(bounds), ("bias",), nsteps=5,
                                nstarts=2, starts=T([[0.0, 0.0, 20.0]]))
    assert torch.isfinite(loss) and theta[2] > 10.0
    bad = [(1e8, 1e9), (1e-3, 1e2), (1e-40, 1e-30)]
    _, loss_t = tgpr._fit_gpr(T(x), T(bad), ("bias",), nsteps=5)
    _, loss_j = jgpr._fit_gpr(jnp.asarray(x), jnp.asarray(bad), ("bias",),
                              nsteps=5)
    assert not np.isfinite(float(loss_j)) and not torch.isfinite(loss_t)
    spec = [tf.KernelSpec("bias", (1e8, 1e9))]
    out = tf.gpr_filter(T(cube), kernels=spec, fixed_params=[5e8, 1.0,
                                                             1e-35])
    assert torch.isnan(out).all()
