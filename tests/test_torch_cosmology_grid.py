"""Cosmology tables, grid geometry, sqrt(P) and the P(k) bin plan of the
port against fastbox_tpu, in float64 on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastbox_tpu.cosmology import build_cosmology as jax_build_cosmology
from fastbox_tpu.grid import GridSpec as JaxGrid
from fastbox_tpu.ops import spectra as jax_spectra
from fastbox_tpu.ops.reduce import binned_weighted_dual as jax_bwd
from fastbox_tpu.pipeline import PipelineConfig as JaxConfig
from fastbox_tpu.pipeline import _build_pipeline
from fastbox_tpu_torch.cosmology import PowerSpectrumTable, build_cosmology
from fastbox_tpu_torch.grid import GridSpec
from fastbox_tpu_torch.ops import spectra
from fastbox_tpu_torch.pipeline import amp_half_table

COSMO = dict(Omega_c=0.25, Omega_b=0.05, h=0.7, n_s=0.95, sigma8=0.8)
Z = 0.8


@pytest.fixture(scope="module")
def cosmos():
    return (jax_build_cosmology(COSMO, redshift=Z),
            build_cosmology(COSMO, redshift=Z))


def test_tables_and_scalars_equal(cosmos):
    jc, tc = cosmos
    for name in ("Ea", "growth", "growth_rate", "chi", "scale_factor",
                 "redshift"):
        assert getattr(tc, name) == pytest.approx(getattr(jc, name),
                                                  rel=1e-12)
    assert tc.h == jc.h
    for t in ("pk_lin", "pk_nl", "pk_lin_z0"):
        np.testing.assert_allclose(getattr(tc, t).lnp.numpy(),
                                   np.asarray(getattr(jc, t).lnp), rtol=1e-12)
        np.testing.assert_allclose(getattr(tc, t).lnk.numpy(),
                                   np.asarray(getattr(jc, t).lnk), rtol=1e-12)


def test_power_spectrum_table_call(cosmos, rng):
    jc, _ = cosmos
    table = PowerSpectrumTable.from_log_arrays(np.asarray(jc.pk_nl.lnk),
                                               np.asarray(jc.pk_nl.lnp))
    k = np.concatenate([[0.0, -1.0, 1e-7, 5e3],
                        10 ** rng.uniform(-4.5, 2.5, 500)])
    got = table(torch.as_tensor(k)).numpy()
    want = np.asarray(jc.pk_nl(jnp.asarray(k)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert got[0] == 0.0 and got[1] == 0.0


@pytest.mark.parametrize("N", [16, 32])
def test_kvec_nyquist_geometry(N):
    jg = JaxGrid.create(box_scale=1e3, nsamp=N, redshift=Z)
    tg = GridSpec.create(box_scale=1e3, nsamp=N, redshift=Z)
    for a, b in zip(tg.kvec(torch.float64), jg.kvec(jnp.float64)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)
    np.testing.assert_array_equal(tg.nyquist_mask(2).numpy(),
                                  np.asarray(jg.nyquist_mask(2)))
    assert (tg.boxfactor, tg.kmin, tg.kmax) == (jg.boxfactor, jg.kmin,
                                                jg.kmax)
    np.testing.assert_array_equal(tg.fft_index, jg.fft_index)


def test_freq_and_pixel_arrays(cosmos):
    jc, tc = cosmos
    jg = JaxGrid.create(box_scale=1e3, nsamp=16, redshift=Z)
    tg = GridSpec.create(box_scale=1e3, nsamp=16, redshift=Z)
    np.testing.assert_allclose(tg.freq_array(tc), jg.freq_array(jc),
                               rtol=1e-12)
    for a, b in zip(tg.pixel_array(tc), jg.pixel_array(jc)):
        np.testing.assert_allclose(a, b, rtol=1e-12)


@pytest.mark.parametrize("N", [16, 32])
@pytest.mark.parametrize("linear_pk", [False, True])
def test_amp_half_matches_jax_consts(cosmos, N, linear_pk):
    jc, tc = cosmos
    jg = JaxGrid.create(box_scale=1e3, nsamp=N, redshift=Z)
    tg = GridSpec.create(box_scale=1e3, nsamp=N, redshift=Z)
    _, (amp, _) = _build_pipeline(
        jg, jc, JaxConfig(dtype="float64", linear_pk=linear_pk))
    got = amp_half_table(tg, tc, linear_pk).numpy()
    np.testing.assert_allclose(got, np.asarray(amp), rtol=1e-12, atol=0)


@pytest.mark.parametrize("N", [16, 32])
def test_bin_plan_and_hoisted_counts(cosmos, N):
    jg = JaxGrid.create(box_scale=1e3, nsamp=N, redshift=Z)
    tg = GridSpec.create(box_scale=1e3, nsamp=N, redshift=Z)
    edges = spectra.default_kbins(tg, 20)
    np.testing.assert_array_equal(edges, jax_spectra.default_kbins(jg, 20))
    thr = spectra.kbin_thresholds(tg, edges)
    np.testing.assert_array_equal(thr, jax_spectra.kbin_thresholds(jg, edges))
    np.testing.assert_array_equal(spectra._index_sq(tg),
                                  jax_spectra._index_sq(jg))
    H = N // 2 + 1
    w = np.full(H, 2.0)
    w[0] = w[-1] = 1.0
    # fastbox_tpu's CPU path: searchsorted bin plan + one-hot histogram
    _, (_, bin_idx) = _build_pipeline(jg, cosmos[0],
                                      JaxConfig(dtype="float64"))
    ones = jnp.ones(N * N * H)
    wf = jnp.broadcast_to(jnp.asarray(w)[None, None, :], (N, N, H)).ravel()
    cnt = np.asarray(jax_bwd(ones, ones, wf, bin_idx, thr.size)[4])
    np.testing.assert_allclose(spectra.hoisted_counts(tg, thr, w), cnt,
                               rtol=1e-12)
    assert spectra.kbin_thresholds(
        GridSpec.create(box_scale=(1e3, 1e3, 2e3), nsamp=N), edges) is None
