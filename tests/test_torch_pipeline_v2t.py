"""The pipeline's ``pallas_pk='v2t'`` path (K4t's twin on the CPU) through
every entry point, against fastbox_tpu's 'v2t' pipeline with its kernel in
interpret mode on the same draws, at 16^3."""
import warnings

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from fastbox_tpu.pipeline import PipelineConfig as JaxConfig
from fastbox_tpu.pipeline import make_pipeline as jax_make
from fastbox_tpu_torch.parallel import make_mesh, make_sharded_ensemble_step
from fastbox_tpu_torch.pipeline import (PipelineConfig, make_chained_pipeline,
                                        make_ensemble_pipeline, make_pipeline)
from test_torch_pipeline import rel_err
from test_torch_pipeline_configs import ANISO, CUBE, port_inputs

SPECTRA = ("pk_cleaned", "pk_density", "sigma_data")


@pytest.fixture(scope="module")
def v2t_case():
    """fastbox_tpu's 'v2t' pipeline (its kernel in interpret mode) in f64
    and f32, and the port's inputs for the same realisation."""
    key = jax.random.PRNGKey(91)
    jgrid, jcosmo, grid, cosmo, amp, draws = port_inputs(CUBE, key)
    kw = dict(threefry_noise=True, pallas_pk="v2t")
    out64 = jax_make(jgrid, jcosmo, JaxConfig(dtype="float64", **kw))(key)
    out32 = jax_make(jgrid, jcosmo, JaxConfig(
        dtype="float32", draw_dtype="float64", **kw))(key)
    return dict(grid=grid, cosmo=cosmo, amp=amp, draws=draws,
                out64={k: np.asarray(v) for k, v in out64.items()},
                out32={k: np.asarray(v) for k, v in out32.items()})


def run_port(case, **kw):
    fn = make_pipeline(case["grid"], case["cosmo"], PipelineConfig(
        pallas_pk="v2t", **kw), device="cpu", amp_half=case["amp"])
    return {k: v.numpy() for k, v in fn(draws=case["draws"]).items()}


@pytest.mark.parametrize("name", SPECTRA)
def test_v2t_pipeline_f64_matches_jax(v2t_case, name):
    got = run_port(v2t_case, dtype="float64")
    err = rel_err(got[name], v2t_case["out64"][name])
    assert err.size and err.max() <= 1e-8, err.max()


def test_v2t_pipeline_f32_within_jax_f32_floor(v2t_case):
    got = run_port(v2t_case, dtype="float32")
    for name in ("pk_cleaned", "pk_density"):
        floor = rel_err(v2t_case["out32"][name],
                        v2t_case["out64"][name]).max()
        err = rel_err(got[name], v2t_case["out64"][name]).max()
        assert got[name].dtype == np.float32
        assert err <= 3.0 * floor, (name, err, floor)


def test_v2t_off_a_cube_warns_and_equals_auto():
    """As fastbox_tpu (pipeline.py:389-400): off a cubic-exact grid 'v2t'
    warns, drops the telescoping and takes K5, as 'auto' does."""
    key = jax.random.PRNGKey(92)
    _, _, grid, cosmo, amp, draws = port_inputs(ANISO, key)
    with pytest.warns(UserWarning, match="dropping telescoping"):
        fn = make_pipeline(grid, cosmo, PipelineConfig(
            dtype="float64", pallas_pk="v2t"), device="cpu", amp_half=amp)
    a = fn(draws=draws)
    b = make_pipeline(grid, cosmo, PipelineConfig(dtype="float64"),
                      device="cpu", amp_half=amp)(draws=draws)
    for k in SPECTRA:
        assert torch.equal(a[k].nan_to_num(), b[k].nan_to_num()), k


def test_v2t_chain_and_ensemble_equal_single_calls(v2t_case):
    cfg = PipelineConfig(dtype="float64", pallas_pk="v2t")
    args = (v2t_case["grid"], v2t_case["cosmo"], cfg)
    gens = lambda: [torch.Generator().manual_seed(s) for s in (3, 4, 5)]
    single = make_pipeline(*args, device="cpu", amp_half=v2t_case["amp"])
    want = [single(g) for g in gens()]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        chain = make_chained_pipeline(*args, device="cpu",
                                      amp_half=v2t_case["amp"])(gens())
        ens = make_ensemble_pipeline(*args, device="cpu",
                                     amp_half=v2t_case["amp"])(gens())
    for out in (chain, ens):
        assert out["pk_cleaned"].shape == (3, 19)
        for i, one in enumerate(want):
            for k in SPECTRA:
                assert torch.equal(out[k][i].nan_to_num(),
                                   one[k].nan_to_num()), k


def test_v2t_step_matches_rows_pipeline(v2t_case):
    """The sharded step on a one-rank gloo mesh with 'v2t' (K4t's twin per
    slab) against the single noise_scheme='rows' 'v2t' pipeline, at the
    step-vs-single tolerances of tests/test_torch_parallel.py."""
    from test_torch_parallel import assert_outputs_close

    cfg = PipelineConfig(dtype="float64", pallas_pk="v2t", noise_scheme="rows",
                         nbins=8, pca_nmodes=3)
    grid, cosmo, amp = (v2t_case[k] for k in ("grid", "cosmo", "amp"))
    assert not dist.is_initialized()
    mesh = make_mesh(device="cpu")
    try:
        got = make_sharded_ensemble_step(mesh, grid, cosmo, cfg, "cpu",
                                         amp)(seeds=[11, 12])
    finally:
        dist.destroy_process_group()
    fn = make_pipeline(grid, cosmo, cfg, device="cpu", amp_half=amp)
    for i, seed in enumerate((11, 12)):
        one = fn(seed=seed)
        assert_outputs_close({k: got[k][i] for k in SPECTRA + (
            "pk_cleaned_err",)}, one)
