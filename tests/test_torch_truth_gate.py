"""The port's truth gate (``fastbox_tpu_torch.truth_gate``) on the CPU.

The gate's oracle is the port in float64 on float32 draws.  The first test
is the link that chains it to the reference: on fastbox_tpu's own float32
threefry draws, the port in float64 equals fastbox_tpu's float64 gate
configuration (scripts/truth_gate.py:103-107, ``draw_dtype='float32'``,
``threefry_noise=True``) per bin.  The rest drive the two phases through
the command line at 16^3 with two keys.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastbox_tpu.fields.gaussian import hermitian_half_noise
from fastbox_tpu.pipeline import PipelineConfig as JaxConfig
from fastbox_tpu.pipeline import make_pipeline as jax_make
from fastbox_tpu_torch import truth_gate
from fastbox_tpu_torch.grid import GridSpec
from fastbox_tpu_torch.pipeline import PipelineConfig, make_pipeline
from test_torch_pipeline import rel_err
from test_torch_pipeline_configs import CUBE, port_inputs

ROOT = Path(__file__).resolve().parents[1]
JAX_FIELDS = ("k", "pk_cleaned", "pk_density", "sigma", "f32_pk_cleaned",
              "f32_pk_density", "f32_sigma", "keys", "meta", "draw_method")


def jax_f32_draws(grid):
    """The five float32 draws of fastbox_tpu's gate configuration as a
    function of the key, jitted as its pipeline draws them: eagerly, XLA
    rounds the f32 Hermitian projection of the kz=0 and Nyquist planes
    differently (by an ulp), and the cleaned spectrum amplifies that to
    ~1e-6."""
    N = grid.N
    f32 = jnp.float32

    @jax.jit
    def draw(key):
        k_dens, k_rsd, k_fg, k_alpha, k_noise = jax.random.split(key, 5)
        kf1, kf2 = jax.random.split(k_fg)
        return {"dens": hermitian_half_noise(k_dens, grid, f32),
                "rsd": jax.random.normal(k_rsd, grid.shape, f32),
                "fg": (jax.random.normal(kf1, (N, N), f32)
                       + 1j * jax.random.normal(kf2, (N, N), f32)),
                "alpha": jax.random.normal(k_alpha, (N, N), f32),
                "noise": jax.random.normal(k_noise, grid.shape, f32)}

    return lambda key: {k: torch.tensor(np.asarray(v))
                        for k, v in draw(key).items()}


@pytest.fixture(scope="module")
def gate_configs():
    """fastbox_tpu's f64 gate configuration, its f32 draws, and the port's
    f64 pipeline, each built once for every key."""
    jgrid, jcosmo, grid, cosmo, amp, _ = port_inputs(CUBE,
                                                     jax.random.PRNGKey(0))
    want = jax_make(jgrid, jcosmo, JaxConfig(
        dtype="float64", draw_dtype="float32", threefry_noise=True))
    got = make_pipeline(grid, cosmo, PipelineConfig(dtype="float64"),
                        device="cpu", amp_half=amp)
    return want, jax_f32_draws(jgrid), got


@pytest.mark.parametrize("seed", [1000, 1001])
def test_port_f64_oracle_matches_jax_gate_configuration(gate_configs, seed):
    jax_fn, jax_draws, port_fn = gate_configs
    key = jax.random.PRNGKey(seed)
    want = jax_fn(key)
    draws = jax_draws(key)
    assert draws["rsd"].dtype == torch.float32
    got = port_fn(draws=draws)
    for name in ("pk_cleaned", "pk_density", "sigma_data"):
        err = rel_err(got[name].numpy(), np.asarray(want[name]))
        assert err.size and err.max() <= 1e-8, (name, err.max())


@pytest.fixture(scope="module")
def gate(tmp_path_factory):
    """``truth`` then ``check --cpu`` through main(), at 16^3 with 2 keys."""
    d = tmp_path_factory.mktemp("gate")
    npz, out = d / "truth.npz", d / "gate.json"
    truth_gate.main(["truth", "--nsamp", "16", "--box", "1e3", "--keys", "2",
                     "--out", str(npz)])
    truth_gate.main(["check", "--truth", str(npz), "--cpu", "--out",
                     str(out)])
    return npz, json.loads(out.read_text())


def test_truth_file_has_jax_fields_and_stream_tag(gate):
    npz, _ = gate
    with np.load(npz) as f:
        assert set(JAX_FIELDS) <= set(f.files)
        assert str(f["stream"]) == truth_gate.STREAM
        assert list(f["keys"]) == [1000, 1001]
        assert f["pk_cleaned"].shape == (2, 19)
        assert f["pk_cleaned"].dtype == np.float64
        np.testing.assert_array_equal(f["meta"], [16, 1e3, 0.8])


def test_native_highest_on_the_cpu_is_the_floor(gate):
    """On the CPU the check's float32 run is the truth phase's floor run:
    the same draws through the same code, bit for bit."""
    _, summary = gate
    native = summary["variants"]["native_highest"]
    assert native["pk_cleaned_max"] == summary["floor"]
    assert native["pk_cleaned_low5"] == summary["floor_low5"]
    assert native["pk_cleaned_bins"] == summary["floor_bins"]
    assert native["pk_density_max"] <= 1e-6
    assert set(summary) == {"floor", "floor_low5", "floor_bins", "nsamp",
                            "keys", "variants"}
    assert summary["nsamp"] == 16 and summary["keys"] == [1000, 1001]


def test_pk_v2t_spectra_within_1e6_of_native(gate):
    npz, summary = gate
    _, spectra = truth_gate.check_truth(npz, ["native_highest", "pk_v2t"],
                                        "cpu", log=lambda msg: None)
    for name in ("pk_cleaned", "pk_density"):
        a, b = spectra["pk_v2t"][name], spectra["native_highest"][name]
        ok = np.isfinite(b) & (b != 0)
        assert np.all(np.abs(a[ok] - b[ok]) <= 1e-6 * np.abs(b[ok])), name
    v2t = summary["variants"]["pk_v2t"]
    assert abs(v2t["pk_cleaned_max"] - summary["floor"]) <= 1e-6


def test_skipped_variants_are_listed_with_reasons(gate):
    _, summary = gate
    variants = summary["variants"]
    assert list(variants) == list(truth_gate.NAMES)
    for name, reason in truth_gate.SKIPPED.items():
        assert variants[name] == {"skipped": reason}
    # an erfinv truth file cannot hold the box-Muller stream
    assert variants["bm_draw"] == {"skipped": "stream mismatch vs erfinv"}
    # K10 takes no axis of 16: the route would leave every transform on
    # torch.fft
    assert "K10 takes no axis of length 16" in \
        variants["pallas_dft"]["skipped"]
    for name in set(truth_gate.VARIANTS) - {"bm_draw", "pallas_dft"}:
        assert variants[name]["pk_cleaned_max"] < 1.0, name


def test_box_muller_truth_runs_bm_draw_only(tmp_path):
    truth = truth_gate.make_truth(
        GridSpec.create(box_scale=1e3, nsamp=16, redshift=0.8),
        [7], "box_muller", log=lambda msg: None)
    summary, _ = truth_gate.check_truth(
        truth, ["native_highest", "bm_draw"], "cpu", log=lambda msg: None)
    assert summary["variants"]["native_highest"] == {
        "skipped": "stream mismatch vs box_muller"}
    assert summary["variants"]["bm_draw"]["pk_cleaned_max"] == \
        summary["floor"]


def test_file_without_stream_tag_is_refused(gate, tmp_path):
    npz, _ = gate
    with np.load(npz) as f:
        fields = {k: f[k] for k in f.files if k != "stream"}
    legacy = tmp_path / "threefry.npz"
    np.savez(legacy, **fields)
    with pytest.raises(ValueError, match="threefry"):
        truth_gate.check_truth(legacy, device="cpu")
    # the JAX package's own truth files are threefry realisations
    with pytest.raises(ValueError, match="stream"):
        truth_gate.check_truth(ROOT / "truth_gate_128.npz", device="cpu")
    with pytest.raises(ValueError, match="unknown variants"):
        truth_gate.check_truth(npz, ["no_such_variant"], "cpu")
