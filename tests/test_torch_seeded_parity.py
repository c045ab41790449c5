"""The port run from seeds against fastbox_tpu run from
``jax.random.PRNGKey(seed)``: the row-keyed draws (``parallel.rng``) are
jax's own streams, so no draws need to be injected.

* The sharded ensemble step with ``seeds`` on one rank (this process),
  and on 2 and 4 gloo ranks ('space' = the world, ``parallel.local``),
  against fastbox_tpu's step on 8 virtual devices ((2, 4) mesh) with the
  seeds' keys; and the single pipeline in ``noise_scheme='rows'`` with
  ``seed`` against fastbox_tpu's on the key.  Tolerances of the
  injected-draw tests (tests/test_torch_parallel.py, after
  tests/test_parallel.py): the float64 fields differ by the two libraries'
  erfinv, at most 1.3e-11 absolute (tests/test_torch_row_draws.py), far
  inside them.
* ``make_sharded_halo_counts`` on 1, 2 and 4 ranks against fastbox_tpu's
  on 4 virtual devices, float32 linear rates.  At a mean count of ~2.4 a
  voxel (Knuth's loop) the counts are equal.  At tests/
  test_torch_parallel_estimators.py's mean of ~244 (Hörmann's rejection)
  XLA's lgamma/log rounding decides some acceptances
  (tests/test_torch_row_draws.py): at most 5% of the counts differ, and
  every rank count draws the same counts.
(``make_sharded_cola(seed=)`` against fastbox_tpu's engine on the key is
in tests/test_torch_parallel_cola.py.)
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from fastbox_tpu.grid import GridSpec as JaxGrid
from fastbox_tpu.parallel import make_mesh as jax_make_mesh
from fastbox_tpu.parallel import make_sharded_ensemble_step as jax_step
from fastbox_tpu.parallel import make_sharded_halo_counts as jax_halo_counts
from fastbox_tpu.pipeline import PipelineConfig as JaxConfig
from fastbox_tpu.pipeline import make_pipeline as jax_make
from fastbox_tpu_torch.grid import GridSpec
from fastbox_tpu_torch.parallel import (local, make_mesh,
                                        make_sharded_ensemble_step,
                                        make_sharded_halo_counts)
from fastbox_tpu_torch.pipeline import PipelineConfig, make_pipeline
from test_torch_parallel import (CONFIGS, N, assert_outputs_close, inputs_for,
                                 spec)

SEEDS = (31, 2 ** 32 + 5)
WORLDS = (1, 2, 4)
# (nbar, seed) of the halo counts: a Knuth mean (~2.4 a voxel) and the
# estimators test's rejection mean (~244)
HALO_CASES = {"knuth": (1e-5, 9), "rejection": (1e-3, 9)}
HALO_BOX, HALO_BIAS = 1e3, 1.6
REJECTION_DIFF_BOUND = 0.05


def halo_delta():
    return torch.as_tensor(0.5 * np.random.default_rng(3)
                           .standard_normal((N, N, N)))


@pytest.fixture(scope="module")
def mesh1():
    """A one-rank ('ens' 1, 'space' 1) mesh in this process, on gloo."""
    assert not dist.is_initialized()
    mesh = make_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def jax_runs():
    """fastbox_tpu's step and rows pipeline on the seeds' PRNGKeys."""
    box, kw = CONFIGS["instrument"]
    inputs = inputs_for(box)
    keys = jnp.stack([jax.random.PRNGKey(s) for s in SEEDS])
    jcfg = JaxConfig(**kw)
    step = jax_step(jax_make_mesh(8, space=4, grid_n=N), inputs["jgrid"],
                    inputs["jcosmo"], jcfg)
    single = jax_make(inputs["jgrid"], inputs["jcosmo"], jcfg)
    return dict(inputs=inputs, config=PipelineConfig(**kw),
                step={k: np.asarray(v) for k, v in step(keys).items()},
                single=[{k: np.asarray(v) for k, v in single(k_).items()}
                        for k_ in keys])


@pytest.fixture(scope="module")
def gloo():
    """The seeded step ('space' = the world) and the halo counts of each
    HALO_CASES entry on 2 and 4 gloo ranks."""
    out = {}
    for world in WORLDS[1:]:
        out[world] = {"step": local.launch(
            "fastbox_tpu_torch.parallel.local:tasks", world,
            dict(tasks=["sharded_step"],
                 steps=[spec("instrument", seeds=SEEDS, space=world)]))}
        for name, (nbar, seed) in HALO_CASES.items():
            out[world][name] = local.launch(
                "fastbox_tpu_torch.parallel.local:tasks", world,
                dict(tasks=["halos"], halos=dict(
                    grid=(HALO_BOX, N), seed=seed, nbar=nbar,
                    bias=HALO_BIAS, seed_ln=seed, nbar_ln=nbar,
                    delta=halo_delta())))
    return out


@pytest.mark.parametrize("world", WORLDS)
def test_seeded_step_matches_fastbox_tpu(jax_runs, gloo, mesh1, world):
    inputs = jax_runs["inputs"]
    if world == 1:
        results = [make_sharded_ensemble_step(
            mesh1, inputs["grid"], inputs["cosmo"], jax_runs["config"], "cpu",
            inputs["amp"])(seeds=list(SEEDS))]
    else:
        results = [r["sharded_step"][0] for r in gloo[world]["step"]]
    for got in results:
        assert got["pk_cleaned"].shape == (len(SEEDS), 7)
        assert_outputs_close(got, jax_runs["step"])


def test_seeded_rows_pipeline_matches_fastbox_tpu(jax_runs):
    inputs = jax_runs["inputs"]
    fn = make_pipeline(inputs["grid"], inputs["cosmo"], jax_runs["config"],
                       device="cpu", amp_half=inputs["amp"])
    for seed, want in zip(SEEDS, jax_runs["single"]):
        assert_outputs_close(fn(seed=seed), want)


@pytest.fixture(scope="module")
def jax_halos():
    grid = JaxGrid.create(box_scale=HALO_BOX, nsamp=N)
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("space",))
    return {name: np.asarray(jax_halo_counts(mesh, grid, nbar, HALO_BIAS)(
        jax.random.PRNGKey(seed), jnp.asarray(halo_delta().numpy())))
        for name, (nbar, seed) in HALO_CASES.items()}


@pytest.mark.parametrize("case", list(HALO_CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_seeded_halo_counts_match_fastbox_tpu(jax_halos, gloo, mesh1, case,
                                              world):
    nbar, seed = HALO_CASES[case]
    if world == 1:
        grid = GridSpec.create(box_scale=HALO_BOX, nsamp=N)
        got = make_sharded_halo_counts(mesh1, grid, nbar, HALO_BIAS)(
            seed, halo_delta())
    else:
        got = torch.cat([r["halos"]["counts"] for r in gloo[world][case]])
    assert got.dtype == torch.float32 and got.shape == (N, N, N)
    want = jax_halos[case]
    differ = got.numpy() != want
    if case == "knuth":
        assert not differ.any(), int(differ.sum())
    else:
        assert differ.mean() <= REJECTION_DIFF_BOUND, differ.mean()
    if world > 1:
        ranks1 = make_sharded_halo_counts(
            mesh1, GridSpec.create(box_scale=HALO_BOX, nsamp=N), nbar,
            HALO_BIAS)(seed, halo_delta())
        assert torch.equal(got, ranks1)
