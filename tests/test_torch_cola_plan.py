"""The COLA engine's host plan (``fields/cola.py``: the step schedule, the
growth scalars and the 1-D k vectors), built once for each configuration.

On the CPU at 16^3 with one intra-op thread.  A run that finds the plan
built by an earlier call gives the bits of the run that built it (f32 and
f64); a built plan calls scipy's ``quad`` no more and counts
``colaplan.hit``; a change to any part of the configuration that the plan
depends on misses, and the plan it then builds is the one built afresh;
the shared k vectors leave a run as they came; the schedule is immutable.
The schedule's agreement with ``fastbox_tpu``'s is
``tests/test_torch_cola.py::test_step_schedule_matches``.
"""
import dataclasses

import pytest
import torch

from fastbox_tpu_torch import timing
from fastbox_tpu_torch.cosmology import build_cosmology
from fastbox_tpu_torch.fields import cola
from fastbox_tpu_torch.fields.gaussian import white_noise
from fastbox_tpu_torch.grid import GridSpec

COSMO = dict(Omega_c=0.25, Omega_b=0.05, h=0.7, n_s=0.95, sigma8=0.8)
N, N_STEPS, Z_INIT = 16, 8, 15.0
L = 4000.0 * N / 512
SEED = 2 ** 31 + 2828
MEMOS = (cola._step_schedule, cola._growth_scalars, cola._k_vectors)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def grid():
    return GridSpec.create(box_scale=L, nsamp=N, redshift=0.0)


@pytest.fixture(scope="module")
def cosmo():
    return build_cosmology(COSMO, redshift=0.0, device="cpu")


def _cold():
    """Forget every plan built so far."""
    for memo in MEMOS:
        memo.cache_clear()


def _engine(grid, cosmo, clock=None, **kw):
    kw = dict(dict(redshift_init=Z_INIT, n_steps=N_STEPS, device="cpu"),
              **kw)
    with timing.active(clock):
        return cola.ColaEngine(grid, cosmo, **kw)


def _run(grid, cosmo, dtype, clock=None, **kw):
    white = white_noise(SEED, grid, dtype, "cpu")
    return cola.realise_density_cola(
        None, grid, cosmo, redshift_init=Z_INIT, n_steps=N_STEPS,
        dtype=dtype, white=white, clock=clock, device="cpu", **kw)


def _plan_tensors(eng):
    return (eng._kf, eng._kzf_h, eng._kx_d, eng._kz_d, eng._m1, eng._m1h)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_a_warm_run_gives_the_cold_runs_bits(grid, cosmo, dtype):
    _cold()
    cold, warm = timing.StageClock("cpu"), timing.StageClock("cpu")
    d0, v0 = _run(grid, cosmo, dtype, cold)
    d1, v1 = _run(grid, cosmo, dtype, warm)
    assert cold.counts()["colaplan.miss"] == 1
    assert "colaplan.hit" not in cold.counts()
    assert warm.counts()["colaplan.hit"] == 1
    assert "colaplan.miss" not in warm.counts()
    assert torch.equal(d0, d1) and torch.equal(v0, v1)


def test_a_built_plan_calls_no_quad(grid, cosmo, monkeypatch):
    _engine(grid, cosmo)
    calls = []
    quad = cola.quad

    def counted(*a, **k):
        calls.append(a[1:3])
        return quad(*a, **k)

    monkeypatch.setattr(cola, "quad", counted)
    clock = timing.StageClock("cpu")
    _engine(grid, cosmo, clock)
    assert calls == []
    assert clock.counts() == {"colaplan.hit": 1}
    # built anew: three integrals of two quads a step
    _cold()
    clock = timing.StageClock("cpu")
    _engine(grid, cosmo, clock)
    assert len(calls) == 6 * N_STEPS
    assert clock.counts() == {"colaplan.miss": 1}


# Each part of the configuration that the plan depends on: the schedule's
# (cosmology, redshifts, steps) and the k vectors' (dtype, N, box size).
VARIANTS = {
    "cosmology": {"Omega_c": 0.26},
    "redshift": {"redshift": 0.5},
    "redshift_init": {"redshift_init": 12.0},
    "n_steps": {"n_steps": N_STEPS + 1},
    "dtype": {"dtype": torch.float64},
    "N": {"nsamp": 12},
    "box": {"box_scale": 2 * L},
}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_each_part_of_the_configuration_misses(grid, cosmo, name):
    change = dict(VARIANTS[name])
    g = GridSpec.create(box_scale=change.pop("box_scale", L),
                        nsamp=change.pop("nsamp", N), redshift=0.0)
    c = cosmo
    if "Omega_c" in change:
        c = build_cosmology(dict(COSMO, Omega_c=change.pop("Omega_c")),
                            redshift=0.0, device="cpu")
    _cold()
    _engine(grid, cosmo)
    counts = []
    for _ in range(2):
        clock = timing.StageClock("cpu")
        eng = _engine(g, c, clock, **change)
        counts.append(clock.counts())
    assert counts == [{"colaplan.miss": 1}, {"colaplan.hit": 1}]
    # the memos hand out the plan that the configuration builds afresh
    params = c.params
    a_init = 1.0 / (1.0 + change.get("redshift_init", Z_INIT))
    a_final = 1.0 / (1.0 + change.get("redshift", 0.0))
    fresh = cola._step_schedule.__wrapped__(params, a_init, a_final,
                                             eng.n_steps)
    assert eng.rows == [tuple(eng._s(v) for v in row) for row in fresh]
    assert cola._growth_scalars(params, a_final) == \
        cola._growth_scalars.__wrapped__(params, a_final)
    built = cola._k_vectors.__wrapped__(g.N, g.N, g.Lx, eng.dtype,
                                        torch.device("cpu"))
    for got, want in zip(_plan_tensors(eng), built, strict=True):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_the_shared_k_vectors_leave_a_run_unchanged(grid, cosmo):
    """A spectral run on the lattice reads the k and derivative vectors,
    one on a twice finer force mesh the particle-Nyquist masks."""
    f64 = torch.float64
    for kw in ({}, {"force_factor": 2, "lattice_B": None}):
        shared = _plan_tensors(_engine(grid, cosmo, dtype=f64, **kw))
        before = tuple(t.clone() for t in shared)
        _run(grid, cosmo, f64, **kw)
        after = _plan_tensors(_engine(grid, cosmo, dtype=f64, **kw))
        assert all(a is b for a, b in zip(after, shared, strict=True))
        assert all(torch.equal(a, b)
                   for a, b in zip(after, before, strict=True))


def test_the_plan_is_immutable(cosmo):
    rows = cola._step_schedule(cosmo.params, 1.0 / 16, 1.0, 4)
    assert cola._step_schedule(cosmo.params, 1.0 / 16, 1.0, 4) is rows
    assert isinstance(rows, tuple) and len(rows) == 4
    assert all(isinstance(r, tuple) and len(r) == 8 for r in rows)
    assert all(type(v) is float for r in rows for v in r)
    with pytest.raises(TypeError):
        rows[0] = rows[1]
    with pytest.raises(TypeError):
        rows[0][0] = 0.0
    scalars = cola._growth_scalars(cosmo.params, 0.3)
    assert isinstance(scalars, tuple)
    assert all(type(v) is float for v in scalars)
    # CosmoParams keys the memos: frozen, so a key cannot change under them
    with pytest.raises(dataclasses.FrozenInstanceError):
        cosmo.params.h = 0.6
