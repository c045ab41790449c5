"""COLA's exact CIC tier (``fields/cola.py`` ``cic_paint_particles``,
``cic_gather``): its trace and its agreement with the plain reference.

On the CPU at 16^3 in the deployment's 7.8 Mpc cells (a 125 Mpc box; the
512^3 cell's 4 Gpc over 512), with one intra-op thread.  The exact tier
is forced two ways: ``lattice_B`` 1, which the late steps' displacements
pass (a run that mixes band 1 and the exact tier), and the lattice off.
A force evaluation on the exact tier marks ``paint_exact`` and
``gather_exact`` (one each) where the lattice marks ``paint`` and
``gather``, and counts ``exact.paint`` and ``exact.gather`` (three, one a
component); the
``cola.*`` counts that the benchmark's readers divide by are those of a
run that does not count the ``exact.*`` family.  In float64 the port's
density and velocities agree with ``portbench.reference.cola`` (float64,
``index_add_`` CIC) on the same white noise.
"""
import pytest
import torch

from fastbox_tpu_torch import timing
from fastbox_tpu_torch.cosmology import build_cosmology
from fastbox_tpu_torch.fields.cola import realise_density_cola
from fastbox_tpu_torch.fields.gaussian import white_noise
from fastbox_tpu_torch.grid import GridSpec
from portbench.reference.cola import ColaReference
from portbench.reference.compare import cola_gaps

COSMO = dict(Omega_c=0.25, Omega_b=0.05, h=0.7, n_s=0.95, sigma8=0.8)
N, N_STEPS = 16, 16
L = 4000.0 * N / 512
SEED = 2 ** 31 + 2525
# (lattice_B, ladder bands): band 1 then the exact tier, or the exact
# tier alone
CASES = [(1, (1,)), (None, ())]


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


class _Recording(timing.StageClock):
    """A clock that also keeps its marks in call order."""

    def __init__(self, device):
        super().__init__(device)
        self.marks = []

    def mark(self, stage):
        self.marks.append(stage)
        super().mark(stage)


def _white(grid, dtype):
    """The cell's float32 draw, widened for a float64 run (the reference
    widens the same draw)."""
    w = white_noise(SEED, grid, torch.float32, "cpu")
    return w.to(torch.complex128) if dtype == torch.float64 else w


def _run(grid, cosmo, lattice_B, clock=None, dtype=torch.float32,
         diagnostics=True):
    return realise_density_cola(
        None, grid, cosmo, redshift=0.0, redshift_init=15.0,
        n_steps=N_STEPS, dtype=dtype, lattice_B=lattice_B,
        lattice_impl="plain", white=_white(grid, dtype), clock=clock,
        diagnostics=diagnostics, device="cpu")


def _exact_steps(diag, bands):
    """Per force evaluation, whether it took the exact tier."""
    used = diag["used_lattice"].tolist()
    return [u == len(bands) or u == -1 for u in used]


@pytest.mark.parametrize("lattice_B, bands", CASES)
def test_exact_marks_and_counts_follow_the_tier(grid, cosmo, lattice_B,
                                                bands):
    clock = _Recording("cpu")
    _, _, diag = _run(grid, cosmo, lattice_B, clock)
    exact = _exact_steps(diag, bands)
    n_exact = sum(exact)
    if lattice_B is None:
        assert n_exact == N_STEPS
    else:
        # the deployment's cells: early steps under band 1, late ones past
        assert 0 < n_exact < N_STEPS
    paints = [m for m in clock.marks if m in ("paint", "paint_exact")]
    assert paints == ["paint_exact" if e else "paint" for e in exact]
    # an exact force evaluation gathers its three components in one call
    assert clock.marks.count("gather_exact") == n_exact
    # a lattice force evaluation gathers its three components in one call
    assert clock.marks.count("gather") == N_STEPS - n_exact
    counts = clock.counts()
    assert counts["exact.paint"] == n_exact
    assert counts["exact.gather"] == 3 * n_exact
    assert set(clock.ms()) >= {"paint_exact", "gather_exact"}
    # the finish paints count in the cola.* family, not in exact.*
    fin = float(diag["final_maxdisp"])
    final_exact = not any(fin < b for b in bands)
    assert counts["cola.exact"] == n_exact + final_exact
    assert clock.marks[-1] == "finish"


@pytest.mark.parametrize("lattice_B, bands", CASES)
def test_cola_family_unmoved_by_the_exact_counters(grid, cosmo, monkeypatch,
                                                   lattice_B, bands):
    with_exact = timing.StageClock("cpu")
    d1, v1, _ = _run(grid, cosmo, lattice_B, with_exact)
    count = timing.count
    monkeypatch.setattr(timing, "count", lambda name, n=1: None
                        if name.startswith("exact.") else count(name, n))
    without = timing.StageClock("cpu")
    d2, v2, _ = _run(grid, cosmo, lattice_B, without)

    def family(clock, prefix):
        return {k: v for k, v in clock.counts().items()
                if k.startswith(prefix)}

    assert family(without, "exact.") == {}
    assert family(with_exact, "exact.")
    assert family(with_exact, "cola.") == family(without, "cola.")
    assert family(with_exact, "sync.") == family(without, "sync.")
    assert torch.equal(d1, d2) and torch.equal(v1, v2)


def test_tracing_costs_nothing_without_a_clock(grid, cosmo):
    timing.reset_trace_totals()
    try:
        d1, v1 = _run(grid, cosmo, 1, None, diagnostics=False)
        assert timing.trace_totals()["calls"] == 0
        clock = timing.StageClock("cpu")
        d2, v2 = _run(grid, cosmo, 1, clock, diagnostics=False)
        clock.ms()
        assert timing.trace_totals()["counts"]["exact.paint"] > 0
    finally:
        timing.reset_trace_totals()
    assert torch.equal(d1, d2) and torch.equal(v1, v2)


@pytest.mark.parametrize("lattice_B, bands", CASES)
def test_float64_agrees_with_the_reference(grid, cosmo, lattice_B, bands):
    config = {"nsamp": N, "box_mpc": L, "cosmology": COSMO,
              "cola": {"redshift_init": 15.0, "redshift": 0.0,
                       "n_steps": N_STEPS}}
    ref = ColaReference(config, "cpu").realise(SEED)
    delta, vel, diag = _run(grid, cosmo, lattice_B, dtype=torch.float64)
    assert any(_exact_steps(diag, bands))
    gaps = cola_gaps(delta, vel, ref)
    # Both run the same float64 CIC, Poisson solve and leapfrog on the
    # same draw; they differ only in the order of operations (the engine's
    # kick K1 + K2 rounded once, its mean-density division, its fused
    # scalars), so the relative L2 gaps are a few hundred float64
    # roundings (7e-15 and 2e-15 measured); 1e-12 leaves 100x for another
    # platform's FFT, while float32 reads 7e-6 / 2e-6.
    assert gaps["delta_gap"] < 1e-12, gaps
    assert gaps["vel_gap"] < 1e-12, gaps
