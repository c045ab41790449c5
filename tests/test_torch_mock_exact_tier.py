"""The keyed mock survey where its RSD passes K2's band 4 and takes the
exact tier (the wrap, a stable sort per line of sight, the gather and
K3): the chained pipeline against the plain reference, a chained call
whose keys switch between band 4 and the exact tier, the exact tier's
work counter (``rsdwork.exact_cells``) and stage (``rsd_exact``), and
``timing.mark``.

On the CPU at 32^3 with one intra-op thread, in the 1 Gpc configuration's
physics (``portbench/configs/im_mock_1gpc_256.json``) and float32.  The
largest displacement is ~8 Mpc here whatever the box, so a 64 Mpc box
(2 Mpc cells) puts it at 3.4-4.4 cells over keys, astride band 4's edge
as the 1 Gpc box does at 256^3 (3.9 Mpc cells); a 125 Mpc box puts every
key inside band 4.
"""
import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from fastbox_tpu_torch import timing
from fastbox_tpu_torch.ops import rsd as rsd_ops
from portbench.lib import harness
from portbench.reference.compare import MOCK_OUTPUTS, mock_gaps
from portbench.reference.mock import MockReference

CONFIG = Path(__file__).resolve().parents[1] / "portbench" / "configs" / \
    "im_mock_1gpc_256.json"
N = 32
BOX = 64.0
# four keys of one call: the exact tier, band 4, the exact tier twice
SEEDS = [2 ** 31 + 3100 + j for j in range(4)]
# Widest relative gaps to the float64 reference on the same float32 draws.
TOLERANCE = {
    # the density's spectrum: the float32 half-spectrum times the float32
    # sqrt(P), untouched by the remap; 1.7e-7 read, a few float32 roundings
    "pk_density_gap": 1e-5,
    # the cleaned spectrum and its error: the clean subtracts foregrounds
    # ~1e4 times the signal, so float32 rounding of the data cube (the
    # remap's float32 coordinates among it) shows magnified in the
    # residual; 4.8e-4 read over these keys
    "pk_cleaned_gap": 1e-2,
    "pk_cleaned_err_gap": 1e-2,
    # the data cube's rms, one float32 sum of N^3 values: 3.1e-7 read
    "sigma_data_gap": 1e-5,
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(box: float) -> dict:
    config = copy.deepcopy(json.loads(CONFIG.read_text()))
    config.update(nsamp=N, box_mpc=box)
    return config


def _chain_call(config: dict, seeds, clock):
    """One call of the cell's entry (``make_chained_pipeline`` over the
    keys, each realisation on ``clock``): the stacked outputs."""
    entry = harness.load_module("entries", "chained_pipeline")
    prog = entry.build(config, {"realisations_per_call": len(seeds)}, "cpu")
    try:
        out = prog.call(seeds, clock)
        return {k: np.array(v, copy=True) for k, v in out.items()}
    finally:
        prog.close()


def _reference_disp_cells(ref: MockReference, seed: int) -> float:
    """max |v_z + sigma_NL n| / H / dz of the reference's realisation of
    ``seed``, in float64 from the same float32 draws."""
    g = ref.geo
    d = ref._draw_fields(seed, "keys")
    vel = torch.fft.irfftn(1j * ref.vz_w * d["delta_k"], (g.N,) * 3) \
        + ref.p["sigma_nl"] * d["rsd"]
    return float(vel.abs().max()) / g.Hz / float(g.z[1] - g.z[0])


@pytest.fixture(scope="module")
def mixed():
    """(config, outputs, clock) of one clocked chained call of ``SEEDS``
    in the 64 Mpc box."""
    config = _config(BOX)
    clock = timing.StageClock("cpu")
    out = _chain_call(config, SEEDS, clock)
    clock.ms()
    return config, out, clock


def test_exact_tier_keys_pass_band_4(mixed):
    config, _, clock = mixed
    ref = MockReference(config, "cpu")
    disp = [_reference_disp_cells(ref, s) for s in SEEDS]
    # the keys on either side of the edge, none within float32 reach of it
    assert [d > 4.0 for d in disp] == [True, False, True, True], disp
    assert min(abs(d - 4.0) for d in disp) > 1e-3
    counts = clock.counts()
    # the program's reads agree with the reference's bounds (float32 max
    # and 1/H: at most one thousandth of a cell apart, each)
    assert abs(counts["rsdwork.disp_mcells"] - 1000.0 * sum(disp)) \
        <= len(SEEDS)


def test_every_key_of_the_mixed_call_matches_the_reference(mixed):
    config, out, _ = mixed
    ref = MockReference(config, "cpu")
    for j, seed in enumerate(SEEDS):
        gaps = mock_gaps({k: out[k][j] for k in MOCK_OUTPUTS},
                         ref.realise(seed, "keys"))
        for k, tol in TOLERANCE.items():
            assert gaps[k] <= tol, (seed, k, gaps[k])


def test_tiers_and_exact_work_counted_per_key(mixed):
    _, _, clock = mixed
    counts = clock.counts()
    assert {k: v for k, v in counts.items() if k.startswith("rsd.")} == \
        {"rsd.band4": 1, "rsd.exact": 3}
    assert counts["rsdwork.cells"] == len(SEEDS) * N ** 3
    assert counts["rsdwork.exact_cells"] == 3 * N ** 3
    assert counts["rsdwork.disp_reads"] == len(SEEDS)
    # one band pick and one eigh a key: the exact tier adds no sync
    assert counts["sync.rsd_band"] == len(SEEDS)
    assert {k for k in counts if k.startswith("sync.")} == \
        {"sync.rsd_band", "sync.eigh"}


def test_rsd_exact_stage_follows_the_rsd_stage(mixed):
    _, _, clock = mixed
    stages = [m[0] for m in clock._marks[1:]]
    band = ["draw", "velocity_irfft", "lognormal", "rsd", "foregrounds",
            "noise", "pca", "pk"]
    # the exact tier ends 'rsd' as it starts and marks 'rsd_exact' after
    # K3; the pipeline's own 'rsd' mark follows
    exact = band[:3] + ["rsd", "rsd_exact"] + band[3:]
    got, i = [], 0
    while i < len(stages):
        is_exact = stages[i:i + len(exact)] == exact
        got.append(is_exact)
        assert is_exact or stages[i:i + len(band)] == band, stages[i:]
        i += len(exact) if is_exact else len(band)
    assert got == [True, False, True, True]
    assert clock.ms()["rsd_exact"] > 0.0


def test_band_4_box_marks_no_exact_stage():
    clock = timing.StageClock("cpu")
    _chain_call(_config(125.0), SEEDS[:2], clock)
    counts = clock.counts()
    assert {k: v for k, v in counts.items() if k.startswith("rsd.")} == \
        {"rsd.band4": 2}
    assert "rsdwork.exact_cells" not in counts
    assert "rsd_exact" not in clock.ms()


@pytest.mark.parametrize("fused", [True, False])
def test_batched_exact_branches_mark_and_count(fused):
    """``remap_los_batched``'s exact branches (the sharded step's): after
    the bracket scan's cover check, and on sorted nodes."""
    rng = np.random.default_rng(7)
    M, C, cells = 64, 16, 9.0
    z = np.linspace(-500.0, 500.0, C)
    dz = z[1] - z[0]
    u = z[None] + rng.uniform(-cells * dz, cells * dz, (M, C))
    s = (u - z[0]) % (z[-1] - z[0]) + z[0]
    vals = torch.as_tensor(rng.standard_normal((M, C)))
    clock = timing.StageClock("cpu")
    with timing.active(clock):
        rsd_ops.remap_los_batched(
            vals, torch.as_tensor(s), torch.as_tensor(z),
            torch.as_tensor(rng.standard_normal(M)), ztarget_np=z,
            s_unwrapped=torch.as_tensor(u) if fused else None)
    counts = clock.counts()
    assert counts["rsd.exact"] == 1
    assert counts["rsdwork.exact_cells"] == counts["rsdwork.cells"] == M * C
    assert [m[0] for m in clock._marks[1:]] == ["rsd", "rsd_exact"]


def test_mark_does_nothing_without_a_clock():
    timing.reset_trace_totals()
    try:
        timing.mark("rsd_exact")
        with timing.active(None) as clock:
            assert clock is timing.NULL_CLOCK
            timing.mark("rsd_exact")
        assert timing.trace_totals() == \
            {"calls": 0, "host_ms": {}, "counts": {}}
    finally:
        timing.reset_trace_totals()


def test_mark_reaches_the_active_clock():
    clock = timing.StageClock("cpu")
    with timing.active(clock):
        timing.mark("a")
    timing.mark("b")        # no longer active
    assert [m[0] for m in clock._marks[1:]] == ["a"]
    assert list(clock.ms()) == ["a"]
