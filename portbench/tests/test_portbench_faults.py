"""A run whose timed path is broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a run
on the CPU at 16^3 (the cell's width, fewer cells a side), with one fault
planted in the program: a stage that returns its state unchanged, half of
the batch left out (the other half's outputs in its place), an answer
altered where it is produced.  A one-card cell has no exchange between
chips to leave out.  A sound run at this size comes out correct.
"""
from __future__ import annotations

import time

import pytest

from portbench.lib import harness

from .conftest import small

SEED = 2 ** 31 + 4242


def _half_batch(fn, arg):
    """``fn`` run on the first half of the seeds it gets as keyword
    ``arg``, its outputs repeated in place of the other half's."""
    def broken(**kwargs):
        import torch

        seeds = list(kwargs.pop(arg))
        half = seeds[:max(1, len(seeds) // 2)]
        out = fn(**{arg: half}, **kwargs)
        reps = -(-len(seeds) // len(half))
        return {k: v if v.dim() < 1 or k == "k" else
                torch.cat([v] * reps)[:len(seeds)] for k, v in out.items()}
    return broken


def _altered(fn, key, change):
    def broken(*args, **kwargs):
        out = fn(*args, **kwargs)
        change(out[key])
        return out
    return broken


def _scale_bin(t):
    t[0, 4] *= 1.5


def _step(monkeypatch, fault):
    import fastbox_tpu_torch.parallel.sharded as sharded

    if fault == "state_unchanged":
        monkeypatch.setattr(sharded, "remap_los_batched",
                            lambda vals, *a, **k: vals)
        return
    make = sharded.make_sharded_ensemble_step

    def patched(*a, **k):
        fn = make(*a, **k)
        if fault == "half_batch":
            return _half_batch(fn, "seeds")
        return _altered(fn, "pk_cleaned", _scale_bin)
    monkeypatch.setattr(sharded, "make_sharded_ensemble_step", patched)


def _chain(monkeypatch, fault):
    import fastbox_tpu_torch.ops.rsd as rsd
    import fastbox_tpu_torch.pipeline as pipeline

    if fault == "state_unchanged":
        monkeypatch.setattr(rsd, "redshift_space_density",
                            lambda delta_x, *a, **k: delta_x)
        return
    make = pipeline.make_chained_pipeline

    def patched(*a, **k):
        fn = make(*a, **k)
        if fault == "half_batch":
            return _half_batch(fn, "generators")
        return _altered(fn, "pk_cleaned", _scale_bin)
    monkeypatch.setattr(pipeline, "make_chained_pipeline", patched)


def _cola(monkeypatch, fault):
    import fastbox_tpu_torch.fields.cola as cola

    if fault == "state_unchanged":
        monkeypatch.setattr(cola.ColaEngine, "step",
                            lambda self, *a, **k: None)
        return

    def flip(vel):
        vel[0] = -vel[0]
    monkeypatch.setattr(cola, "realise_density_cola",
                        _altered(cola.realise_density_cola, 1, flip))


PLANT = {"mock256.step_b8": _step, "mock256.chain16": _chain,
         "cola256.single": _cola}
CASES = [(c, f) for c in PLANT for f in ("state_unchanged", "half_batch",
                                          "answer_altered")
         if not (c == "cola256.single" and f == "half_batch")]


def _run(cell):
    config, traffic = small(cell)
    result, _ = harness.execute(cell, SEED, 0.3, False, "cpu",
                                time.perf_counter(), config, traffic)
    return result


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_comes_out_not_correct(cell, fault, monkeypatch):
    PLANT[cell](monkeypatch, fault)
    assert _run(cell)["correct"] is False


@pytest.mark.parametrize("cell", sorted(PLANT))
def test_sound_run_comes_out_correct(cell):
    result = _run(cell)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
