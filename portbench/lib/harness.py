"""One run of one cell: set-up, the measured window, the trace, the check.

Everything that belongs to one configuration, traffic mix, entry point or
metric sits in a file of its own, found by the name ``BENCHMARK.json``
gives it:

* ``configs/<file>``: the configuration (``BENCHMARK.json``'s ``file``);
* ``traffic/<traffic>.json``: the cell's traffic mix, one file a cell:
  its ``entry``, ``realisations_per_call``, ``warmup_calls``,
  ``check_calls`` (calls the check samples from the window),
  ``profile_calls`` (calls the traced run profiles) and the ``limits`` of
  the compared numbers;
* ``entries/<entry>.py``: ``build(config, traffic, device)`` -> an object
  with ``realisations``, ``call(seeds, clock)`` -> the outputs on the
  host (numpy; they may be views of buffers the next call reuses) and
  ``close()``; ``gaps(config, traffic, samples, device)`` -> the compared
  numbers; ``reference(config, traffic, device, quant)`` -> the reference
  in the program's place;
* ``metrics/<metric>.py``: ``read(run)`` -> the metric's value, or None
  where the run has nothing for it to read.

The run is a closed loop: one caller makes back-to-back calls until
``seconds`` have passed; call ``i`` gets the seeds of ``(seed, i)``
(``lib.keys``).  A call ends when its outputs are on the host.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import random
import sys
import time
import types
from pathlib import Path

import numpy as np

from . import keys

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fastbox_tpu")


def load_manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _named(items: list, name: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no entry named '{name}'")


def load_module(kind: str, name: str) -> types.ModuleType:
    """``portbench/<kind>/<name>.py`` as a module."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(manifest: dict, cell: str) -> tuple[dict, dict, dict]:
    """(the workload entry, its configuration, its traffic)."""
    w = _named(manifest["workloads"], cell)
    c = _named(manifest["configs"], w["config"])
    return w, load_json(ROOT / c["file"]), \
        load_json(BENCH / "traffic" / f"{w['traffic']}.json")


def cell_metrics(manifest: dict, cell: str, section: str) -> list[str]:
    """The names of ``section``'s metrics that ``cell`` reports."""
    return [m["name"] for m in manifest[section]
            if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


class _Sample:
    """A reservoir of ``k`` calls' (seeds, outputs), uniform over the
    window's calls, drawn from the run's seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen, self.items = k, 0, []
        self.rng = random.Random(seed)

    def offer(self, seeds, outputs: dict) -> None:
        """Keep a copy of the call's outputs (an entry may hand out views
        of buffers that its next call overwrites) if the draw picks it."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append((seeds, {k: np.array(v, copy=True)
                                       for k, v in outputs.items()}))
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            kept = self.items[j][1]
            for k, v in outputs.items():
                np.copyto(kept[k], v)    # into the kept arrays: no new pages
            self.items[j] = (seeds, kept)


def execute(cell: str, seed: int, seconds: float, trace: bool, device,
            t_start: float, config: dict | None = None,
            traffic: dict | None = None) -> tuple[dict, list[str]]:
    """One run; returns (the result line's object, the lines for standard
    error: the calls' times, the stages' times in a traced run, then each
    checked number beside its limit).
    ``config`` and ``traffic`` replace the cell's files (the tests run
    small sizes on the CPU)."""
    import torch

    from fastbox_tpu_torch.timing import StageClock

    from .profile import profile_calls

    manifest = load_manifest()
    w, cfg, trf = cell_files(manifest, cell)
    config = config or cfg
    traffic = traffic or trf
    entry = load_module("entries", traffic["entry"])
    cuda = torch.device(device).type == "cuda"

    prog = entry.build(config, traffic, device)
    R = prog.realisations
    for k in range(int(traffic["warmup_calls"])):
        prog.call(keys.realisation_seeds(seed, -1 - k, R),
                  StageClock(device) if trace else None)
    if cuda:
        torch.cuda.synchronize(device)
    # set-up's objects leave the collector's generations: the window's
    # collections then scan only what the calls make
    gc.collect()
    gc.freeze()
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start

    sample = _Sample(int(traffic["check_calls"]), seed)
    call_s, stage_ms, clocked = [], {}, 0
    profile, profiled, i = None, 0, 0
    t0 = time.perf_counter()
    while True:
        clock = StageClock(device) if trace else None
        seeds = keys.realisation_seeds(seed, i, R)
        a = time.perf_counter()
        out = prog.call(seeds, clock)
        b = time.perf_counter()
        call_s.append(b - a)
        sample.offer(seeds, out)
        i += 1
        if clock is not None:
            for name, ms in clock.ms().items():
                stage_ms[name] = stage_ms.get(name, 0.0) + ms
            clocked += R
        if trace and cuda and not profiled and b - t0 >= 0.5 * seconds:
            profiled = int(traffic["profile_calls"])
            profile = profile_calls(
                lambda j: prog.call(keys.realisation_seeds(seed, j, R)),
                range(i, i + profiled))
            i += profiled
            b = time.perf_counter()
        if b - t0 >= seconds:
            break
    window_s = b - t0
    gc.unfreeze()
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    # what the window leaves for the metric readers
    run = types.SimpleNamespace(entry=traffic["entry"], config=config, traffic=traffic,
              realisations_per_call=R, calls=len(call_s), call_s=call_s,
              window_s=window_s, setup_s=setup_s,
              peak_window_bytes=window_peak, stage_ms=stage_ms,
              clocked_realisations=clocked, profile=profile)
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for name in cell_metrics(manifest, cell, section):
        unit = _named(manifest[section], name)["unit"]
        value = load_module("metrics", name).read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}

    prog.close()
    del prog, out
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    gaps = entry.gaps(config, traffic, sample.items, device)
    limits = traffic["limits"]
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in gaps.items()}
    correct = bool(checks) and all(
        c["limit"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    ms = sorted(1e3 * s for s in call_s)
    lines = [f"calls: {len(ms)} in {window_s:.3f} s; ms p50 "
             f"{ms[len(ms) // 2]:.3f}, p90 {ms[int(0.9 * len(ms))]:.3f}, "
             f"max {ms[-1]:.3f}"]
    if clocked:
        lines.append("stages (ms a realisation): " + ", ".join(
            f"{k} {v / clocked:.4f}" for k, v in stage_ms.items()))
    lines += [f"check {k}: {c['value']!r} (limit {c['limit']!r})"
              for k, c in checks.items()]

    dev = {"platform": "gpu" if cuda else torch.device(device).type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": int(w["chips"]),
           "memory_peak_bytes": int(max(setup_peak, window_peak))}
    if cuda:
        from .peaks import power_limit_w
        dev["power_limit_w"] = power_limit_w()
    result = {"correct": correct, "attempted": i * R, "failed": 0,
              "metrics": metrics, "device": dev}
    if trace and profile:
        dev["busy_s"] = profile["busy_s"]
        dev["window_s"] = profile["window_s"]
        result["breakdown"] = {"device_ops": profile["device_ops"],
                               "idle_gaps": profile["idle_gaps"]}
    result["checks"] = checks
    return result, lines
