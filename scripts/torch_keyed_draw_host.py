"""Host and device time of the port's 256^3 pipeline draw stage on the card.

The draw stage (stage (1), the density's white half-spectrum times
sqrt(P)) of ``fastbox_tpu_torch``'s default 256^3 pipeline, run from a key
and from a ``torch.Generator`` in turns (generator, key, key, generator;
``--reps`` realisations each).  For each realisation:

* ``host_ms``: the host's time from the call to the stage's end mark, the
  submission of the stage's work;
* ``device_ms``: the stage's CUDA-event time with the card held busy by a
  sleep kernel until the host has submitted it: the device's work alone;
* ``exposed_ms``: the stage's event time from an idle card, as
  ``StageClock`` reads it in a plain call (host and device overlap);
* ``wall_ms``: the whole realisation on the host clock.

    python3 scripts/torch_keyed_draw_host.py [--root CHECKOUT] [--reps 5]
                                             [--profile 200]

``--profile R`` instead runs the stage alone R times from each source
(the call stopped at its end mark, the card idle at its start) under
``cProfile`` and prints the host's ms per stage and its busiest
functions.  ``--root`` imports ``fastbox_tpu_torch`` from another
checkout (default: this one), so that two trees can be compared on one
card in one run.
Prints the card's name and power limit, then one JSON line per source.
Needs a CUDA card; the kernels are built at first use in the checkout's
``build/``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

COSMO = dict(Omega_c=0.25, Omega_b=0.05, h=0.7, n_s=0.95, sigma8=0.8)
BOX, Z, N = 4e3, 0.8, 256
SEEDS = (11, 2 ** 32 + 5)
SLEEP_CYCLES = 40_000_000   # ~20 ms of the card's clock: past the submission


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--profile", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_keyed_draw_host: no CUDA card")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from fastbox_tpu_torch.cosmology import build_cosmology
    from fastbox_tpu_torch.grid import GridSpec
    from fastbox_tpu_torch.pipeline import PipelineConfig, make_pipeline
    from fastbox_tpu_torch.timing import StageClock

    class HostClock(StageClock):
        """StageClock that also keeps the host's ms at each mark; with
        ``stop``, the call ends at the draw stage's mark."""

        def __init__(self, device, stop: bool = False):
            self.t0 = time.perf_counter()
            self.host: dict[str, float] = {}
            self.stop = stop
            super().__init__(device)

        def mark(self, stage: str) -> None:
            super().mark(stage)
            self.host.setdefault(stage,
                                 (time.perf_counter() - self.t0) * 1e3)
            if self.stop and stage == "draw":
                raise _Stop

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda:0")
    grid = GridSpec.create(box_scale=BOX, nsamp=N, redshift=Z)
    cosmo = build_cosmology(COSMO, redshift=Z, device=dev)
    fn = make_pipeline(grid, cosmo, PipelineConfig(), device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)

    def run(src, busy: bool):
        torch.cuda.synchronize()
        if busy:
            torch.cuda._sleep(SLEEP_CYCLES)
        clock = HostClock(dev)
        t0 = time.perf_counter()
        fn(src, clock=clock)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        return clock.host["draw"], clock.ms()["draw"], wall

    for src in (gen, SEEDS[0]):   # warm-up: builds, plans, caches
        run(src, False)
        run(src, True)
    if args.profile:
        profile(fn, dev, HostClock, gen, args)
        return
    res = {k: dict(host_ms=[], device_ms=[], exposed_ms=[], wall_ms=[])
           for k in ("generator", "key")}
    for kind in ("generator", "key", "key", "generator"):
        for i in range(args.reps):
            src = gen if kind == "generator" else SEEDS[i % len(SEEDS)]
            host, exposed, wall = run(src, False)
            _, device, _ = run(src, True)
            r = res[kind]
            r["host_ms"].append(round(host, 4))
            r["exposed_ms"].append(round(exposed, 4))
            r["device_ms"].append(round(device, 4))
            r["wall_ms"].append(round(wall, 3))
    for kind, r in res.items():
        print(json.dumps(dict(root=args.root, source=kind, **r)), flush=True)


class _Stop(Exception):
    pass


def profile(fn, dev, clock_cls, gen, args) -> None:
    """The draw stage alone, ``args.profile`` times from each source,
    under cProfile: host ms per stage (median) and the top functions."""
    import cProfile
    import io
    import pstats
    import statistics

    for kind in ("generator", "key"):
        prof = cProfile.Profile()
        host = []
        for i in range(args.profile):
            src = gen if kind == "generator" else SEEDS[i % len(SEEDS)]
            torch.cuda.synchronize()
            clock = clock_cls(dev, stop=True)
            prof.enable()
            try:
                fn(src, clock=clock)
            except _Stop:
                pass
            prof.disable()
            host.append(clock.host["draw"])
        buf = io.StringIO()
        pstats.Stats(prof, stream=buf).sort_stats("tottime").print_stats(25)
        print(json.dumps(dict(root=args.root, source=kind,
                              profiled_host_ms_median=round(
                                  statistics.median(host), 4))))
        print(buf.getvalue(), flush=True)


if __name__ == "__main__":
    main()
