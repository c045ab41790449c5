"""Host syncs and stage marks of one call of each benchmark cell.

Each cell of ``BENCHMARK.json`` is built through its ``portbench`` entry
and warmed up.  Then, per cell:

* one call with a ``timing.StageClock`` under
  ``torch.cuda.set_sync_debug_mode("warn")``: every synchronising CUDA
  operation raises a warning, put down to the innermost frame in
  ``fastbox_tpu_torch`` (the program) or, failing that, in ``portbench``
  (the entry's own copies of its outputs to the host).  Printed beside the
  call's ``sync.*`` counts from the clock, which should equal the
  program's warnings;
* one call without a clock under ``torch.profiler``: the ``stage:<name>``
  marks of its chrome trace in time order, each with the device kernels
  that ran since the mark before it.

    python3 scripts/torch_sync_sites.py [--cells a,b] [--n 256]

``--n`` cuts the cells to n^3 (the box with them); ``--device cpu``
rehearses the script without a card (no sync warnings there).  Prints
one JSON line per cell and writes all of them to
``chiprun_out/sync_sites.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SYNC_TEXT = "synchroniz"


def _site(stack) -> str:
    """``file:line function`` of the innermost program frame of
    ``stack``, else of the innermost benchmark frame, else ``other:``
    with the thread and the innermost frames."""
    for pkg in ("fastbox_tpu_torch", "portbench"):
        for fr in reversed(stack):
            if f"/{pkg}/" in fr.filename:
                rel = os.path.relpath(fr.filename, ROOT)
                return f"{rel}:{fr.lineno} {fr.name}"
    return f"other: thread {threading.current_thread().name}: " \
        + " > ".join(f"{os.path.basename(fr.filename)}:{fr.lineno} "
                     f"{fr.name}" for fr in stack[-4:])


def sync_sites(call, cuda: bool) -> dict[str, int]:
    """Sites of the synchronising operations of ``call()``, counted."""
    import torch

    sites: dict[str, int] = {}

    def hook(message, category, filename, lineno, file=None, line=None):
        if SYNC_TEXT in str(message):
            s = _site(traceback.extract_stack()[:-1])
            sites[s] = sites.get(s, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        if cuda:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            call()
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(0)
    return dict(sorted(sites.items(), key=lambda kv: -kv[1]))


def stage_marks(call) -> list:
    """[(stage, kernels since the mark before it)] of one profiled call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        call()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    marks = sorted((e["ts"], e["name"][6:]) for e in events
                   if str(e.get("name", "")).startswith("stage:"))
    kernels = sorted(e["ts"] for e in events if e.get("cat") == "kernel")
    out, j = [], 0
    for ts, name in marks:
        k = j
        while j < len(kernels) and kernels[j] < ts:
            j += 1
        out.append((name, j - k))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default="")
    ap.add_argument("--n", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=2 ** 31 + 77)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from fastbox_tpu_torch import timing
    from portbench.lib import harness, keys

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda and device.index is None:
        device = torch.device("cuda", 0)
    if cuda and not torch.cuda.is_available():
        print("torch_sync_sites: no CUDA card", file=sys.stderr)
        return 2
    m = harness.load_manifest()
    cells = args.cells.split(",") if args.cells else \
        [w["name"] for w in m["workloads"]]
    results = []
    for cell in cells:
        _, config, traffic = harness.cell_files(m, cell)
        if args.n:
            config = dict(config, nsamp=args.n, box_mpc=config["box_mpc"]
                          * args.n / config["nsamp"])
        entry = harness.load_module("entries", traffic["entry"])
        prog = entry.build(config, traffic, device)
        R = prog.realisations
        for k in range(int(traffic["warmup_calls"])):
            prog.call(keys.realisation_seeds(args.seed, -1 - k, R))
        clock = timing.StageClock(device)
        sites = sync_sites(
            lambda: prog.call(keys.realisation_seeds(args.seed, 0, R),
                              clock), cuda)
        clock.ms()
        counts = clock.counts() if hasattr(clock, "counts") else {}
        marks = stage_marks(
            lambda: prog.call(keys.realisation_seeds(args.seed, 1, R)))
        prog.close()
        program = sum(v for s, v in sites.items()
                      if s.startswith("fastbox_tpu_torch/"))
        counted = sum(v for k, v in counts.items() if k.startswith("sync."))
        res = {"cell": cell, "n": int(config["nsamp"]),
               "realisations": R, "device": str(device),
               "program_syncs": program, "counted_syncs": counted,
               "sites": sites, "counts": counts,
               "marks": len(marks), "marks_first": marks[:24]}
        if cuda:
            res["card"] = torch.cuda.get_device_name(device)
        print(json.dumps(res), flush=True)
        results.append(res)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "sync_sites.json").write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
