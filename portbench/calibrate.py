"""Readings that set the limits of a cell's compared numbers.

    python3 portbench/calibrate.py --workload <cell> --seeds <s> ... \\
        --control-seeds <s> ...

For each of ``--seeds`` it drives the cell's entry as a run does (the
warm-up, then as many calls as a run checks, with the keys of that seed)
and compares them with the reference: the program's readings.  For each
of ``--control-seeds`` it puts the reference computed in bfloat16
(``reference/control.py``) in the program's place for the same calls:
the control's readings.  It prints one JSON line a seed and a summary
line: per number, the largest program reading and the smallest control
reading.  The benchmark's runs do not run it.  It needs a CUDA card.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell: str, seeds, control_seeds, device, config=None,
             traffic=None, emit=print) -> dict:
    """Run the program on ``seeds`` and the control on ``control_seeds``;
    ``emit`` gets one JSON line a seed; returns the summary."""
    import torch

    from portbench.lib import harness, keys
    from portbench.reference.control import bf16_round

    _, cfg, trf = harness.cell_files(harness.load_manifest(), cell)
    config, traffic = config or cfg, traffic or trf
    entry = harness.load_module("entries", traffic["entry"])
    n_calls = int(traffic["check_calls"])
    R = int(traffic["realisations_per_call"])

    def calls(s):
        return [keys.realisation_seeds(s, i, R) for i in range(n_calls)]

    runs = []
    if seeds:
        prog = entry.build(config, traffic, device)
        for k in range(int(traffic["warmup_calls"])):
            prog.call(keys.realisation_seeds(seeds[0], -1 - k, R))
        runs = [(s, [(sd, prog.call(sd)) for sd in calls(s)]) for s in seeds]
        prog.close()
        del prog
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    summary: dict = {"program_max": {}, "control_min": {}}
    for s, samples in runs:
        t = time.perf_counter()
        g = entry.gaps(config, traffic, samples, device)
        emit(json.dumps({"side": "program", "seed": s, "gaps": g,
                         "reference_s": time.perf_counter() - t}))
        for k, v in g.items():
            summary["program_max"][k] = max(
                summary["program_max"].get(k, 0.0), v)
    if control_seeds:
        ctl = entry.reference(config, traffic, device, quant=bf16_round)
        for s in control_seeds:
            g = entry.gaps(config, traffic,
                           [(sd, ctl(sd)) for sd in calls(s)], device)
            emit(json.dumps({"side": "control", "seed": s, "gaps": g}))
            for k, v in g.items():
                summary["control_min"][k] = min(
                    summary["control_min"].get(k, float("inf")), v)
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    summary = readings(args.workload, args.seeds, args.control_seeds, dev,
                       emit=lambda line: print(line, flush=True))
    summary["device"] = torch.cuda.get_device_name(dev)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
