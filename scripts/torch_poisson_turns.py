"""R2/R2w (the port's Poisson draws) of one or two checkouts, in turns.

Times ``fastbox_tpu_torch``'s ``row_poisson_cuda`` (R2, the rate as rows
of (N, N) planes) and ``key_poisson_cuda`` (R2w, the rate as one field) at
float32 on one key, on the 256^3 halo rate of ``chip_smoke.py``'s phases
R and K, on its rows 64-127 (one rank's slab of a 4-way mesh) and on the
rate clamped to 9.99 (all Knuth).  Each time is ``chip_smoke.median_ms``
(CUDA events around back-to-back calls, median of 11); beside it, each
launch's device ms per call from ``torch.profiler``
(``chip_smoke.poisson_split``).  With two ``--root``s the checkouts run in
turns, A B B A per round, each turn a process of its own that imports
``fastbox_tpu_torch`` from its checkout (the kernels built in that
checkout's ``build/``), and each case's counts must be equal across the
checkouts.  Each turn also reports, from its counts of the halo rate, the
work a lane per element leaves idle: the mean Knuth steps (count + 1) of
an element with a rate in (0, 10), the mean over 32-element chunks of the
chunk's largest, and the share of chunks holding a rate of 10 or more.

    python3 scripts/torch_poisson_turns.py [--root A [--root B]] [--rounds 1]

Prints the card's name and power limit, then one JSON line per turn.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SLAB = (64, 64)   # rows 64-127: one rank's slab of a 4-way mesh at 256^3
SEED = 2 ** 32 + 5
TAG = 301


def smoke():
    """This checkout's chip_smoke.py, loaded by path (its median_ms,
    poisson_split, halo_rate)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(root: str) -> None:
    import torch

    cs = smoke()
    sys.path.insert(0, str(Path(root).resolve()))
    from fastbox_tpu_torch.keys import PRNGKey
    from fastbox_tpu_torch.ops.cuda import _build, row_draw
    from fastbox_tpu_torch.parallel.rng import row_keys

    _build.load_library()
    dev = torch.device("cuda")
    halo = cs.halo_rate(dev)
    r0, n = SLAB
    rates = {"halo": halo[None], "slab": halo[None, r0:r0 + n].contiguous(),
             "knuth": halo.clamp(max=9.99)[None]}
    rk, _ = row_keys([SEED], dev)
    fk = PRNGKey(SEED)[None].to(dev)
    calls = {f"R2 {k}": (lambda lam=lam: row_draw.row_poisson_cuda(
        rk, TAG, 0, lam)) for k, lam in rates.items()}
    calls.update({f"R2w {k}": (lambda lam=lam: row_draw.key_poisson_cuda(
        fk, lam)) for k, lam in rates.items()})
    counts = calls["R2w halo"]()[0]
    loop = (halo > 0) & (halo < 10)
    steps = torch.where(loop, counts + 1, torch.zeros_like(counts))
    out = {"root": root, "halo": {
        "knuth_steps_mean": steps[loop].mean().item(),
        "knuth_steps_chunk_max": steps.view(-1, 32).amax(1).mean().item(),
        "chunks_with_rejection": (halo >= 10).view(-1, 32).any(1)
        .float().mean().item()}, "cases": {}}
    for name, fn in calls.items():
        counts = fn().cpu().numpy()
        out["cases"][name] = {
            "ms": cs.median_ms(fn),
            "split": {k: v[0] for k, v in cs.poisson_split(fn).items()},
            "sha256": hashlib.sha256(counts.tobytes()).hexdigest()[:16]}
    print(json.dumps(out), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", action="append")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--worker")
    args = ap.parse_args()
    if args.worker:
        worker(args.worker)
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_poisson_turns: no CUDA card")
    roots = args.root or [str(HERE)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    order = roots + roots[::-1] if len(roots) == 2 else roots
    hashes = {}
    for _ in range(args.rounds):
        for root in order:
            run = subprocess.run([sys.executable, __file__, "--worker", root],
                                 capture_output=True, text=True, check=True)
            line = run.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            for name, case in json.loads(line)["cases"].items():
                hashes.setdefault(name, set()).add(case["sha256"])
    differ = [name for name, h in hashes.items() if len(h) > 1]
    print(json.dumps({"counts_equal_across_turns": not differ,
                      "differ": differ}), flush=True)
    if differ:
        raise SystemExit(f"torch_poisson_turns: counts differ: {differ}")


if __name__ == "__main__":
    main()
