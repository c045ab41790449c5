"""K11a (the port's periodic COLA lattice paint) of one or more checkouts,
in turns.

Times ``fastbox_tpu_torch``'s ``cic_paint_lattice_cuda`` on a 256^3 COLA
run's own paints (the first force evaluation at each band, and the
finish's first velocity-weighted paint, captured by wrapping the engine's
``_paint``) and on uniform 512^3 displacements at B = 1, 2, 3 (and
weighted at B = 2).  Each time is ``chip_smoke.median_ms`` (CUDA events
around back-to-back calls, median of 11).  The checkouts run in turns, the
roots in order and then reversed each round (A B B A for two), each turn a
process of its own that imports ``fastbox_tpu_torch`` from its checkout
(the kernels built in that checkout's ``build/``), and each case's output
must be equal across every turn.  A turn that fails is reported and the
others still run.

    python3 scripts/torch_lattice_paint_turns.py [--root A [--root B ...]]
        [--rounds 2]

Prints the card's name and power limit, one JSON line per turn, and each
case's median over the turns of each checkout.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
NOISE_SEED = 2030
SEED = 30


def smoke():
    """This checkout's chip_smoke.py, loaded by path (its median_ms,
    check and the COLA settings)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cola_paint_inputs(cs, dev) -> dict:
    """A 256^3 COLA run's own paint inputs: the first force evaluation's
    displacements at each band, and the finish's first velocity-weighted
    paint, as (disp, B, weights)."""
    import torch
    from fastbox_tpu_torch.cosmology import build_cosmology
    from fastbox_tpu_torch.fields.cola import ColaEngine
    from fastbox_tpu_torch.fields.gaussian import white_noise
    from fastbox_tpu_torch.grid import GridSpec

    grid = GridSpec.create(box_scale=cs.BOX, nsamp=cs.COLA_N[0])
    eng = ColaEngine(grid, build_cosmology(cs.COSMO, redshift=0.0, device=dev),
                     redshift_init=cs.COLA_Z_INIT, lattice_B=3, device=dev,
                     keep_velocities=True)
    seen, inner = {}, eng._paint

    def capture(d, b, w, openband):
        key = f"band {b}" if w is None else "finish weighted"
        if key not in seen:
            seen[key] = (tuple(a.clone() for a in d), b,
                         None if w is None else w.clone())
        return inner(d, b, w, openband)

    eng._paint = capture
    eng.run(white_noise(torch.Generator(device=dev).manual_seed(NOISE_SEED),
                        grid))
    cs.check(all(f"band {b}" in seen for b in (1, 2, 3))
             and "finish weighted" in seen,
             f"COLA paints captured: {list(seen)}")
    return seen


def worker(root: str) -> None:
    import torch

    cs = smoke()
    sys.path.insert(0, str(Path(root).resolve()))
    from fastbox_tpu_torch.ops.cuda import _build
    from fastbox_tpu_torch.ops.cuda import lattice_cic as k

    _build.load_library()
    dev = torch.device("cuda")
    cases = {f"256^3 COLA {key}": v
             for key, v in cola_paint_inputs(cs, dev).items()}
    g = torch.Generator(device=dev).manual_seed(SEED)
    n = cs.COLA_N[1]
    w = torch.rand((n, n, n), generator=g, device=dev) * 2 - 1
    for B in (1, 2, 3):
        d = tuple((torch.rand((n, n, n), generator=g, device=dev) * 2 - 1) * B
                  for _ in range(3))
        cases[f"{n}^3 uniform B={B}"] = (d, B, None)
        if B == 2:
            cases[f"{n}^3 uniform B=2 weighted"] = (d, B, w)
    out = {"root": root, "cases": {}}
    for name, (d, B, wt) in cases.items():
        got = k.cic_paint_lattice_cuda(d, B, wt).cpu().numpy()
        out["cases"][name] = {
            "ms": cs.median_ms(lambda: k.cic_paint_lattice_cuda(d, B, wt)),
            "sha256": hashlib.sha256(got.tobytes()).hexdigest()[:16]}
    print(json.dumps(out), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", action="append")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--worker")
    args = ap.parse_args()
    if args.worker:
        worker(args.worker)
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_lattice_paint_turns: no CUDA card")
    roots = args.root or [str(HERE)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    turns, failed = [], []
    for _ in range(args.rounds):
        for root in roots + roots[::-1]:
            run = subprocess.run([sys.executable, __file__, "--worker", root],
                                 capture_output=True, text=True)
            if run.returncode != 0:
                failed.append(root)
                print(json.dumps({"root": root, "rc": run.returncode,
                                  "stderr": run.stderr[-2000:]}), flush=True)
                continue
            turns.append(json.loads(run.stdout.strip().splitlines()[-1]))
            print(json.dumps(turns[-1]), flush=True)
    differ = []
    for case in (turns[0]["cases"] if turns else {}):
        if len({t["cases"][case]["sha256"] for t in turns}) > 1:
            differ.append(case)
        med = {r: statistics.median(t["cases"][case]["ms"] for t in turns
                                    if t["root"] == r)
               for r in roots if any(t["root"] == r for t in turns)}
        print(f"K11a {case}: median ms " + ", ".join(
            f"{r} {v:.4f}" for r, v in med.items()), flush=True)
    print(json.dumps({"outputs_equal_across_turns": not differ,
                      "differ": differ, "failed_turns": failed}), flush=True)
    if differ or failed:
        raise SystemExit(f"torch_lattice_paint_turns: outputs differ {differ}"
                         f", failed turns {failed}")


if __name__ == "__main__":
    main()
