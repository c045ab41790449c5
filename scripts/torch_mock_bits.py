"""The mock entry points' outputs of two checkouts, compared bit for bit.

Runs the sharded ensemble step and the single and chained pipelines of
``portbench/configs/im_mock_4gpc_256.json`` on a one-rank mesh, in the
benchmark's cells and beside them, once for each ``--root`` (a process of
its own that imports ``fastbox_tpu_torch`` from that checkout), and
requires every output of every case to hold the same bits in both:

  step_b8       the step, seeds 0-7 (the cell mock256.step_b8)
  step_v2t      the step with pallas_pk='v2t' (K4t), seeds 0-7
  step_instr    the step with a 15 m beam, a k_par high-pass, the plain
                P(k) reduction and a pk_debias, seeds 0-3
  chain16       make_chained_pipeline on keys 0-15 (mock256.chain16)
  aniso_k5      make_pipeline on a 4 x 4 x 2 Gpc box (K5), keys 0-1
  single_instr  make_pipeline with 'vz' draws (K9b), the beam, the
                high-pass, K5 on the cube and a pk_debias, keys 0-1

    python3 scripts/torch_mock_bits.py --root build/parent --root . \\
        [--device cuda:0] [--n 256] [--out build/mock_bits]

Unpack the other checkout's ``fastbox_tpu_torch/`` under ``build/parent``
with ``git archive``.  Prints one JSON line per case and root (its time
and, on a card, its peak of allocated device memory), then one per case
with the comparison, and exits 1 where any output differs.  On the CPU
use a small ``--n`` (16).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
CONFIG = HERE / "portbench" / "configs" / "im_mock_4gpc_256.json"
ANISO_BOX = (4e3, 4e3, 2e3)
INSTR = dict(beam_dish_m=15.0, kpar_min=0.02)
CASES = ("step_b8", "step_v2t", "step_instr", "chain16", "aniso_k5",
         "single_instr")


def worker(root: str, device: str, n: int, out: str) -> None:
    sys.path.insert(0, str(Path(root).resolve()))
    import tempfile

    import torch
    import torch.distributed as dist

    from fastbox_tpu_torch.cosmology import build_cosmology
    from fastbox_tpu_torch.grid import GridSpec
    from fastbox_tpu_torch.parallel import make_mesh
    from fastbox_tpu_torch.parallel.mesh import init_single_rank
    from fastbox_tpu_torch.parallel.sharded import make_sharded_ensemble_step
    from fastbox_tpu_torch.pipeline import (PipelineConfig,
                                            make_chained_pipeline,
                                            make_pipeline)

    spec = json.loads(CONFIG.read_text())
    z = float(spec["redshift"])
    cosmo = build_cosmology(spec["cosmology"], redshift=z, device=device)
    base = PipelineConfig(**spec["pipeline"])
    grid = GridSpec.create(box_scale=float(spec["box_mpc"]), nsamp=n,
                           redshift=z)
    aniso = GridSpec.create(box_scale=ANISO_BOX, nsamp=n, redshift=z)
    debias = tuple(float(v) for v in
                   torch.linspace(-1e-3, 1e-3, base.nbins - 1))
    init_single_rank(torch.device(device), tempfile.mkdtemp(prefix="bits_"))
    mesh = make_mesh(device=device)

    def step(cfg, seeds):
        fn = make_sharded_ensemble_step(mesh, grid, cosmo, cfg, device)
        return fn(seeds=seeds)

    def single(g, cfg, keys):
        fn = make_pipeline(g, cosmo, cfg, device)
        outs = [fn(k) for k in keys]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    replace = dataclasses.replace
    runs = {
        "step_b8": lambda: step(base, list(range(8))),
        "step_v2t": lambda: step(replace(base, pallas_pk="v2t"),
                                 list(range(8))),
        "step_instr": lambda: step(replace(base, **INSTR, pallas_pk="off",
                                           pk_debias=debias), list(range(4))),
        "chain16": lambda: make_chained_pipeline(grid, cosmo, base, device)(
            generators=list(range(16))),
        "aniso_k5": lambda: single(aniso, base, [0, 1]),
        "single_instr": lambda: single(grid, replace(
            base, **INSTR, pallas_draw="vz", pallas_pk="on",
            pk_debias=debias), [0, 1]),
    }
    cuda = torch.device(device).type == "cuda"
    saved = {}
    for name in CASES:
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = {k: v.detach().cpu() for k, v in runs[name]().items()}
        saved[name] = res
        print(json.dumps({"root": root, "case": name,
                          "s": time.perf_counter() - t0,
                          "peak_bytes": torch.cuda.max_memory_allocated()
                          if cuda else None}), flush=True)
    torch.save(saved, out)
    dist.destroy_process_group()


def same_bits(a, b) -> bool:
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return torch.equal(a.contiguous().reshape(-1).view(torch.uint8),
                       b.contiguous().reshape(-1).view(torch.uint8))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", action="append", default=None)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--out", default=str(HERE / "build" / "mock_bits"))
    ap.add_argument("--worker", nargs=2, metavar=("ROOT", "FILE"))
    a = ap.parse_args()
    if a.worker:
        worker(a.worker[0], a.device, a.n, a.worker[1])
        return 0
    import torch

    roots = a.root or ["."]
    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    files = []
    for i, root in enumerate(roots):
        files.append(out / f"root{i}.pt")
        subprocess.run([sys.executable, __file__, "--device", a.device,
                        "--n", str(a.n), "--worker", root, str(files[-1])],
                       check=True)
    if len(roots) < 2:
        return 0
    got = [torch.load(f) for f in files]
    ok = True
    for name in CASES:
        diff = [k for k in got[0][name] if k not in got[1][name]
                or not same_bits(got[0][name][k], got[1][name][k])]
        nan = {k: int(v.isnan().sum()) for k, v in got[0][name].items()}
        ok &= not diff and got[0][name].keys() == got[1][name].keys()
        print(json.dumps({"case": name, "equal": not diff, "differ": diff,
                          "nan": nan}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
