"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  It sets the
program up, warms up the cell's shapes, makes back-to-back calls for
``--seconds`` seconds, checks a sample of the calls against the plain
reference, and prints one JSON object as the last line of standard output
(``--trace 0``: the cell's end-to-end metrics; ``--trace 1``: its
per-layer metrics, the device's busy time and a breakdown).  The numbers
compared, each beside its limit, are the last lines of standard error and
the result's last key.  Without a CUDA card (or with fewer cards than the
cell asks for) it exits with 2 and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _finite(obj):
    """``obj`` with every non-finite float as None (JSON has no inf)."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite(v) for v in obj]
    return obj


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # load from one process with few host threads, for steady runs
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    # every build and kernel cache at a fixed place inside the checkout
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    sys.path.insert(0, str(ROOT))

    import torch

    from portbench.lib import harness

    try:
        manifest = harness.load_manifest()
        chips = int(harness._named(manifest["workloads"],
                                   args.workload)["chips"])
    except (OSError, KeyError, ValueError) as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    try:
        result, lines = harness.execute(
            args.workload, args.seed, args.seconds, bool(args.trace),
            torch.device("cuda", 0), T_START)
    except Exception:
        traceback.print_exc()
        return 1
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: loaded modules of JAX or the JAX package: "
              f"{found}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
