"""The port's truth gate: each configuration variant's cleaned P(k) against
a float64 oracle on the same draws, beside the float32 conditioning floor.

Counterpart of ``scripts/truth_gate.py``, in two phases:

  # the f64 oracle and the f32 floor, on the CPU
  python -m fastbox_tpu_torch.truth_gate truth --nsamp 128 --keys 4
  # the variants, on the card (or --cpu), against that truth
  python -m fastbox_tpu_torch.truth_gate check \\
      --truth build/truth_gate_torch_128.npz

``truth`` draws, per key, the five arrays of ``pipeline.draw_inputs`` from
a CPU ``torch.Generator`` seeded with the key, in float32, so that the
stream is the same on every machine.  The port in float64 on those draws
(cast up: the counterpart of fastbox_tpu's ``draw_dtype='float32'``) is
the oracle; the port in float32 on the same draws, on the CPU, is the
floor.  ``check`` runs each variant in float32 on the same draws and
reports its per-bin relative error against the oracle beside the floor.  A
variant whose error is comparable to the floor is conditioning-limited
(admissible); one far above it is less accurate.

The gate keeps these draws rather than scripts/truth_gate.py's
``jax.random`` keys, which the port reproduces (``keys``): on keys 1000
and 1001 at 16^3 the keyed realisation leaves ~1e-3 of the density power
in bin 16, where K4t's float64 prefix differences differ from K4 by
4.3e-6 of the bin, above the 1e-6 per bin that
tests/test_torch_truth_gate.py holds 'pk_v2t' to.  So ``check`` refuses a
truth file of scripts/truth_gate.py: a per-bin comparison across two
streams would measure realisation scatter, not accuracy.  The port's
float64 pipeline is itself held to fastbox_tpu's float64 gate
configuration on identical draws (tests/test_torch_truth_gate.py), which
chains this oracle to the reference.  Files go under ``build/`` by
default, never beside the JAX package's ``truth_gate_*.npz``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from .cosmology import build_cosmology
from .device import resolve
from .grid import GridSpec
from .ops import mmfft
from .ops.cuda.mmdft import supported_length
from .pipeline import (PipelineConfig, draw_inputs, make_chained_pipeline,
                       make_pipeline)

__all__ = ["STREAM", "VARIANTS", "SKIPPED", "gate_draws", "run_keys",
           "make_truth", "check_truth", "main"]

COSMO = dict(Omega_c=0.25, Omega_b=0.05, h=0.7, n_s=0.95, sigma8=0.8)
# The realisation stream a truth file was drawn from: draw_inputs on a CPU
# torch.Generator in float32.
STREAM = "torch-cpu-float32"
BUILD = Path(__file__).resolve().parents[1] / "build"

# name -> (PipelineConfig fields, through make_chained_pipeline, the K10
# route on): the variants of scripts/truth_gate.py that mean something on
# the card
VARIANTS = {
    "native_highest": ({}, False, False),
    "pca_subspace": (dict(pca_exact=False), False, False),
    "pk_v2t": (dict(pallas_pk="v2t"), False, False),
    "eigh_hoist": (dict(eigh_hoist="on"), True, False),
    "pallas_dft": ({}, False, True),
    "fg_pow": (dict(fg_spectral="pow"), False, False),
    "bm_draw": (dict(draw_method="box_muller"), False, False),
}
_MXU = ("MXU precision tier: the port accepts the knob and ignores it "
        "(pipeline.py), so the run would repeat native_highest")
_PAIR = "matmul DFT pair: on ROADMAP.md's do-not-port list"
# scripts/truth_gate.py's other variants, recorded as skipped
SKIPPED = {
    "mm_highest": _MXU, "mm3d_high": _MXU, "all_high": _MXU,
    "fft_pair": _PAIR, "fft_pair_high": _PAIR, "vel_default": _MXU,
    "vel_highest": _MXU, "vel_high": _MXU, "vel_high_all_highest": _MXU,
    "pca_high": _MXU, "mm3d_default": _MXU, "dx_default": _MXU,
    "fwd_default": _MXU, "mm3d_split": _MXU, "all_split": _MXU,
}
# scripts/truth_gate.py's order
NAMES = ("native_highest", "mm_highest", "mm3d_high", "all_high", "fft_pair",
         "fft_pair_high", "pca_subspace", "vel_default", "vel_highest",
         "vel_high", "fg_pow", "vel_high_all_highest", "pca_high", "pk_v2t",
         "eigh_hoist", "mm3d_default", "dx_default", "fwd_default",
         "mm3d_split", "all_split", "pallas_dft", "bm_draw")


def _log(msg: str) -> None:
    print(msg, flush=True)


def gate_draws(grid: GridSpec, key: int, method: str = "erfinv") -> dict:
    """The five float32 draws of realisation ``key``, on the CPU."""
    return draw_inputs(grid, torch.Generator().manual_seed(int(key)),
                       torch.float32, method=method)


def run_keys(grid: GridSpec, cosmology, config: PipelineConfig, keys,
             device, chained: bool = False) -> tuple:
    """(k, pk_cleaned, pk_density, sigma_data) of ``config`` over ``keys``
    on ``device``, float64 numpy with one row per key.  Each key's draws
    are made when its run starts; ``chained`` runs one
    ``make_chained_pipeline`` call over all keys, which takes every key's
    draws at once."""
    method = config.draw_method
    if chained:
        fn = make_chained_pipeline(grid, cosmology, config, device)
        out = fn(draws=[gate_draws(grid, k, method) for k in keys])
        outs = [{n: v[i] for n, v in out.items()} for i in range(len(keys))]
    else:
        fn = make_pipeline(grid, cosmology, config, device)
        outs = [fn(draws=gate_draws(grid, k, method)) for k in keys]

    def stack(name):
        return np.stack([o[name].double().cpu().numpy() for o in outs])

    return (stack("k")[0], stack("pk_cleaned"), stack("pk_density"),
            stack("sigma_data"))


def _rel(a, t):
    """Per-element |a-t|/t with empty (NaN) bins masked out."""
    good = np.isfinite(t) & (np.abs(t) > 0)
    r = np.zeros_like(t)
    r[good] = np.abs(a[good] - t[good]) / np.abs(t[good])
    return r


def make_truth(grid: GridSpec, keys, draw_method: str = "erfinv",
               out=None, log=_log) -> dict:
    """The f64 oracle and the f32 floor of ``keys`` on the CPU, as the
    arrays of a truth file (written to ``out`` when given)."""
    keys = [int(k) for k in keys]
    cosmology = build_cosmology(COSMO, redshift=grid.redshift)
    config = PipelineConfig(draw_method=draw_method)
    log(f"[truth] f64 oracle on f32 draws, {grid.N}^3, box "
        f"{(grid.Lx, grid.Ly, grid.Lz)}, {len(keys)} keys, "
        f"draw={draw_method} ...")
    k, t_c, t_d, t_s = run_keys(grid, cosmology, dataclasses.replace(
        config, dtype="float64"), keys, "cpu")
    log("[truth] f32 on the same draws (conditioning floor) ...")
    _, f_c, f_d, f_s = run_keys(grid, cosmology, config, keys, "cpu")
    floor = np.max(_rel(f_c, t_c), axis=0)
    log(f"[truth] cleaned-P(k) f32 floor per bin: max={floor.max():.3e}  "
        f"low5={floor[:5].max():.3e}")
    truth = dict(k=k, pk_cleaned=t_c, pk_density=t_d, sigma=t_s,
                 f32_pk_cleaned=f_c, f32_pk_density=f_d, f32_sigma=f_s,
                 keys=np.asarray(keys),
                 meta=np.asarray([grid.N, grid.Lx, grid.redshift]),
                 box_scale=np.asarray([grid.Lx, grid.Ly, grid.Lz]),
                 draw_method=np.asarray(draw_method),
                 stream=np.asarray(STREAM))
    if out is not None:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        np.savez(out, **truth)
        log(f"[truth] wrote {out}")
    return truth


def check_truth(truth, variants=None, device=None, log=_log) -> tuple:
    """Run ``variants`` (default: every name of scripts/truth_gate.py) on
    ``device`` (None: the card) against ``truth`` (a truth file or
    ``make_truth``'s dict).  Returns (summary, spectra): the summary has
    scripts/truth_gate.py's keys, and ``spectra[name]`` the variant's
    ``pk_cleaned``, ``pk_density`` and ``sigma`` per key."""
    if not isinstance(truth, dict):
        with np.load(truth) as f:
            truth = dict(f)
    if "stream" not in truth or str(truth["stream"]) != STREAM:
        raise ValueError(
            f"truth file is not of the {STREAM!r} stream (a file of "
            "scripts/truth_gate.py holds jax.random threefry draws, which "
            "the port cannot reproduce; make one with `python -m "
            "fastbox_tpu_torch.truth_gate truth`)")
    nsamp, _, redshift = truth["meta"]
    grid = GridSpec.create(box_scale=tuple(truth["box_scale"]),
                           nsamp=int(nsamp), redshift=float(redshift))
    device = resolve(device)
    cosmology = build_cosmology(COSMO, redshift=grid.redshift, device=device)
    keys = [int(s) for s in truth["keys"]]
    truth_dm = str(truth["draw_method"])
    t_c, t_d = truth["pk_cleaned"], truth["pk_density"]
    floor_rel = _rel(truth["f32_pk_cleaned"], t_c)
    names = NAMES if variants is None else list(variants)
    unknown = [n for n in names if n not in VARIANTS and n not in SKIPPED]
    if unknown:
        raise ValueError(f"unknown variants {unknown}; known: {NAMES}")

    results, spectra = {}, {}
    for name in names:
        if name in SKIPPED:
            log(f"[check] {name:16s} SKIPPED: {SKIPPED[name]}")
            results[name] = {"skipped": SKIPPED[name]}
            continue
        kw, chained, route = VARIANTS[name]
        if route and not supported_length(grid.shape[1]):
            reason = (f"K10 takes no axis of length {grid.shape[1]} (ops/"
                      "cuda/mmdft.supported_length): the cube transforms "
                      "stay on torch.fft and the run would repeat "
                      "native_highest")
            log(f"[check] {name:16s} SKIPPED: {reason}")
            results[name] = {"skipped": reason}
            continue
        config = PipelineConfig(**kw)
        if config.draw_method != truth_dm:
            log(f"[check] {name:16s} SKIPPED: variant draw_method="
                f"'{config.draw_method}' but truth file is '{truth_dm}' — "
                "different realisation streams are not per-bin comparable "
                "(generate a matching truth with `truth --draw-method "
                f"{config.draw_method}`)")
            results[name] = {"skipped": f"stream mismatch vs {truth_dm}"}
            continue
        saved = mmfft.PALLAS_DFT
        mmfft.PALLAS_DFT = route
        try:
            _, c, dd, s = run_keys(grid, cosmology, config, keys, device,
                                   chained=chained)
        finally:
            mmfft.PALLAS_DFT = saved
        spectra[name] = dict(pk_cleaned=c, pk_density=dd, sigma=s)
        rel = _rel(c, t_c)
        rel_d = _rel(dd, t_d)
        # the signed mean over keys per low bin tells a systematic bias
        # from zero-mean rounding scatter
        good = np.isfinite(t_c) & (np.abs(t_c) > 0)
        signed = np.where(good, (c - t_c) / np.where(good, np.abs(t_c), 1.0),
                          0.0)
        results[name] = {
            "pk_cleaned_max": float(rel.max()),
            "pk_cleaned_low5": float(rel[:, :5].max()),
            "pk_cleaned_bins": [float(v) for v in rel.max(axis=0)[:8]],
            "pk_density_max": float(rel_d.max()),
            "signed_mean_low5": [float(v) for v in
                                 np.mean(signed, axis=0)[:5]],
        }
        log(f"[check] {name:16s} cleaned max={rel.max():.3e} "
            f"low5={rel[:, :5].max():.3e} density={rel_d.max():.3e}")

    summary = {"floor": float(floor_rel.max()),
               "floor_low5": float(floor_rel[:, :5].max()),
               "floor_bins": [float(v) for v in floor_rel.max(axis=0)[:8]],
               "nsamp": int(nsamp), "keys": keys, "variants": results}
    return summary, spectra


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m fastbox_tpu_torch.truth_gate")
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("truth")
    t.add_argument("--nsamp", type=int, default=128)
    t.add_argument("--box", type=float, default=2e3, help="box side, Mpc")
    t.add_argument("--redshift", type=float, default=0.8)
    t.add_argument("--keys", type=int, default=4)
    t.add_argument("--key0", type=int, default=1000)
    t.add_argument("--out", default=None,
                   help="default build/truth_gate_torch_<nsamp>.npz")
    t.add_argument("--draw-method", default="erfinv",
                   choices=["erfinv", "box_muller"],
                   help="density-draw stream the truth is computed on "
                        "(a non-default method needs its own truth file)")
    c = sub.add_parser("check")
    c.add_argument("--truth", default=str(BUILD / "truth_gate_torch_128.npz"))
    c.add_argument("--variants", default=None,
                   help="comma list; default all")
    c.add_argument("--cpu", action="store_true",
                   help="run the check phase on the CPU")
    c.add_argument("--out", default=str(BUILD / "TRUTH_GATE_TORCH.json"))
    args = ap.parse_args(argv)
    if args.cmd == "truth":
        grid = GridSpec.create(box_scale=args.box, nsamp=args.nsamp,
                               redshift=args.redshift)
        make_truth(grid, range(args.key0, args.key0 + args.keys),
                   args.draw_method,
                   args.out or BUILD / f"truth_gate_torch_{args.nsamp}.npz")
        return
    summary, _ = check_truth(
        args.truth, args.variants.split(",") if args.variants else None,
        "cpu" if args.cpu else None)
    print(json.dumps(summary), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"[check] wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
