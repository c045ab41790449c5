#!/usr/bin/env python3
"""Smoke test of fastbox_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA GPU (written for an
H100, sm_90a) and the CUDA toolkit.  It exits non-zero, printing no result,
without a GPU or without the repository beside it.  Phases, each fatal on
failure:

  1. the card's name and power limit (nvidia-smi);
  2. build the four kernels K1-K4 from fastbox_tpu_torch/csrc (timed);
  3. each kernel against its plain PyTorch twin on the card, at the shapes
     the 256^3 pipeline gives it, with CUDA-event times (median of 11);
  4. the pipeline at 256^3 in a 4 Gpc box at z=0.8 (bench.py's defaults),
     f32: three realisations, one with sigma_NL raised so the RSD remap
     takes the exact tier (K3), then two realisations at 512^3, with
     launch counters reset just before and read just after;
  5. a truth check: the 256^3 pipeline in f32 on the card against the port
     on the CPU in f64 (plain twins), on the same supplied draws.

The last two lines of standard output are the per-kernel JSON and the
device JSON.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

COSMO = dict(Omega_c=0.25, Omega_b=0.05, h=0.7, n_s=0.95, sigma8=0.8)
BOX, Z = 4e3, 0.8
REPS = 11
KERNELS = {
    "add_scaled_normal": ("fastbox_tpu_torch/csrc/noise.cu",
                          "fastbox_tpu/ops/pallas/noise.py:94"),
    "rsd_remap_wrap": ("fastbox_tpu_torch/csrc/rsd_fused.cu",
                       "fastbox_tpu/ops/pallas/rsd_fused.py:198"),
    "interp_sorted": ("fastbox_tpu_torch/csrc/rsd_interp.cu",
                      "fastbox_tpu/ops/pallas/rsd_interp.py:53"),
    "binned_pk_half_dual_v2": ("fastbox_tpu_torch/csrc/binned_pk_v2.cu",
                               "fastbox_tpu/ops/pallas/binned_pk_v2.py:90"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def median_ms(fn) -> float:
    """Median CUDA-event time of ``fn`` over REPS calls, after one warm-up."""
    fn()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def norm_err(got, want) -> float:
    """max|got - want| / max|want| (rows whose values cross zero make a
    pointwise relative error meaningless)."""
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max()).item()


def rsd_inputs(grid, cosmo, cells: float, dev, seed: int):
    """(vals, vel, z, fill, wrap) at the pipeline's (N^2, N) RSD shapes, with
    velocities uniform in +-cells*dz*H (displacements up to ``cells``)."""
    from fastbox_tpu_torch.ops.cuda.rsd_fused import wrap_params

    N = grid.N
    g = torch.Generator(device=dev).manual_seed(seed)
    z = torch.as_tensor(grid.z, dtype=torch.float32, device=dev)
    dz = float(grid.z[1] - grid.z[0])
    Hz = 100.0 * cosmo.h * cosmo.Ea
    vals = torch.randn((N * N, N), generator=g, device=dev)
    vel = (torch.rand((N * N, N), generator=g, device=dev) * 2 - 1) \
        * (cells * dz * Hz)
    fill = 0.5 * (vals[:, 0] + vals[:, -1])
    inv_hz = 1.0 / torch.tensor(Hz, dtype=torch.float32, device=dev)
    wrap = wrap_params(z[0], z[-1] - z[0], inv_hz, torch.float32, dev)
    return vals, vel, z, fill, wrap, inv_hz, dz


def phase_k1(dev) -> dict:
    from fastbox_tpu_torch.ops.cuda import noise as k

    N = 256
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((N * N, N), generator=g, device=dev) * 300.0
    scale = torch.full((N,), 120.0, device=dev)
    n = torch.randn((N * N, N), generator=g, device=dev)
    # supplied normals: exact to 1 ulp (the kernel rounds as the twin does)
    out_k, mx_k = k.add_scaled_normal_cuda(x, scale, normals=n,
                                           return_max=True)
    out_p, mx_p = k.add_scaled_normal_plain(x, scale, normals=n,
                                            return_max=True)
    ulps = (out_k.view(torch.int32).long()
            - out_p.view(torch.int32).long()).abs().max().item()
    check(ulps <= 1, f"K1 supplied mode: {ulps} ulp from the twin")
    check(mx_k.item() == mx_p.item(), "K1 supplied mode: max differs")
    err = (out_k - out_p).abs().max().item()
    # generated normals: moments within 5 sigma, seed determinism, exact max
    zero = torch.zeros_like(x)
    one = torch.ones_like(scale)
    s1 = torch.tensor([12345], dtype=torch.int64, device=dev)
    s2 = torch.tensor([12346], dtype=torch.int64, device=dev)
    a, amax = k.add_scaled_normal_cuda(zero, one, seed=s1, return_max=True)
    b = k.add_scaled_normal_cuda(zero, one, seed=s1)
    c = k.add_scaled_normal_cuda(zero, one, seed=s2)
    check(torch.equal(a, b), "K1: same seed, different bits")
    check(not torch.equal(a, c), "K1: different seeds, same bits")
    check(amax.item() == a.abs().max().item(), "K1: max != out.abs().max()")
    m = a.double().numel()
    mean = a.double().mean().item()
    var = a.double().var(correction=0).item()
    kurt = (a.double() ** 4).mean().item() / var**2
    check(abs(mean) < 5 / m**0.5, f"K1 mean {mean}")
    check(abs(var - 1) < 5 * (2 / m) ** 0.5, f"K1 variance {var}")
    check(abs(kurt - 3) < 5 * (96 / m) ** 0.5, f"K1 kurtosis {kurt}")
    log(f"K1 add_scaled_normal: supplied {ulps} ulp, max exact; generated "
        f"mean {mean:.3e} var {var:.6f} kurtosis {kurt:.5f} (n={m})")
    gen = torch.Generator(device=dev).manual_seed(2)
    ms = median_ms(lambda: k.add_scaled_normal_cuda(
        x, scale, seed=k.draw_seed(gen, dev), return_max=True))
    plain_ms = median_ms(lambda: k.add_scaled_normal_plain(
        x, scale, generator=gen, return_max=True))
    return dict(name="add_scaled_normal", max_abs_err=err, ms=ms,
                plain_ms=plain_ms)


def phase_k2(dev, grid, cosmo) -> dict:
    from fastbox_tpu_torch.ops.cuda import rsd_fused as k
    from fastbox_tpu_torch.ops.cuda.rsd_interp import interp_sorted_cuda

    errs = []
    for band, cells in ((2, 1.9), (4, 3.9)):
        vals, vel, z, fill, wrap, inv_hz, dz = rsd_inputs(grid, cosmo, cells,
                                                          dev, seed=band)
        got = k.rsd_remap_wrap_cuda(vals, vel, z, fill, wrap, band)
        want = k.rsd_remap_wrap_plain(vals, vel, z, fill, wrap, band)
        e = norm_err(got, want)
        # and the band scan equals the exact sort + interpolation, except
        # where two wrapped coordinates tie exactly in f32 with a periodic
        # image involved: there the scan order and the stable sort pick
        # different duplicates, as on the TPU (rsd_fused.py:37-40, ~1 voxel
        # in 10^7)
        s = torch.remainder(z[None, :] - vel * inv_hz - wrap[0], wrap[1]) \
            + wrap[0]
        ss, order = torch.sort(s, dim=1, stable=True)
        exact = interp_sorted_cuda(ss, torch.gather(vals, 1, order), z, fill)
        off = ((got - exact).abs() > 1e-5 * exact.abs().max()).sum().item()
        log(f"K2 rsd_remap_wrap band {band}: vs twin {e:.3e}; "
            f"{off} of {got.numel()} values off the exact tier (ties)")
        check(e <= 1e-5, f"K2 band {band}: {e} from the twin")
        check(off <= 1e-6 * got.numel(), f"K2 band {band}: {off} off exact")
        errs.append((got - want).abs().max().item())
    vals, vel, z, fill, wrap, _, _ = rsd_inputs(grid, cosmo, 1.9, dev, seed=2)
    ms = median_ms(lambda: k.rsd_remap_wrap_cuda(vals, vel, z, fill, wrap, 2))
    plain_ms = median_ms(lambda: k.rsd_remap_wrap_plain(vals, vel, z, fill,
                                                        wrap, 2))
    return dict(name="rsd_remap_wrap", max_abs_err=max(errs), ms=ms,
                plain_ms=plain_ms)


def phase_k3(dev, grid, cosmo) -> dict:
    from fastbox_tpu_torch.ops.cuda import rsd_interp as k

    vals, vel, z, fill, wrap, inv_hz, _ = rsd_inputs(grid, cosmo, 12.0, dev,
                                                     seed=3)
    s = torch.remainder(z[None, :] - vel * inv_hz - wrap[0], wrap[1]) + wrap[0]
    ss, order = torch.sort(s, dim=1, stable=True)
    vv = torch.gather(vals, 1, order).contiguous()
    got = k.interp_sorted_cuda(ss, vv, z, fill)
    want = k.interp_sorted_plain(ss, vv, z, fill)
    e = norm_err(got, want)
    log(f"K3 interp_sorted (displacements to 12 cells): vs twin {e:.3e}")
    check(e <= 1e-5, f"K3: {e}")
    ms = median_ms(lambda: k.interp_sorted_cuda(ss, vv, z, fill))
    plain_ms = median_ms(lambda: k.interp_sorted_plain(ss, vv, z, fill))
    return dict(name="interp_sorted", max_abs_err=(got - want).abs().max()
                .item(), ms=ms, plain_ms=plain_ms)


def phase_k4(dev, grid) -> dict:
    from fastbox_tpu_torch.ops import spectra
    from fastbox_tpu_torch.ops.cuda import binned_pk_v2 as k

    N, H = grid.N, grid.N // 2 + 1
    g = torch.Generator(device=dev).manual_seed(4)
    # positive powers spanning ~6 decades, like |delta_k|^2
    p1 = torch.exp(3.0 * torch.randn((N, N, H), generator=g, device=dev))
    p2 = torch.exp(3.0 * torch.randn((N, N, H), generator=g, device=dev))
    fi2 = torch.as_tensor(spectra._index_sq(grid), device=dev)
    thr = torch.as_tensor(spectra.kbin_thresholds(
        grid, spectra.default_kbins(grid, 20)), device=dev)
    wz = torch.full((H,), 2.0, device=dev)
    wz[0] = wz[-1] = 1.0
    args = (fi2, fi2, fi2[:H].contiguous(), wz, thr)
    got = k.binned_pk_half_dual_v2_cuda(p1, p2, *args)
    again = k.binned_pk_half_dual_v2_cuda(p1, p2, *args)
    ref = k.binned_pk_half_dual_v2_plain(p1.double(), p2.double(), *args[:3],
                                         wz.double(), thr)
    full = ref[0] != 0                       # populated bins
    rel = max(((a.double() - b) / b)[full].abs().max().item()
              for a, b in zip(got, ref))
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    log(f"K4 binned_pk_half_dual_v2: max rel err vs f64 {rel:.3e}, "
        f"bitwise repeatable {bitwise}")
    check(rel <= 1e-6, f"K4 rel err {rel}")
    check(bitwise, "K4 not bitwise repeatable")
    ms = median_ms(lambda: k.binned_pk_half_dual_v2_cuda(p1, p2, *args))
    plain_ms = median_ms(lambda: k.binned_pk_half_dual_v2_plain(p1, p2,
                                                                *args))
    err = max((a.double() - b).abs().max().item() for a, b in zip(got, ref))
    return dict(name="binned_pk_half_dual_v2", max_abs_err=err, ms=ms,
                plain_ms=plain_ms)


def populated_bins(grid) -> np.ndarray:
    """The retained P(k) bins (all but bin 0) that hold modes."""
    from fastbox_tpu_torch.ops import spectra

    w = np.full(grid.N // 2 + 1, 2.0)
    w[0] = w[-1] = 1.0
    thr = spectra.kbin_thresholds(grid, spectra.default_kbins(grid, 20))
    return spectra.hoisted_counts(grid, thr, w)[1:] > 0


def run_pipeline(fn, dev, label: str, grid, **kw) -> dict:
    from fastbox_tpu_torch.timing import StageClock

    clock = StageClock(dev)
    t0 = time.perf_counter()
    out = fn(clock=clock, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stages = clock.ms()
    full = populated_bins(grid)
    for key in ("pk_cleaned", "pk_density", "pk_cleaned_err"):
        v = out[key].cpu().numpy()
        check(v.shape == (19,), f"{label}: {key} shape {v.shape}")
        check(bool(np.isfinite(v[full]).all() and (v[full] >= 0).all()),
              f"{label}: {key} not finite and >= 0 in populated bins")
    check(bool(torch.isfinite(out["sigma_data"])), f"{label}: sigma_data")
    log(f"{label}: {wall * 1e3:.2f} ms wall; stages ms "
        + json.dumps({k: round(v, 3) for k, v in stages.items()}))
    return dict(out=out, wall=wall)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check needs an NVIDIA GPU")
    from fastbox_tpu_torch.cosmology import build_cosmology
    from fastbox_tpu_torch.grid import GridSpec
    from fastbox_tpu_torch.ops.cuda import _build
    from fastbox_tpu_torch.pipeline import (PipelineConfig, draw_inputs,
                                            make_pipeline)

    check("jax" not in sys.modules, "jax was imported")
    torch.set_float32_matmul_precision("highest")   # FP32 GEMMs, no TF32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log(f"nvidia-smi: {smi[0]}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.load_library()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(log in {_build.BUILD_ROOT})")
    for build_log in _build.BUILD_ROOT.glob("*/build.log"):
        for line in build_log.read_text().splitlines():
            if "Compiling entry" in line or "Used" in line:
                log("  " + line.strip())

    grid = GridSpec.create(box_scale=BOX, nsamp=256, redshift=Z)
    cosmo = build_cosmology(COSMO, redshift=Z, device=dev)
    kernels = [phase_k1(dev), phase_k2(dev, grid, cosmo),
               phase_k3(dev, grid, cosmo), phase_k4(dev, grid)]
    for r in kernels:
        log(f"{r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}"
            f" ms, max_abs_err {r['max_abs_err']:.3e}")

    # The main path: counters from zero, read right after
    cfg = PipelineConfig()
    fn256 = make_pipeline(grid, cosmo, cfg, device=dev)
    fn256_exact = make_pipeline(grid, cosmo, PipelineConfig(sigma_nl=6000.0),
                                device=dev)
    grid512 = GridSpec.create(box_scale=BOX, nsamp=512, redshift=Z)
    fn512 = make_pipeline(grid512, cosmo, cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2026)
    _build.reset_launch_counts()
    runs256 = [run_pipeline(fn256, dev, f"256^3 realisation {i}", grid,
                            generator=gen) for i in range(3)]
    before = _build.launch_counts().get("interp_sorted", 0)
    run_pipeline(fn256_exact, dev, "256^3 sigma_nl=6000 (exact RSD tier)",
                 grid, generator=gen)
    check(_build.launch_counts().get("interp_sorted", 0) > before,
          "sigma_nl=6000 did not take the exact tier")
    torch.cuda.reset_peak_memory_stats()
    run512 = [run_pipeline(fn512, dev, f"512^3 realisation {i}", grid512,
                           generator=gen) for i in range(2)]
    counts = _build.launch_counts()
    log(f"launch counts over the main path: {json.dumps(counts)}")
    for r in kernels:
        r["launches"] = counts.get(r["name"], 0)
        check(r["launches"] > 0, f"{r['name']} never launched on the main path")
    steady = statistics.median(r["wall"] for r in runs256[1:])
    log(f"256^3: {1.0 / steady:.3f} pipelines/s (median of realisations 1-2, "
        f"{steady * 1e3:.2f} ms); 512^3: {1.0 / run512[1]['wall']:.3f} "
        f"pipelines/s (realisation 1, {run512[1]['wall'] * 1e3:.2f} ms; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        " GiB)")

    # Truth check: f32 on the card vs the port in f64 on the CPU
    draws = draw_inputs(grid, torch.Generator().manual_seed(7), torch.float64)
    gpu = fn256(draws=draws)
    cosmo_cpu = build_cosmology(COSMO, redshift=Z)
    t0 = time.perf_counter()
    cpu = make_pipeline(grid, cosmo_cpu, PipelineConfig(dtype="float64"))(
        draws=draws)
    log(f"truth: f64 CPU reference took {time.perf_counter() - t0:.1f} s")
    full = populated_bins(grid)
    for name, bound in (("pk_density", 1e-4), ("pk_cleaned", 5e-2)):
        g = gpu[name].double().cpu().numpy()[full]
        c = cpu[name].numpy()[full]
        rel = np.abs(g - c) / np.abs(c)
        log(f"truth {name} per-bin rel err: "
            + " ".join(f"{v:.2e}" for v in rel))
        check(bool(np.all(rel <= bound)), f"truth {name}: max {rel.max()}")

    for r in kernels:
        src, rep = KERNELS[r["name"]]
        r.update(route="cuda", source=src, replaces=rep)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
