#!/usr/bin/env python3
"""Smoke test of fastbox_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py               # every phase below
    python3 chip_smoke.py --step-1024   # only: does a 1024^3 step fit?
    python3 chip_smoke.py --truth-256   # only: the truth gate at 256^3

from the root of a checkout, on a machine with a CUDA GPU (written for an
H100, sm_90a) and the CUDA toolkit.  It exits non-zero, printing no result,
without a GPU or without the repository beside it.  Phases, each fatal on
failure:

  1. the card's name and power limit (nvidia-smi);
  2. build the kernels (K1-K11) from fastbox_tpu_torch/csrc (timed; ptxas's
     registers and spills of every kernel);
  3. each kernel against its plain PyTorch twin on the card, at the shapes
     the 256^3 pipeline and the 256^3 COLA engine give it, with device
     times per call (median_ms: CUDA events around back-to-back calls,
     median of 11); K4 at the 256^3 and 512^3 cubes' shapes, f32 and
     f64, and on a 64^3 lattice whose kz2h does not ascend (the general
     path), against its f64 twin and bitwise repeatable; K4t (K4's
     telescoped mode) likewise and against K4 on the same inputs; K11 (lattice CIC paint,
     gather, three-mesh gather) for bands B = 1, 2, 3, and in f64 against
     the exact index_add_ scatter and gather, the paint bitwise equal to its
     twin and repeatable (f32 and f64, weighted and not, clustered
     displacements) and timed at every B beside the index_add_ paint, the
     gathers bitwise equal to their twins and repeatable (f32 and f64,
     uniform, clustered and COLA's displacements, a closed band, and wide
     bands at 64^3 that take the launcher's direct-read path) and timed at
     every B and on the force meshes and displacements of a 256^3 COLA run
     (its first band-1 and its last force evaluation) beside grid_sample,
     one and three channels; K1 0 ulp from its twin with supplied normals
     (vector and direct paths, f32 and f64), its generated normals by their
     moments and lag-1 and lag-C autocorrelations, timed beside
     torch.addcmul (supplied) and torch.normal (generated); K2 and K7
     bitwise equal to their twins at bands 2 and 4, f32 and f64, on the
     cube's rows, 512-cell rows, the anisotropic box's and 62-cell rows
     (the direct path, as are unaligned rows and K7 at band 3); K5 on
     the anisotropic 256^3 half spectra (timed at 512^3 too) and K6 on a
     256^3 and a 255^3 cube, f32 and f64 (against an f64 index_add_
     reduction), and on a reversed kz2h / permuted kz2 (the general path),
     their counts and weighted counts equal to the twins' and bitwise
     repeatable; K9a/b in supplied mode bitwise, in
     generated mode by the moments of the normals; K10 (the axis FFT) at
     every supported length, both axes and signs, f32 and f64, then at the
     K10 route's planar shapes (256, 256, 129) and (512, 512, 257) against
     its twin and complex128 torch.fft, timed beside torch.fft.fft along
     the same axis.  Each
     kernel's row also carries its bound (bytes or operations over the
     H100's published peaks) and, where one PyTorch call computes the same
     function, that call's time (library_ms);
  4. the pipeline at 256^3 in a 4 Gpc box at z=0.8 (bench.py's defaults),
     f32: three realisations, one with sigma_NL raised so the RSD remap
     takes the exact tier (K3), then two realisations at 512^3, with
     launch counters reset just before and read just after, and the pca
     stage's ms;
  5. a truth check: the 256^3 pipeline in f32 on the card against the port
     on the CPU in f64 (plain twins), on the same supplied draws;
  6. the pipeline's other entry points and configurations, each with launch
     counters reset just before and read just after: the anisotropic box
     (4 x 4 x 2 Gpc, K5) at 256^3 and 512^3; pallas_draw 'on' (K9a) and
     'vz' (K9b) at 256^3 and 512^3 with pk_density / P_nl on the mid-k
     bins; the instrument response; pca_exact=False against the exact
     clean; make_chained_pipeline (chain 16 at 256^3, eigh_hoist 'off' and
     'on') against single calls; make_ensemble_pipeline (8 x 128^3 in a
     2 Gpc box); the full-spectrum estimator binned_power_spectrum (K6) on a
     realise_density field; then the truth check of the anisotropic 256^3
     box against the port on the CPU in f64 and in f32, bin by bin;
  7. the parallel/ slice on a one-rank ('ens' 1, 'space' 1) mesh under
     NCCL: the sharded ensemble step at 256^3 with B = 8 and at 512^3 with
     B = 2 (launch counters reset just before and read just after: K8, K4
     and K1 must launch), at sigma_NL = 6000 km/s (K3), K8 bitwise equal
     to its twin on both steps' sorted nodes (f32 and f64, bands 2 and 4),
     on rows with duplicate nodes, nodes on targets and on the hull edges,
     and on 62-cell and unaligned rows and at band 3 (the direct path),
     timed on both steps' nodes, the step's remap through K7 (the batched
     remap with unwrapped coordinates, counted), the step against the
     single pipeline in noise_scheme='rows' on the same seeds,
     make_ensemble_pipeline over the mesh against the mesh-less call
     (bitwise), and rsd_method='nearest'; then the pallas_pk='v2t' path:
     the 256^3 pipeline (two realisations, counted: K4t once per
     realisation, K4 never) against the default run on the same draws, and
     one 256^3 B=2 step with 'v2t' on the same mesh, counted;
  8. the COLA engine (scripts/bench_cola.py's configuration: 256^3 in a
     4 Gpc box, z 15 -> 0 in 16 steps, lattice_B=3, spectral gradient, f32):
     three realisations with the kernels (one with keep_velocities=True and
     per-component gathers), then 512^3 in the same box and in an 8 Gpc box,
     with launch counters reset just before and read just after; then, on
     the same white noise, the engine with the plain twins on the card: the
     first force evaluation per particle, the final field (bitwise equal),
     std(delta) and the binned P(k), and bench_cola.py's health bounds;
  9. the K10 route of the cube transforms (ops/mmfft.PALLAS_DFT on, and
     off again after): the pipeline at 256^3 (three realisations) and 512^3
     (two), each with launch counters reset just before and read just
     after and K10's count held to the code's; the route's delta_x and
     vel_z against the cuFFT run on the same draws, and the truth check
     against the f64 CPU run of phase 5; COLA at 256^3 on the same white
     noise as phase 8, its K10 count held to the code's, against the cuFFT
     engine and bench_cola.py's health bounds.  Every phase before it runs
     with the route off and must launch K10 zero times;
 10. the truth gate (fastbox_tpu_torch.truth_gate) at scripts/truth_gate.py's
     defaults, 128^3 in a 2 Gpc box at z=0.8, keys 1000-1003: the f64
     oracle and the f32 floor on the CPU, then every variant that runs on
     the card (pallas_dft needs an axis K10 takes, so it runs from 256^3
     on), each against the oracle per bin: pk_density within 1e-4,
     pk_cleaned within the 5e-2 sanity bound (pca_subspace, a different
     estimator, is reported only), and pk_v2t within 1e-6 of
     native_highest; K4t counted once per key.

``--truth-256`` runs the gate at the bench size instead: the 256^3 cube in
the 4 Gpc box over 8 keys with every variant, the anisotropic 4 x 4 x 2 Gpc
box over 8 keys (native_highest; per seed, the card's largest pk_cleaned
error over the CPU f32 floor's; the cube's bin-1 worst over the keys for
the card and the floor), and the sharded step (B = 8) and the
single pipeline in noise_scheme='rows' against their f64 CPU run on the
same rows; its f64 CPU oracles take minutes.  It fails when the cube's
bin-1 worst, or the step's worst over the keys, exceeds 1.5x the CPU f32
floor's, or when the anisotropic box's worst pk_cleaned error over the
keys and the bins of unchanged membership exceeds 3x the CPU f32 floor's
worst.

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
ANISO_BOX = (4e3, 4e3, 2e3)   # a 4 x 4 Gpc footprint, 2 Gpc deep
N_MAIN, N_BIG, N_ENS = 256, 512, 128   # bench.py's sizes; the ensemble's
REPS = 11
# Published peaks of one H100 SXM (NVIDIA's data sheet, dense): HBM
# 3.35 TB/s; 67 TFLOP/s in float32 and 34 TFLOP/s in float64 outside the
# tensor cores.  The bounds count each input read once, each output written
# once, and the arithmetic per element written beside each kernel.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {torch.float32: 67e12, torch.float64: 34e12}
KERNELS = {
    "add_scaled_normal": ("fastbox_tpu_torch/csrc/noise.cu",
                          "fastbox_tpu/ops/pallas/noise.py:94"),
    "rsd_remap_wrap": ("fastbox_tpu_torch/csrc/rsd_fused.cu",
                       "fastbox_tpu/ops/pallas/rsd_fused.py:198"),
    "interp_sorted": ("fastbox_tpu_torch/csrc/rsd_interp.cu",
                      "fastbox_tpu/ops/pallas/rsd_interp.py:53"),
    "binned_pk_half_dual_v2": ("fastbox_tpu_torch/csrc/binned_pk_v2.cu",
                               "fastbox_tpu/ops/pallas/binned_pk_v2.py:90"),
    # the telescoped body of the same function (:63-71, :162-173)
    "binned_pk_half_dual_v2t": ("fastbox_tpu_torch/csrc/binned_pk_v2.cu",
                                "fastbox_tpu/ops/pallas/binned_pk_v2.py:63"),
    "cic_paint_lattice": ("fastbox_tpu_torch/csrc/lattice_cic.cu",
                          "fastbox_tpu/ops/pallas/lattice_cic.py:289"),
    "cic_gather_lattice": ("fastbox_tpu_torch/csrc/lattice_cic.cu",
                           "fastbox_tpu/ops/pallas/lattice_cic.py:355"),
    "cic_gather3_lattice": ("fastbox_tpu_torch/csrc/lattice_cic.cu",
                            "fastbox_tpu/ops/pallas/lattice_cic.py:408"),
    "binned_pk_half_dual": ("fastbox_tpu_torch/csrc/binned_pk.cu",
                            "fastbox_tpu/ops/pallas/binned_pk.py:195"),
    "binned_pk_full": ("fastbox_tpu_torch/csrc/binned_pk.cu",
                       "fastbox_tpu/ops/pallas/binned_pk.py:103"),
    "colored_half_draw": ("fastbox_tpu_torch/csrc/half_draw.cu",
                          "fastbox_tpu/ops/pallas/half_draw.py:148"),
    "colored_half_draw_vz": ("fastbox_tpu_torch/csrc/half_draw.cu",
                             "fastbox_tpu/ops/pallas/half_draw.py:100"),
    "rsd_bracket_interp": ("fastbox_tpu_torch/csrc/rsd_fused.cu",
                           "fastbox_tpu/ops/pallas/rsd_fused.py:154"),
    "banded_interp": ("fastbox_tpu_torch/csrc/banded_interp.cu",
                      "fastbox_tpu/ops/pallas/banded_interp.py:65"),
    "dft_c2c_axis": ("fastbox_tpu_torch/csrc/mmdft.cu",
                     "fastbox_tpu/ops/pallas/mmdft.py:172"),
}
COLA_Z_INIT = 15.0
COLA_N = (256, 512)      # the COLA cells; K11 is held to its twin at 256^3
K11_WIDE_N = 64          # the gathers' closed and wide bands
# K11 against its twin: the kernels sum in the twin's order with explicit
# rounding, so they should agree exactly; the bound allows f32 reordering
# of a few terms (a few ulp of the largest value).
K11_TWIN_BOUND = 1e-6
# grid_sample (the gathers' library yardstick) in f32 against K11b: its
# normalised coordinates round each position to ~N 2^-23 cells, and a
# white-noise mesh changes by its own size from one cell to the next.
GRID_SAMPLE_BOUND = 1e-4
# In f64 against the exact scatter/gather: summation order only.
K11_EXACT_BOUND = 1e-12
# K5/K6 in f64 against the f64 index_add_ twin, whose bins each add up to
# millions of terms one after another: the sum of n positive terms in that
# order is within n unit roundoffs of exact.
F64_SUM_BOUND = 2.0 ** -53
# Per-bin truth bounds, f32 on the card against f64 on the CPU, same
# draws.  pk_cleaned's is a sanity bound: the clean's 4th and 5th
# eigenvalues lie within ~1% of each other, which amplifies f32 rounding of
# the data cube into 1e-4..1e-2 of the cleaned spectrum, differently on
# each device (PERF.md, Findings).
TRUTH_BOUND = {"pk_density": 1e-4, "pk_cleaned": 5e-2}
# K10 and the route's fields against complex128 FFTs / the cuFFT run: the
# bound of fastbox_tpu's own test (tests/test_pallas_dft.py), of max|y|.
K10_BOUND = 2e-6
K10 = "dft_c2c_axis"
K10_LENGTHS = (256, 512, 768, 1024, 1536, 2048)   # supported_length's
# K10 launches per 'half' pipeline realisation on the route: the delta_x
# and vel_z inverses and the cleaned cube's forward, each on axes 0 and 1.
K10_PER_PIPELINE = 2 * 3
K4, K4T = "binned_pk_half_dual_v2", "binned_pk_half_dual_v2t"
# The truth gate: scripts/truth_gate.py's defaults, and --truth-256's cells
GATE_N, GATE_BOX, GATE_KEYS = 128, 2e3, range(1000, 1004)
GATE256_KEYS = range(1000, 1008)
# K4 in f32 against its f64 twin per populated bin: the final cast's
# rounding (~5e-8); K4t against its f64 twin, and against K4 in f32 ulp per
# bin
K4_TWIN_BOUND = 1e-7
K4T_TWIN_BOUND, K4T_K4_ULP = 1e-6, 2
# the v2t path against the default one on the same draws, per bin
V2T_BOUND = 1e-6


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def median_ms(fn) -> float:
    """Device time of one call of ``fn`` in ms: the median over REPS
    samples, after one warm-up, of CUDA events around a run of back-to-back
    calls (enough for ~2 ms of device work, at most 50) over their number.
    The queued calls hide the host's launch overhead, as on the main path;
    one call alone between two events would count it."""
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    calls = max(1, min(50, int(2.0 / max(a.elapsed_time(b), 1e-3))))
    times = []
    for _ in range(REPS):
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def norm_err(got, want) -> float:
    """max|got - want| / max|want| (rows whose values cross zero make a
    pointwise relative error meaningless)."""
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max()).item()


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def roofline(n_bytes: float, ops: float, dtype=torch.float32) -> dict:
    """bound_ms: the larger of the bytes a call must move (each input read
    once, each output written once) over the card's memory rate and its
    operations over the card's peak rate for ``dtype``; bound_by names it."""
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[dtype] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def index_add_ms(idx, terms, nb: int) -> float:
    """library_ms of a binned reduction: one ``index_add_`` of the stacked
    per-mode terms into ``nb`` bins, on bin indices computed beforehand."""
    src = torch.stack([t.reshape(-1) for t in terms], dim=1)
    return median_ms(lambda: torch.zeros((nb, src.shape[1]), dtype=src.dtype,
                                         device=src.device)
                     .index_add_(0, idx, src))


def rsd_inputs(grid, cosmo, cells: float, dev, seed: int, rows=None):
    """(vals, vel, z, fill, wrap) at the pipeline's (N^2, N) RSD shapes (or
    ``rows`` lines of sight of N cells), with velocities uniform in
    +-cells*dz*H (displacements up to ``cells``)."""
    from fastbox_tpu_torch.ops.cuda.rsd_fused import wrap_params

    N = grid.N
    M = N * N if rows is None else rows
    g = torch.Generator(device=dev).manual_seed(seed)
    z = torch.as_tensor(grid.z, dtype=torch.float32, device=dev)
    dz = float(grid.z[1] - grid.z[0])
    Hz = 100.0 * cosmo.h * cosmo.Ea
    vals = torch.randn((M, N), generator=g, device=dev)
    vel = (torch.rand((M, N), generator=g, device=dev) * 2 - 1) \
        * (cells * dz * Hz)
    fill = 0.5 * (vals[:, 0] + vals[:, -1])
    inv_hz = 1.0 / torch.tensor(Hz, dtype=torch.float32, device=dev)
    wrap = wrap_params(z[0], z[-1] - z[0], inv_hz, torch.float32, dev)
    return vals, vel, z, fill, wrap, inv_hz, dz


def unaligned(t):
    """A contiguous copy of ``t`` that starts 4 bytes past a 16-byte
    boundary: the kernels' direct paths."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def ulp_diff(a, b) -> int:
    """Largest distance in units in the last place between a and b."""
    it = torch.int32 if a.dtype == torch.float32 else torch.int64
    return (a.view(it).long() - b.view(it).long()).abs().max().item()


def phase_k1(dev) -> dict:
    """K1 at the rows' shapes (65536, 256), f32: supplied normals 0 ulp from
    the twin with the max exact, on the vector path, in f64, at 62 columns
    and on an unaligned copy (the direct path); generated normals: the same
    bits for one seed on both paths, others for another seed, moments and
    lag-1 and lag-C autocorrelations within 5 sigma over 2^24 values, max
    exact also at 62 columns; times beside torch.addcmul (supplied) and
    torch.normal (generated)."""
    from fastbox_tpu_torch.ops.cuda import noise as k

    N = 256
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((N * N, N), generator=g, device=dev) * 300.0
    scale = 60.0 + 120.0 * torch.rand(N, generator=g, device=dev)
    n = torch.randn((N * N, N), generator=g, device=dev)
    x62, n62 = x[:4096, :62].contiguous(), n[:4096, :62].contiguous()
    supplied = [("rows", x, scale, n, True),
                ("rows f64", x.double(), scale.double(), n.double(), True),
                ("62 columns", x62, scale[:62].contiguous(), n62, False),
                ("62 columns f64", x62.double(), scale[:62].double(),
                 n62.double(), False),
                ("unaligned rows", unaligned(x), scale, unaligned(n), False)]
    for what, xs, ss, ns, vec in supplied:
        check(k.vector_path(xs.shape[1], xs, ss, ns) == vec,
              f"K1 {what}: not on the {'vector' if vec else 'direct'} path")
        out_k, mx_k = k.add_scaled_normal_cuda(xs, ss, normals=ns,
                                               return_max=True)
        out_p, mx_p = k.add_scaled_normal_plain(xs, ss, normals=ns,
                                                return_max=True)
        ulps = ulp_diff(out_k, out_p)
        log(f"K1 supplied, {what} {tuple(xs.shape)}: {ulps} ulp from the "
            f"twin, max {mx_k.item()!r} vs {mx_p.item()!r}")
        check(ulps == 0, f"K1 supplied {what}: {ulps} ulp from the twin")
        check(mx_k.item() == mx_p.item(), f"K1 supplied {what}: max differs")
    # generated normals
    zero = torch.zeros_like(x)
    one = torch.ones_like(scale)
    s1 = torch.tensor([12345], dtype=torch.int64, device=dev)
    s2 = torch.tensor([12346], dtype=torch.int64, device=dev)
    a, amax = k.add_scaled_normal_cuda(zero, one, seed=s1, return_max=True)
    b = k.add_scaled_normal_cuda(zero, one, seed=s1)
    c = k.add_scaled_normal_cuda(zero, one, seed=s2)
    d = k.add_scaled_normal_cuda(unaligned(zero), one, seed=s1)
    check(torch.equal(a, b), "K1: same seed, different bits")
    check(not torch.equal(a, c), "K1: different seeds, same bits")
    check(torch.equal(a, d), "K1: the direct path drew other bits")
    check(amax.item() == a.abs().max().item(), "K1: max != out.abs().max()")
    a62, a62max = k.add_scaled_normal_cuda(zero[:4096, :62].contiguous(),
                                           one[:62].contiguous(), seed=s1,
                                           return_max=True)
    check(a62max.item() == a62.abs().max().item(),
          "K1 at 62 columns: max != out.abs().max()")
    check(torch.equal(a62, a[:4096, :62]),
          "K1 at 62 columns: not the rows' bits")
    f = a.double().reshape(-1)
    m = f.numel()
    mean = f.mean().item()
    var = f.var(correction=0).item()
    kurt = ((f - mean) ** 4).mean().item() / var**2
    lags = {lag: ((f[:-lag] - mean) * (f[lag:] - mean)).mean().item() / var
            for lag in (1, N)}
    check(abs(mean) < 5 / m**0.5, f"K1 mean {mean}")
    check(abs(var - 1) < 5 * (2 / m) ** 0.5, f"K1 variance {var}")
    check(abs(kurt - 3) < 5 * (96 / m) ** 0.5, f"K1 kurtosis {kurt}")
    for lag, r in lags.items():
        check(abs(r) < 5 / (m - lag) ** 0.5, f"K1 lag-{lag} autocorr {r}")
    log(f"K1 generated: mean {mean:.3e} var {var:.6f} kurtosis {kurt:.5f} "
        f"lag-1 {lags[1]:.3e} lag-C {lags[N]:.3e} (n={m}); direct path "
        "draws the vector path's bits; max exact at 62 columns")
    gen = torch.Generator(device=dev).manual_seed(2)
    ms = median_ms(lambda: k.add_scaled_normal_cuda(
        x, scale, seed=k.draw_seed(gen, dev), return_max=True))
    ms_gen = median_ms(lambda: k.add_scaled_normal_cuda(
        x, scale, seed=k.draw_seed(gen, dev)))
    plain_ms = median_ms(lambda: k.add_scaled_normal_plain(
        x, scale, generator=gen, return_max=True))
    # one library call for each form: x + s N(0,1) with the per-column
    # scale broadcast, drawn (torch.normal) or supplied (torch.addcmul)
    std = scale.expand_as(x)
    lib_gen = median_ms(lambda: torch.normal(x, std, generator=gen))
    ms_sup = median_ms(lambda: k.add_scaled_normal_cuda(x, scale, normals=n))
    lib_sup = median_ms(lambda: torch.addcmul(x, n, scale))
    log(f"K1 generated: kernel {ms:.4f} ms with the max, {ms_gen:.4f} ms "
        f"without; torch.normal {lib_gen:.4f} ms. Supplied normals: kernel "
        f"{ms_sup:.4f} ms, torch.addcmul {lib_sup:.4f} ms (bound "
        f"{roofline(3 * nbytes(x) + nbytes(scale), 2 * x.numel())['bound_ms']:.4f})")
    # x + s n: 2 operations per element (the draw's own work not counted)
    return dict(name="add_scaled_normal", max_abs_err=0.0, ms=ms,
                plain_ms=plain_ms, library_ms=lib_gen,
                **roofline(2 * nbytes(x) + nbytes(scale) + 4, 2 * x.numel()))


# K2 and K7 are held to their twins on these lines of sight: (name, box,
# cells per line, lines): the cube's rows, 512 cells, the anisotropic box's
# (2 Gpc deep), and a length that is not a multiple of 4 (the direct path).
RSD_CASES = (("cube", BOX, N_MAIN, None), ("512 cells", BOX, N_BIG, 65536),
             ("anisotropic", ANISO_BOX, N_MAIN, None),
             ("62 cells", BOX, 62, None))


def rsd_case_inputs(cosmo, dev, case, cells, seed):
    from fastbox_tpu_torch.grid import GridSpec

    _, box, n, rows = case
    grid = GridSpec.create(box_scale=box, nsamp=n, redshift=Z)
    return rsd_inputs(grid, cosmo, cells, dev, seed, rows)


def phase_k2(dev, cosmo) -> dict:
    """K2 bitwise equal to its twin at bands 2 and 4, f32 and f64, on every
    line of RSD_CASES and on unaligned copies of the cube's rows (the direct
    path); in f32 on the cube also against the exact sort + K3 tier; timed
    on the cube at both bands."""
    from fastbox_tpu_torch.ops.cuda import rsd_fused as k
    from fastbox_tpu_torch.ops.cuda.rsd_interp import interp_sorted_cuda

    errs, ms, cube = [], {}, {}
    for band, cells in ((2, 1.9), (4, 3.9)):
        for case in RSD_CASES:
            vals, vel, z, fill, wrap, inv_hz, _ = rsd_case_inputs(
                cosmo, dev, case, cells, seed=band)
            C = vals.shape[1]
            runs = [(dt, tuple(t.to(dt).contiguous()
                               for t in (vals, vel, z, fill, wrap)))
                    for dt in (torch.float32, torch.float64)]
            if case[0] == "cube":
                runs.append(("unaligned", (unaligned(vals), unaligned(vel),
                                           z, fill, wrap)))
            for dt, args in runs:
                staged = k.staged_path(C, band, args[0], args[1])
                got = k.rsd_remap_wrap_cuda(*args, band)
                want = k.rsd_remap_wrap_plain(*args, band)
                same = torch.equal(got, want)
                log(f"K2 band {band} {case[0]} {tuple(got.shape)} {dt} "
                    f"({'staged' if staged else 'direct'}): bitwise "
                    f"{same}, {norm_err(got, want):.3e}")
                check(same, f"K2 band {band} {case[0]} {dt}: not bitwise "
                      "equal to the twin")
                errs.append((got - want).abs().max().item())
            if case[0] != "cube":
                continue
            check(k.staged_path(C, band, vals, vel), "K2: cube not staged")
            # the band scan equals the exact sort + interpolation, except
            # where two wrapped coordinates tie exactly in f32 with a
            # periodic image involved: there the scan order and the stable
            # sort pick different duplicates, as on the TPU
            # (rsd_fused.py:37-40, ~1 voxel in 10^7)
            got = k.rsd_remap_wrap_cuda(vals, vel, z, fill, wrap, band)
            s = torch.remainder(z[None, :] - vel * inv_hz - wrap[0],
                                wrap[1]) + wrap[0]
            ss, order = torch.sort(s, dim=1, stable=True)
            exact = interp_sorted_cuda(ss, torch.gather(vals, 1, order), z,
                                       fill)
            off = ((got - exact).abs() > 1e-5 * exact.abs().max()).sum() \
                .item()
            log(f"K2 band {band}: {off} of {got.numel()} values off the "
                "exact tier (ties)")
            check(off <= 1e-6 * got.numel(), f"K2 band {band}: {off} off exact")
            cube[band] = (vals, vel, z, fill, wrap)
            ms[band] = (median_ms(lambda: k.rsd_remap_wrap_cuda(
                            *cube[band], band)),
                        median_ms(lambda: k.rsd_remap_wrap_plain(
                            *cube[band], band)))
            log(f"K2 band {band} f32 cube: kernel {ms[band][0]:.4f} ms, "
                f"plain {ms[band][1]:.4f} ms")
    vals, vel, z, fill, wrap = cube[2]
    # per target: the wrap (4), two one-sided selects over 6B+4 offsets (4
    # each) and the interpolation (5), at band 2
    return dict(name="rsd_remap_wrap", max_abs_err=max(errs), ms=ms[2][0],
                plain_ms=ms[2][1], library_ms=None,
                **roofline(nbytes(vals, vel, z, fill, wrap, vals),
                           vals.numel() * (4 + 4 * (6 * 2 + 4) + 5)))


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
    # per target: a bisection over C nodes and the interpolation
    steps = int(np.ceil(np.log2(ss.shape[1])))
    return dict(name="interp_sorted", max_abs_err=(got - want).abs().max()
                .item(), ms=ms, plain_ms=plain_ms, library_ms=None,
                **roofline(nbytes(ss, vv, z, fill, got),
                           got.numel() * (steps + 5)))


def k4_inputs(dev, N: int, seed: int, uniform: bool = False) -> tuple:
    """(p1, p2, (kx2, ky2, kz2h, wz, thr)) at the N^3 cube's shapes: powers
    spanning ~6 decades like |delta_k|^2, or uniform in [0.1, 5)."""
    from fastbox_tpu_torch.grid import GridSpec
    from fastbox_tpu_torch.ops import spectra

    grid = GridSpec.create(box_scale=BOX, nsamp=N, redshift=Z)
    H = N // 2 + 1
    g = torch.Generator(device=dev).manual_seed(seed)
    if uniform:
        p1, p2 = (torch.rand((N, N, H), generator=g, device=dev) * 4.9 + 0.1
                  for _ in range(2))
    else:
        p1, p2 = (torch.exp(3.0 * torch.randn((N, N, H), generator=g,
                                              device=dev)) for _ in range(2))
    fi2 = torch.as_tensor(spectra._index_sq(grid), device=dev)
    thr = torch.as_tensor(spectra.kbin_thresholds(
        grid, spectra.default_kbins(grid, 20)), device=dev)
    wz = torch.full((H,), 2.0, device=dev)
    wz[0] = wz[-1] = 1.0
    return p1, p2, (fi2, fi2, fi2[:H].contiguous(), wz, thr)


def k4_held(what, p1, p2, args, telescoped: bool = False) -> tuple:
    """K4 (K4t) against its f64 twin per populated bin, within K4_TWIN_BOUND
    in f32 and n unit roundoffs in f64, and bitwise repeatable; returns
    (the kernel's result, the twin's)."""
    from fastbox_tpu_torch.ops.cuda import binned_pk_v2 as k

    got = k.binned_pk_half_dual_v2_cuda(p1, p2, *args, telescoped=telescoped)
    again = k.binned_pk_half_dual_v2_cuda(p1, p2, *args,
                                          telescoped=telescoped)
    ref = k.binned_pk_half_dual_v2_plain(p1.double(), p2.double(), *args[:3],
                                         args[3].double(), args[4],
                                         telescoped=telescoped)
    rel = rel_by_bin(got, ref)
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    bound = (K4T_TWIN_BOUND if telescoped else K4_TWIN_BOUND) \
        if p1.dtype == torch.float32 else F64_SUM_BOUND * p1.numel()
    log(f"{K4T if telescoped else K4} {what} {tuple(p1.shape)} {p1.dtype}: "
        f"max rel err vs f64 twin {rel:.3e} (bound {bound:.1e}), bitwise "
        f"repeatable {bitwise}")
    check(rel <= bound, f"{what}: rel err {rel}")
    check(bitwise, f"{what}: not bitwise repeatable")
    return got, ref


def phase_k4(dev, grid) -> dict:
    """K4 at the 256^3 and 512^3 cubes' shapes, f32 and f64, and on a
    64^3 lattice whose kz2h does not ascend (the general path), each
    against its f64 twin and bitwise repeatable; timed at both sizes."""
    from fastbox_tpu_torch.ops import spectra
    from fastbox_tpu_torch.ops.cuda import binned_pk_v2 as k

    for N in (N_BIG, N_MAIN):
        p1, p2, args = k4_inputs(dev, N, 4)
        k4_held(f"{N}^3", p1.double(), p2.double(),
                args[:3] + (args[3].double(), args[4]))
        got, ref = k4_held(f"{N}^3", p1, p2, args)
        ms = median_ms(lambda: k.binned_pk_half_dual_v2_cuda(p1, p2, *args))
        bound = roofline(nbytes(p1, p2, *args) + 3 * nbytes(got[0]),
                         p1.numel() * 13)
        log(f"K4 {N}^3 f32: kernel {ms:.4f} ms (bound "
            f"{bound['bound_ms']:.4f})")
    p1g, p2g, argsg = k4_inputs(dev, 64, 5, uniform=True)
    argsg = argsg[:2] + (argsg[2].flip(0).contiguous(),) + argsg[3:]
    k4_held("general path (kz2h reversed)", p1g, p2g, argsg)
    plain_ms = median_ms(lambda: k.binned_pk_half_dual_v2_plain(p1, p2,
                                                                *args))
    err = max((a.double() - b).abs().max().item() for a, b in zip(got, ref))
    H = grid.N // 2 + 1
    idx = spectra._bin_index(grid, spectra.default_kbins(grid, 20),
                             args[4].cpu().numpy(), H, torch.float32, dev)
    w = args[3][None, None, :]
    lib_ms = index_add_ms(idx, (w * p1, w * p1 * p1, w * p2),
                          args[4].numel() + 1)
    # per mode: the lattice index sum and bisection (~7), three weighted
    # terms and their sums (6)
    return dict(name="binned_pk_half_dual_v2", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, **bound)


def phase_k4t(dev, grid) -> dict:
    """K4t at K4's 256^3 shapes on powers uniform in [0.1, 5), the inputs
    of fastbox_tpu's own test of the telescoped mode
    (tests/test_binned_pk_v2.py:15-24): a prefix difference loses
    eps * prefix / bin, and heavy-tailed powers, whose largest mode
    dominates later prefixes, would measure that cancellation rather than
    the kernel.  Against its f64 twin, against K4 in f32 ulp, bitwise
    repeatable; also on the general path (kz2h reversed, 64^3)."""
    from fastbox_tpu_torch.ops import spectra
    from fastbox_tpu_torch.ops.cuda import binned_pk_v2 as k

    p1, p2, args = k4_inputs(dev, grid.N, 41, uniform=True)
    got, ref = k4_held(f"{grid.N}^3", p1, p2, args, telescoped=True)
    k4 = k.binned_pk_half_dual_v2_cuda(p1, p2, *args)
    ulps = max(ulp_diff(a, b) for a, b in zip(got, k4))
    log(f"K4t vs K4 on the same inputs: {ulps} f32 ulp")
    check(ulps <= K4T_K4_ULP, f"K4t vs K4: {ulps} ulp")
    p1g, p2g, argsg = k4_inputs(dev, 64, 5, uniform=True)
    argsg = argsg[:2] + (argsg[2].flip(0).contiguous(),) + argsg[3:]
    k4_held("general path (kz2h reversed)", p1g, p2g, argsg, telescoped=True)
    ms = median_ms(lambda: k.binned_pk_half_dual_v2_cuda(p1, p2, *args,
                                                         telescoped=True))
    ms_k4 = median_ms(lambda: k.binned_pk_half_dual_v2_cuda(p1, p2, *args))
    log(f"K4t {grid.N}^3: kernel {ms:.4f} ms, K4 on the same inputs "
        f"{ms_k4:.4f} ms")
    plain_ms = median_ms(lambda: k.binned_pk_half_dual_v2_plain(
        p1, p2, *args, telescoped=True))
    err = max((a.double() - b).abs().max().item() for a, b in zip(got, ref))
    H = grid.N // 2 + 1
    idx = spectra._bin_index(grid, spectra.default_kbins(grid, 20),
                             args[4].cpu().numpy(), H, torch.float32, dev)
    w = args[3][None, None, :]
    lib_ms = index_add_ms(idx, (w * p1, w * p1 * p1, w * p2),
                          args[4].numel() + 1)
    # K4's bytes and operations: the prefix scan is nbins^2 per block
    return dict(name=K4T, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms,
                **roofline(nbytes(p1, p2, *args) + 3 * nbytes(got[0]),
                           p1.numel() * 13))


def clustered_disp(d, B: int) -> tuple:
    """``d`` with every site within B - 1/2 cells of three centres (one on
    the periodic corner) pulled onto one point near its centre, as in a
    collapsed halo: up to ~(2B)^3 sources in one cell, |d| < B."""
    N = d[0].shape[0]
    site = torch.arange(N, device=d[0].device, dtype=d[0].dtype)
    out = [a.clone() for a in d]
    for cen in ((N // 2,) * 3, (2, N - 3, 5), (N - 1, 0, N - 1)):
        off = [((site - c + N // 2) % N - N // 2).reshape(
            [N if i == ax else 1 for i in range(3)])
            for ax, c in enumerate(cen)]
        near = (off[0] ** 2 + off[1] ** 2 + off[2] ** 2) <= (B - 0.5) ** 2
        for a, o in zip(out, off):
            a.copy_(torch.where(near, 0.3 - o, a))
    return tuple(out)


def grid_sample_operands(meshes, d) -> tuple:
    """The operands of the one library call that computes the lattice CIC
    gather of ``meshes`` at the sites plus ``d``: the meshes as channels,
    padded circularly by one cell at the high end of each axis, and the
    wrapped positions normalised for ``grid_sample(align_corners=True)``
    (its last axis orders them z, y, x).  Made outside any timing, as the
    paint's index_add_ takes its corner indices precomputed."""
    N = d[0].shape[0]
    inp = torch.nn.functional.pad(torch.stack(tuple(meshes))[None],
                                  (0, 1) * 3, mode="circular")
    site = torch.arange(N, dtype=d[0].dtype, device=d[0].device)
    pos = []
    for ax, da in enumerate(d):
        shape = [1, 1, 1]
        shape[ax] = N
        pos.append(torch.remainder(site.reshape(shape) + da, N) * (2.0 / N)
                   - 1.0)
    return inp, torch.stack(pos[::-1], dim=-1)[None]


def grid_sample_gather(inp, grid):
    """The gather of each channel, (C, N, N, N), in one grid_sample call."""
    return torch.nn.functional.grid_sample(inp, grid, mode="bilinear",
                                           padding_mode="zeros",
                                           align_corners=True)[0]


def gathers_bitwise(meshes, d, B: int, what: str, openband: bool = True):
    """K11b and K11c equal to their twins bit for bit, and to themselves."""
    from fastbox_tpu_torch.ops.cuda import lattice_cic as k

    g1 = k.cic_gather_lattice_cuda(meshes[0], d, B, openband)
    g3 = k.cic_gather3_lattice_cuda(meshes, d, B, openband)
    same = torch.equal(g1, k.cic_gather_lattice_plain(meshes[0], d, B,
                                                      openband))
    same3 = all(torch.equal(a, b) for a, b in zip(
        g3, k.cic_gather3_lattice_plain(meshes, d, B, openband)))
    again = (torch.equal(g1, k.cic_gather_lattice_cuda(meshes[0], d, B,
                                                       openband))
             and all(torch.equal(a, b) for a, b in zip(
                 g3, k.cic_gather3_lattice_cuda(meshes, d, B, openband))))
    check(same and same3 and again, f"K11b/K11c {what} B={B}: bitwise equal "
          f"to the twin {same}/{same3}, repeatable {again}")


def grid_sample_ms(meshes, d, B: int) -> tuple:
    """grid_sample's ms per call for the gather of the first mesh (one
    channel) and of all three (K11c's yardstick), after holding it to K11b
    at band B on the same inputs."""
    from fastbox_tpu_torch.ops.cuda import lattice_cic as k

    inp3, grid = grid_sample_operands(meshes, d)
    inp1 = inp3[:, :1].contiguous()
    err = norm_err(grid_sample_gather(inp1, grid)[0],
                   k.cic_gather_lattice_cuda(meshes[0], d, B))
    check(err <= GRID_SAMPLE_BOUND, f"grid_sample off the gather: {err}")
    return (median_ms(lambda: grid_sample_gather(inp1, grid)),
            median_ms(lambda: grid_sample_gather(inp3, grid)))


def cola_gather_inputs(dev) -> dict:
    """The force meshes and displacements of a 256^3 COLA run's fused force
    gathers (K11c): the first at band 1 and the last, captured by wrapping
    the engine's _gather3 (fields/cola.py is unchanged)."""
    from fastbox_tpu_torch.cosmology import build_cosmology
    from fastbox_tpu_torch.fields.cola import ColaEngine
    from fastbox_tpu_torch.fields.gaussian import white_noise
    from fastbox_tpu_torch.grid import GridSpec

    grid = GridSpec.create(box_scale=BOX, nsamp=COLA_N[0])
    eng = ColaEngine(grid, build_cosmology(COSMO, redshift=0.0, device=dev),
                     redshift_init=COLA_Z_INIT, lattice_B=3, device=dev,
                     keep_velocities=False)
    seen, inner = {}, eng._gather3

    def capture(meshes, d, b, openband, **kw):
        copy = (tuple(m.clone() for m in meshes), tuple(a.clone() for a in d),
                b)
        if b == 1 and "early, band 1" not in seen:
            seen["early, band 1"] = copy
        seen["last"] = copy
        return inner(meshes, d, b, openband, **kw)

    eng._gather3 = capture
    eng.run(white_noise(torch.Generator(device=dev).manual_seed(2028), grid))
    check("early, band 1" in seen and "last" in seen,
          f"COLA force gathers captured: {list(seen)}")
    return seen


def phase_k11(dev) -> list[dict]:
    """K11's three entry points against their twins at 256^3, B = 1, 2, 3
    (open band, displacements uniform in (-B, B)), and in f64 against the
    exact scatter.  The paint must equal its twin bit for bit (f32 and f64,
    weighted and not, on clustered displacements too) and repeat bit for
    bit; its time at every B beside the index_add_ paint at that B.  The
    gathers (K11b, K11c) must equal their twins bit for bit and repeat, on
    uniform, clustered and COLA displacements, f32 and f64, B = 1, 2, 3, a
    closed band, and wide bands at 64^3 that take the launcher's other
    path; their times at every B and on COLA's displacements beside
    grid_sample's.  The rows' times are at B = 3 on uniform draws, the band
    the late COLA steps take."""
    from fastbox_tpu_torch.fields.cola import cic_gather, cic_paint_particles
    from fastbox_tpu_torch.ops.cuda import lattice_cic as k

    N = COLA_N[0]
    g = torch.Generator(device=dev).manual_seed(11)
    errs = {n: [] for n in ("cic_paint_lattice", "cic_gather_lattice",
                            "cic_gather3_lattice")}
    times, lib_paint, lib_gather = {}, {}, {}
    site = torch.meshgrid(*(torch.arange(N, device=dev, dtype=torch.float64),)
                          * 3, indexing="ij")
    for B in (1, 2, 3):
        d = tuple((torch.rand((N, N, N), generator=g, device=dev) * 2 - 1) * B
                  for _ in range(3))
        w = torch.rand((N, N, N), generator=g, device=dev) * 2 - 1
        meshes = tuple(torch.randn((N, N, N), generator=g, device=dev)
                       for _ in range(3))
        pairs = {
            "cic_paint_lattice": [(k.cic_paint_lattice_cuda(d, B, wt),
                                   k.cic_paint_lattice_plain(d, B, wt))
                                  for wt in (None, w)],
            "cic_gather_lattice": [(k.cic_gather_lattice_cuda(meshes[0], d, B),
                                    k.cic_gather_lattice_plain(meshes[0], d,
                                                               B))],
            "cic_gather3_lattice": list(zip(
                k.cic_gather3_lattice_cuda(meshes, d, B),
                k.cic_gather3_lattice_plain(meshes, d, B))),
        }
        for name, ps in pairs.items():
            e = max(norm_err(a, b) for a, b in ps)
            same = all(torch.equal(a, b) for a, b in ps)
            errs[name].append(max((a - b).abs().max().item() for a, b in ps))
            log(f"K11 {name} B={B}: vs twin {e:.3e} of max|value| "
                f"(bitwise equal: {same})")
            check(e <= K11_TWIN_BOUND, f"K11 {name} B={B}: {e} from the twin")
            check(same or name == "cic_paint_lattice",
                  f"K11 {name} B={B}: not bitwise equal to the twin")
        del pairs
        # the paint: bitwise its twin and itself, clustered and in f64
        dc = clustered_disp(d, B)
        d64, dc64, w64 = (tuple(a.double() for a in t) for t in (d, dc, (w,)))
        for label, disp, wts in (("f32", d, (None, w)),
                                 ("f32 clustered", dc, (None, w)),
                                 ("f64", d64, (None, w64[0])),
                                 ("f64 clustered", dc64, (None, w64[0]))):
            for wt in wts:
                got = k.cic_paint_lattice_cuda(disp, B, wt)
                same = torch.equal(got, k.cic_paint_lattice_plain(disp, B, wt))
                again = torch.equal(got, k.cic_paint_lattice_cuda(disp, B, wt))
                what = (f"K11a paint B={B} {label} "
                        f"{'weighted' if wt is not None else 'unweighted'}")
                check(same and again, f"{what}: bitwise equal to the twin "
                      f"{same}, repeatable {again}")
        log(f"K11a paint B={B}: bitwise equal to its twin and repeatable, "
            "f32 and f64, weighted and not, uniform and clustered")
        m64 = tuple(m.double() for m in meshes)
        for label, disp, mm in (("f32", d, meshes),
                                ("f32 clustered", dc, meshes),
                                ("f64", d64, m64),
                                ("f64 clustered", dc64, m64)):
            gathers_bitwise(mm, disp, B, label)
        del m64
        log(f"K11b/K11c gathers B={B}: bitwise equal to their twins and "
            "repeatable, f32 and f64, uniform and clustered")
        # f64 against the exact scatter/gather at the positions l + d
        u = tuple((s + a).reshape(-1) for s, a in zip(site, d64))
        e_paint = max(norm_err(k.cic_paint_lattice_cuda(d64, B, wt),
                               cic_paint_particles(u, N, wr))
                      for wt, wr in ((None, None),
                                     (w64[0], w64[0].reshape(-1))))
        m64 = meshes[0].double()
        e_gather = norm_err(k.cic_gather_lattice_cuda(m64, d64, B).reshape(-1),
                            cic_gather(m64, u))
        e_g3 = max(norm_err(a.reshape(-1), cic_gather(m.double(), u)) for a, m
                   in zip(k.cic_gather3_lattice_cuda(
                       tuple(m.double() for m in meshes), d64, B), meshes))
        log(f"K11 B={B} f64 vs exact scatter/gather: paint {e_paint:.3e}, "
            f"gather {e_gather:.3e}, gather3 {e_g3:.3e}")
        check(max(e_paint, e_gather, e_g3) <= K11_EXACT_BOUND,
              f"K11 B={B}: off the exact scatter")
        del d64, dc64, u, w64, m64
        lib_gather[B] = grid_sample_ms(meshes, d, B)
        log(f"K11 gathers B={B}, uniform: grid_sample 1 channel "
            f"{lib_gather[B][0]:.4f} ms, 3 channels {lib_gather[B][1]:.4f} ms")
        for name, kern, plain in (
                ("cic_paint_lattice", lambda: k.cic_paint_lattice_cuda(d, B),
                 lambda: k.cic_paint_lattice_plain(d, B)),
                ("cic_gather_lattice",
                 lambda: k.cic_gather_lattice_cuda(meshes[0], d, B),
                 lambda: k.cic_gather_lattice_plain(meshes[0], d, B)),
                ("cic_gather3_lattice",
                 lambda: k.cic_gather3_lattice_cuda(meshes, d, B),
                 lambda: k.cic_gather3_lattice_plain(meshes, d, B))):
            times[(name, B)] = (median_ms(kern), median_ms(plain))
            log(f"K11 {name} B={B}: kernel {times[(name, B)][0]:.4f} ms, "
                f"plain {times[(name, B)][1]:.4f} ms")
        # library: the paint as one index_add_ of the 8 corner weights on
        # corner indices computed beforehand, at this B's displacements
        idx8, w8 = cic_corners(d, N)
        lib_paint[B] = median_ms(lambda: torch.zeros(N ** 3, device=dev)
                                 .index_add_(0, idx8, w8))
        del idx8, w8
        ms_c = median_ms(lambda: k.cic_paint_lattice_cuda(dc, B))
        log(f"K11a paint B={B}: kernel {times[('cic_paint_lattice', B)][0]:.4f}"
            f" ms (clustered {ms_c:.4f} ms), index_add_ {lib_paint[B]:.4f} ms")
        del dc
    # a closed band; wide bands at 64^3: at B = 8 in f32 K11b stages its
    # rings and K11c reads its corners from global memory; in f64, and at
    # B = 16, both read from global memory; ragged faces (60^3), and rows
    # that are not whole 16-byte chunks in f32 (62^3: global memory)
    for B, ob, n, what in ((2, False, K11_WIDE_N, "closed band"),
                           (8, True, K11_WIDE_N, "wide band"),
                           (16, True, K11_WIDE_N, "wide band"),
                           (3, True, 60, "ragged faces"),
                           (3, True, 62, "unaligned rows")):
        for dt in (torch.float32, torch.float64):
            gd = torch.Generator(device=dev).manual_seed(100 + B)
            d = tuple(((torch.rand((n, n, n), generator=gd, device=dev,
                                   dtype=dt) * 2 - 1) * B).contiguous()
                      for _ in range(3))
            if not ob:
                d = tuple(torch.where(a.abs() > B - 0.1, torch.sign(a) * B, a)
                          for a in d)
            meshes_n = tuple(torch.randn((n, n, n), generator=gd, device=dev,
                                         dtype=dt) for _ in range(3))
            cases = [(d, "uniform")]
            if ob and B == 8:
                cases.append((clustered_disp(d, B), "clustered"))
            for disp, kind in cases:
                gathers_bitwise(meshes_n, disp, B, f"{n}^3 {what} {dt} {kind}",
                                openband=ob)
        log(f"K11b/K11c gathers {n}^3 {what} B={B}: bitwise equal to their "
            "twins and repeatable, f32 and f64")
    # COLA's own displacements and force meshes
    for label, (meshes_c, d, B) in cola_gather_inputs(dev).items():
        gathers_bitwise(meshes_c, d, B, f"COLA {label} f32")
        gathers_bitwise(tuple(m.double() for m in meshes_c),
                        tuple(a.double() for a in d), B, f"COLA {label} f64")
        ms_b = median_ms(lambda: k.cic_gather_lattice_cuda(meshes_c[0], d, B))
        ms_c = median_ms(lambda: k.cic_gather3_lattice_cuda(meshes_c, d, B))
        lib1, lib3 = grid_sample_ms(meshes_c, d, B)
        log(f"K11 gathers on COLA {COLA_N[0]}^3's {label} force evaluation "
            f"(band {B}, max|d| {max(a.abs().max().item() for a in d):.3f}): "
            f"bitwise equal to their twins (f32, f64); K11b {ms_b:.4f} ms, "
            f"K11c {ms_c:.4f} ms; grid_sample 1 channel {lib1:.4f} ms, 3 "
            f"channels {lib3:.4f} ms")
        del meshes_c, d
    n3 = N ** 3
    # per particle: 8 corner weights (3 products each) and 8 adds
    bounds = {"cic_paint_lattice": roofline(4 * 4 * n3, 32 * n3),
              "cic_gather_lattice": roofline(5 * 4 * n3, 32 * n3),
              "cic_gather3_lattice": roofline(9 * 4 * n3, 3 * 32 * n3)}
    return [dict(name=n, max_abs_err=max(errs[n]), ms=times[(n, 3)][0],
                 plain_ms=times[(n, 3)][1],
                 library_ms={"cic_paint_lattice": lib_paint[3],
                             "cic_gather_lattice": lib_gather[3][0],
                             "cic_gather3_lattice": lib_gather[3][1]}[n],
                 **bounds[n]) for n in errs]


def cic_corners(d, N: int) -> tuple:
    """(flat cell index, weight) of the 8 CIC corners of every particle
    at lattice site + d, periodic: the operands of an index_add_ paint."""
    dev = d[0].device
    site = torch.arange(N, device=dev, dtype=d[0].dtype)
    lo, fr = [], []
    for axis, da in enumerate(d):
        shape = [1, 1, 1]
        shape[axis] = N
        p = site.reshape(shape) + da
        i0 = torch.floor(p)
        fr.append(p - i0)
        lo.append(i0.long())
    idx, w = [], []
    for cx in (0, 1):
        for cy in (0, 1):
            for cz in (0, 1):
                ix, iy, iz = ((lo[a] + c) % N for a, c in
                              enumerate((cx, cy, cz)))
                idx.append(((ix * N + iy) * N + iz).reshape(-1))
                w.append(((fr[0] if cx else 1 - fr[0])
                          * (fr[1] if cy else 1 - fr[1])
                          * (fr[2] if cz else 1 - fr[2])).reshape(-1))
    return torch.cat(idx), torch.cat(w)


def rel_by_bin(got, want) -> float:
    """Largest |got - want| / |want| over the bins where want != 0."""
    worst = 0.0
    for a, b in zip(got, want):
        full = b != 0
        worst = max(worst, ((a.double() - b.double()) / b.double())[full]
                    .abs().max().item())
    return worst


def pk_held(what: str, run, ref, n: int) -> tuple:
    """K5/K6 (``run``, called twice) against ``ref``, its twin on the same
    inputs: per populated bin within 1e-6 in f32 and n unit roundoffs in
    f64, the count (K6) or weighted count (K5, the last row) exactly, and
    bitwise repeatable.  Returns the kernel's result."""
    got, again = run(), run()
    rel = rel_by_bin(got, ref)
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    counts = torch.equal(got[-1], ref[-1])
    bound = 1e-6 if got[0].dtype == torch.float32 else F64_SUM_BOUND * n
    log(f"{what} {got[0].dtype}: max rel err vs twin {rel:.3e} (bound "
        f"{bound:.1e}), counts equal {counts}, bitwise repeatable {bitwise}")
    check(rel <= bound, f"{what}: rel err {rel}")
    check(counts, f"{what}: counts differ from the twin's")
    check(bitwise, f"{what}: not bitwise repeatable")
    return got


def phase_k5(dev) -> dict:
    """K5 on the anisotropic 256^3 half spectra, f32 and f64, and on a
    reversed kz2h (the general path), each against its twin (f64: the f64
    index_add_ twin), weighted counts exactly, bitwise repeatable; plus how
    many modes the f32 digitize puts in another bin than the f64 one.
    Timed at 256^3 and 512^3."""
    from fastbox_tpu_torch.grid import GridSpec
    from fastbox_tpu_torch.ops import spectra
    from fastbox_tpu_torch.ops.cuda import binned_pk as k

    def inputs(N, seed, dtype=torch.float32):
        grid = GridSpec.create(box_scale=ANISO_BOX, nsamp=N, redshift=Z)
        H = N // 2 + 1
        g = torch.Generator(device=dev).manual_seed(seed)
        p1, p2 = (torch.exp(3.0 * torch.randn((N, N, H), generator=g,
                                              device=dev)).to(dtype)
                  for _ in range(2))
        wz = torch.full((H,), 2.0, dtype=dtype, device=dev)
        wz[0] = wz[-1] = 1.0
        kx2, ky2, kz2, e2 = spectra.kbin_plan(
            grid, spectra.default_kbins(grid, 20), dtype, dev)
        return grid, p1, p2, (kx2, ky2, kz2[:H].contiguous(), wz, e2)

    def held(what, p1, p2, args):
        return pk_held(f"K5 binned_pk_half_dual ({what})",
                       lambda: k.binned_pk_half_dual_cuda(p1, p2, *args),
                       k.binned_pk_half_dual_plain(p1, p2, *args), p1.numel())

    N = N_MAIN
    grid, p1, p2, args = inputs(N, 5)
    twin = k.binned_pk_half_dual_plain(p1, p2, *args)
    got = held(f"anisotropic {N}^3", p1, p2, args)
    held(f"anisotropic {N}^3", *inputs(N, 5, torch.float64)[1:])
    gen = args[:2] + (args[2].flip(0).contiguous(),) + args[3:]
    held(f"anisotropic {N}^3, general path (kz2h reversed)", p1, p2, gen)
    g512 = GridSpec.create(box_scale=ANISO_BOX, nsamp=N_BIG, redshift=Z)
    log(f"K5 modes binned differently in f32 and f64: "
        f"{moved_modes(grid, dev)[0]} at {N}^3, {moved_modes(g512, dev)[0]}"
        f" at {N_BIG}^3")
    ms = median_ms(lambda: k.binned_pk_half_dual_cuda(p1, p2, *args))
    ms_gen = median_ms(lambda: k.binned_pk_half_dual_cuda(p1, p2, *gen))
    plain_ms = median_ms(lambda: k.binned_pk_half_dual_plain(p1, p2, *args))
    err = max((a.double() - b.double()).abs().max().item()
              for a, b in zip(got, twin))
    kx2, ky2, kz2h, wz, e2 = args
    idx = k.bin_index_sq(kx2, ky2, kz2h, e2)
    w = torch.broadcast_to(wz[None, None, :], p1.shape)
    lib_ms = index_add_ms(idx, (w * p1, w * p1 * p1, w * p2, w),
                          e2.numel() + 1)
    # per mode: the squared |k| (2), a bisection over the edges (~7), four
    # weighted terms and their sums (8)
    bound = roofline(nbytes(p1, p2, *args) + 4 * nbytes(got[0]),
                     p1.numel() * 17)
    del p1, p2, idx, w
    _, b1, b2, bargs = inputs(N_BIG, 55)
    bgot = held(f"anisotropic {N_BIG}^3", b1, b2, bargs)
    ms512 = median_ms(lambda: k.binned_pk_half_dual_cuda(b1, b2, *bargs))
    bound512 = roofline(nbytes(b1, b2, *bargs) + 4 * nbytes(bgot[0]),
                        b1.numel() * 17)
    log(f"K5 anisotropic {N}^3 f32: kernel {ms:.4f} ms (bound "
        f"{bound['bound_ms']:.4f}), general path {ms_gen:.4f} ms; "
        f"{N_BIG}^3: {ms512:.4f} ms (bound {bound512['bound_ms']:.4f})")
    return dict(name="binned_pk_half_dual", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, **bound)


def phase_k6(dev) -> dict:
    """K6 on a 256^3 cube (the 4 Gpc pipeline box, integer-lattice plan),
    f32 and f64, on a permuted kz2 (the general path) and on a 255^3 cube
    (odd: the FFT order's two segments meet at equal kz2), each against its
    twin (f64: the f64 index_add_ twin), counts exactly, bitwise
    repeatable; timed at 256^3."""
    from fastbox_tpu_torch.grid import GridSpec
    from fastbox_tpu_torch.ops import spectra
    from fastbox_tpu_torch.ops.cuda import binned_pk as k

    def inputs(N, seed, dtype=torch.float32):
        grid = GridSpec.create(box_scale=BOX, nsamp=N, redshift=Z)
        g = torch.Generator(device=dev).manual_seed(seed)
        pk = torch.exp(3.0 * torch.randn((N, N, N), generator=g, device=dev))
        return pk.to(dtype), spectra.kbin_plan(
            grid, spectra.default_kbins(grid, 20), dtype, dev)

    def held(what, pk, args):
        return pk_held(f"K6 binned_pk_full ({what})",
                       lambda: k.binned_pk_full_cuda(pk, *args),
                       k.binned_pk_full_plain(pk, *args), pk.numel())

    N = N_MAIN
    pk, args = inputs(N, 6)
    twin = k.binned_pk_full_plain(pk, *args)
    got = held(f"{N}^3 cube", pk, args)
    held(f"{N}^3 cube", *inputs(N, 6, torch.float64))
    g = torch.Generator(device=dev).manual_seed(61)
    perm = args[:2] + (args[2][torch.randperm(N, generator=g, device=dev)],
                       args[3])
    held(f"{N}^3 cube, general path (kz2 permuted)", pk, perm)
    for dtype in (torch.float32, torch.float64):
        held(f"{N - 1}^3 cube", *inputs(N - 1, 62, dtype))
    ms = median_ms(lambda: k.binned_pk_full_cuda(pk, *args))
    ms_gen = median_ms(lambda: k.binned_pk_full_cuda(pk, *perm))
    plain_ms = median_ms(lambda: k.binned_pk_full_plain(pk, *args))
    err = max((a.double() - b.double()).abs().max().item()
              for a, b in zip(got, twin))
    kx2, ky2, kz2, e2 = args
    lib_ms = index_add_ms(k.bin_index_sq(kx2, ky2, kz2, e2),
                          (pk, pk * pk, torch.ones_like(pk)), e2.numel() + 1)
    # per mode: the squared |k| (2), a bisection (~7), three sums (4)
    bound = roofline(nbytes(pk, *args) + 3 * nbytes(got[0]), pk.numel() * 13)
    log(f"K6 {N}^3 f32: kernel {ms:.4f} ms (bound {bound['bound_ms']:.4f}), "
        f"general path {ms_gen:.4f} ms")
    return dict(name="binned_pk_full", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, **bound)


def phase_k9(dev) -> list[dict]:
    """K9a/K9b at the 256^3 half-grid shape: supplied mode bitwise against
    the twins (f32 and f64), generated mode by the moments of the interior
    normals (5 sigma), seed determinism, and one delta_k for 'on' and 'vz'
    from one generator seed."""
    from fastbox_tpu_torch.fields import gaussian
    from fastbox_tpu_torch.grid import GridSpec
    from fastbox_tpu_torch.ops.cuda import half_draw as k
    from fastbox_tpu_torch.pipeline import vz_vectors

    N = N_MAIN
    H = N // 2 + 1
    grid = GridSpec.create(box_scale=BOX, nsamp=N, redshift=Z)
    g = torch.Generator(device=dev).manual_seed(9)
    errs = {"colored_half_draw": 0.0, "colored_half_draw_vz": 0.0}
    for dt in (torch.float32, torch.float64):
        amp = torch.rand((N, N * H), generator=g, device=dev, dtype=dt) * 5
        white = torch.complex(torch.randn((N, N * H), generator=g, device=dev,
                                          dtype=dt),
                              torch.randn((N, N * H), generator=g, device=dev,
                                          dtype=dt)) * float(np.sqrt(0.5))
        vecs = vz_vectors(grid, 80.0, dt, dev)
        pairs = {"colored_half_draw": [(
            k.colored_half_draw_cuda(amp, white=white),
            k.colored_half_draw_plain(amp, white=white))],
            "colored_half_draw_vz": list(zip(
                k.colored_half_draw_vz_cuda(amp, *vecs, white=white),
                k.colored_half_draw_vz_plain(amp, *vecs, white=white)))}
        for name, ps in pairs.items():
            errs[name] = max([errs[name]] + [(a - b).abs().max().item()
                                             for a, b in ps])
        same_a, same_b = (all(torch.equal(a, b) for a, b in ps)
                          for ps in pairs.values())
        log(f"K9 supplied mode {dt}: K9a bitwise {same_a}, K9b bitwise "
            f"{same_b}")
        check(same_a and same_b, f"K9 supplied mode {dt} differs from twin")
    amp = torch.rand((N, N * H), generator=g, device=dev) * 5
    vecs = vz_vectors(grid, 80.0, torch.float32, dev)
    one = torch.ones((N, N * H), device=dev)
    s1 = torch.tensor([12345], dtype=torch.int64, device=dev)
    s2 = torch.tensor([12346], dtype=torch.int64, device=dev)
    a = k.colored_half_draw_cuda(one, seed=s1)
    b, _ = k.colored_half_draw_vz_cuda(one, *vecs, seed=s1)
    check(torch.equal(a, b), "K9a and K9b: same seed, different normals")
    check(torch.equal(a, k.colored_half_draw_cuda(one, seed=s1)),
          "K9: same seed, different bits")
    check(not torch.equal(a, k.colored_half_draw_cuda(one, seed=s2)),
          "K9: different seeds, same bits")
    x = (torch.view_as_real(a.reshape(N, N, H)[:, :, 1:H - 1]).double()
         / np.sqrt(0.5)).reshape(-1)
    m = x.numel()
    mean = x.mean().item()
    var = x.var(correction=0).item()
    kurt = (x ** 4).mean().item() / var ** 2
    log(f"K9 generated: interior normals mean {mean:.3e} var {var:.6f} "
        f"kurtosis {kurt:.5f} (n={m})")
    check(abs(mean) < 5 / m ** 0.5, f"K9 mean {mean}")
    check(abs(var - 1) < 5 * (2 / m) ** 0.5, f"K9 variance {var}")
    check(abs(kurt - 3) < 5 * (96 / m) ** 0.5, f"K9 kurtosis {kurt}")
    amp3 = amp.reshape(N, N, H)
    d_on = gaussian.colored_half_noise(
        torch.Generator(device=dev).manual_seed(3), grid, amp3)
    d_vz, _ = gaussian.colored_half_noise_vz(
        torch.Generator(device=dev).manual_seed(3), grid, amp3, *vecs)
    check(torch.equal(d_on, d_vz), "'on' and 'vz' give different delta_k")
    log("K9 'on' and 'vz' from one generator seed: identical delta_k")
    gen = torch.Generator(device=dev).manual_seed(10)
    out = []
    for name, kern, plain in (
            ("colored_half_draw",
             lambda: k.colored_half_draw(amp, generator=gen),
             lambda: k.colored_half_draw_plain(amp, generator=gen)),
            ("colored_half_draw_vz",
             lambda: k.colored_half_draw_vz(amp, *vecs, generator=gen),
             lambda: k.colored_half_draw_vz_plain(amp, *vecs,
                                                  generator=gen))):
        # reads amp (and the three vz vectors), writes delta_k (and vz_k);
        # per mode two normals (~40 for Philox and Box-Muller) and the
        # colouring (2, and ~8 more for the vz weight)
        vz = name.endswith("_vz")
        n_bytes = nbytes(amp) + (2 if vz else 1) * 2 * nbytes(amp) \
            + (nbytes(*vecs) if vz else 0)
        out.append(dict(name=name, max_abs_err=errs[name],
                        ms=median_ms(kern), plain_ms=median_ms(plain),
                        library_ms=None,
                        **roofline(n_bytes, amp.numel() * (50 if vz else 42))))
    return out


def digitize(grid, dtype, dev):
    """(bin of every half-spectrum mode, number of edges) on the
    squared-space plan in ``dtype`` that K5 bins with."""
    from fastbox_tpu_torch.ops import spectra
    from fastbox_tpu_torch.ops.cuda.binned_pk import bin_index_sq

    H = grid.N // 2 + 1
    bins = spectra.default_kbins(grid, 20)
    kx2, ky2, kz2, e2 = spectra.kbin_plan(grid, bins, dtype, dev)
    return bin_index_sq(kx2, ky2, kz2[:H], e2), bins.size


def populated_bins(grid, dev) -> np.ndarray:
    """The retained P(k) bins (all but bin 0) that hold modes, on the f32
    digitize plan the pipeline bins with."""
    idx, nb = digitize(grid, torch.float32, dev)
    return torch.bincount(idx, minlength=nb + 1)[1:nb].cpu().numpy() > 0


def moved_modes(grid, dev) -> tuple:
    """(number of half-spectrum modes the f32 and the f64 digitize put in
    different bins, mask of the retained bins either puts them in)."""
    (i32, nb), (i64, _) = (digitize(grid, dt, dev)
                           for dt in (torch.float32, torch.float64))
    diff = i32 != i64
    moved = torch.zeros(nb + 1, dtype=torch.bool, device=dev)
    moved[i32[diff]] = True
    moved[i64[diff]] = True
    return int(diff.sum()), moved[1:nb].cpu().numpy()


def cola_health(grid, cosmo0, delta, label: str) -> None:
    """scripts/bench_cola.py's health: P/P_lin on 3e-3 < k < 2e-2 inside
    [0.5, 2.0] and a finite, positive std(delta)."""
    from fastbox_tpu_torch.ops.spectra import binned_power_spectrum

    std = delta.double().std().item()
    kc, pk, _ = binned_power_spectrum(grid, delta_x=delta)
    kc, pk = kc.cpu().numpy(), pk.cpu().numpy()
    pk_lin = cosmo0.pk_lin(torch.as_tensor(kc)).cpu().numpy()
    sel = np.isfinite(pk) & (kc > 3e-3) & (kc < 2e-2) & (pk_lin > 0)
    ratio = pk[sel] / pk_lin[sel]
    log(f"{label}: std(delta) {std:.5f}; P/P_lin on 3e-3 < k < 2e-2: "
        + " ".join(f"{r:.3f}" for r in ratio))
    check(np.isfinite(std) and std > 0, f"{label}: std(delta) {std}")
    check(sel.sum() >= 3 and bool(np.all((ratio >= 0.5) & (ratio <= 2.0))),
          f"{label}: P/P_lin {ratio}")


def run_cola(label: str, grid, cosmo0, dev, **kw):
    """One realisation with the kernels; returns (outputs, wall seconds)."""
    from fastbox_tpu_torch.fields.cola import realise_density_cola
    from fastbox_tpu_torch.timing import StageClock

    clock = StageClock(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = realise_density_cola(kw.pop("generator", None), grid, cosmo0,
                               redshift_init=COLA_Z_INIT, lattice_B=3,
                               diagnostics=True, clock=clock, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    delta, vel, diag = out
    check(delta.shape == grid.shape and bool(torch.isfinite(delta).all()),
          f"{label}: delta not finite of shape {grid.shape}")
    log(f"{label}: {wall * 1e3:.1f} ms, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; bands per step "
        f"{[int(i) + 1 for i in diag['used_lattice']]} (4 = exact scatter); "
        f"max|d| {[round(v, 2) for v in diag['maxdisp'].tolist()]}, final "
        f"{diag['final_maxdisp'].item():.2f}; stages ms "
        + json.dumps({k: round(v, 2) for k, v in clock.ms().items()}))
    return out, wall


def phase_cola(dev, kernels: list[dict]) -> None:
    """The COLA path with the kernels (counted), then the plain engine on
    the same white noise (not counted)."""
    from fastbox_tpu_torch.cosmology import build_cosmology
    from fastbox_tpu_torch.fields.cola import ColaEngine, realise_density_cola
    from fastbox_tpu_torch.fields.gaussian import white_noise
    from fastbox_tpu_torch.grid import GridSpec
    from fastbox_tpu_torch.ops.cuda import _build
    from fastbox_tpu_torch.ops.spectra import binned_power_spectrum

    cosmo0 = build_cosmology(COSMO, redshift=0.0, device=dev)
    grid = GridSpec.create(box_scale=BOX, nsamp=COLA_N[0])
    gen = torch.Generator(device=dev).manual_seed(2027)
    white = white_noise(gen, grid)

    _build.reset_launch_counts()
    (d1, _, _), wall1 = run_cola("COLA 256^3 realisation 0 (first call)",
                                 grid, cosmo0, dev, keep_velocities=False,
                                 white=white)
    (d2, _, _), wall2 = run_cola("COLA 256^3 realisation 1", grid, cosmo0,
                                 dev, keep_velocities=False, generator=gen)
    (d3, vel, _), wall3 = run_cola(
        "COLA 256^3 realisation 2 (keep_velocities, per-component gathers)",
        grid, cosmo0, dev, keep_velocities=True, fuse_force_gather=False,
        generator=gen)
    check(vel.shape == (3,) + grid.shape and bool(torch.isfinite(vel).all()),
          "COLA velocities not finite")
    log(f"COLA 256^3 velocities: rms {vel.double().std().item():.2f} km/s")
    for d, label in ((d1, "realisation 0"), (d2, "realisation 1"),
                     (d3, "realisation 2")):
        cola_health(grid, cosmo0, d, f"COLA 256^3 {label}")
    del d2, d3, vel
    for box in (BOX, 2 * BOX):
        g512 = GridSpec.create(box_scale=box, nsamp=COLA_N[1])
        d512 = run_cola(f"COLA 512^3 in a {box / 1e3:.0f} Gpc box", g512,
                        cosmo0, dev, keep_velocities=False,
                        generator=gen)[0][0]
        cola_health(g512, cosmo0, d512, f"COLA 512^3 {box / 1e3:.0f} Gpc")
        del d512
    counts = _build.launch_counts()
    log(f"launch counts over the COLA path: {json.dumps(counts)}")
    check_route_off(counts, "the COLA path")
    for r in kernels:
        r["launches"] = counts.get(r["name"], 0)
        check(r["launches"] > 0, f"{r['name']} never launched on the COLA path")
    log(f"COLA 256^3: {wall2 * 1e3:.1f} ms per realisation (realisation 1; "
        f"first call {wall1 * 1e3:.1f} ms, keep_velocities "
        f"{wall3 * 1e3:.1f} ms)")

    # The plain engine (roll-form twins) on the card, same white noise.
    kw = dict(redshift_init=COLA_Z_INIT, lattice_B=3, device=dev,
              keep_velocities=False)
    eng_k = ColaEngine(grid, cosmo0, lattice_impl="cuda", **kw)
    eng_p = ColaEngine(grid, cosmo0, lattice_impl="plain", **kw)
    x, _, _, _ = eng_k.initial_conditions(white)
    a0 = eng_k.rows[0][7]
    fk, _ = eng_k.force(x, a0)
    fp, _ = eng_p.force(x, a0)
    e = norm_err(fk, fp)
    log(f"COLA first force evaluation, kernels vs plain: {e:.3e} of "
        f"max|F| (bitwise equal: {torch.equal(fk, fp)})")
    check(e <= K11_TWIN_BOUND, f"COLA first force: {e}")
    del x, fk, fp
    t0 = time.perf_counter()
    dp, _ = realise_density_cola(None, grid, cosmo0, white=white,
                                 redshift_init=COLA_Z_INIT, lattice_B=3,
                                 keep_velocities=False, lattice_impl="plain")
    torch.cuda.synchronize()
    log(f"COLA 256^3 with the plain twins: "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    s_k, s_p = d1.double().std().item(), dp.double().std().item()
    log(f"COLA kernels vs plain, same white noise: std(delta) {s_k:.6f} vs "
        f"{s_p:.6f} (bitwise equal fields: {torch.equal(d1, dp)})")
    check(abs(s_k / s_p - 1) <= 5e-3, "COLA std(delta): kernels vs plain")
    # K11 sums in its twins' order with explicit rounding: the two engines
    # give the same field bit for bit
    check(torch.equal(d1, dp), "COLA kernels vs plain: fields differ")
    kc, pk_k, _ = binned_power_spectrum(grid, delta_x=d1)
    _, pk_p, _ = binned_power_spectrum(grid, delta_x=dp)
    kc, pk_k, pk_p = (t.cpu().numpy() for t in (kc, pk_k, pk_p))
    sel = np.isfinite(pk_p) & (kc < 0.5 * np.pi * grid.N / grid.Lx)
    rel = np.abs(pk_k[sel] / pk_p[sel] - 1)
    log("COLA P(k) kernels/plain - 1 for k < k_Nyq/2: "
        + " ".join(f"{v:.1e}" for v in rel))
    check(sel.sum() >= 5 and bool(np.all(rel <= 1e-2)), "COLA P(k) off plain")
    return grid, cosmo0, white, d1


def run_pipeline(fn, dev, label: str, grid, **kw) -> dict:
    from fastbox_tpu_torch.timing import StageClock

    clock = StageClock(dev)
    t0 = time.perf_counter()
    out = fn(clock=clock, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stages = clock.ms()
    full = populated_bins(grid, dev)
    for key in ("pk_cleaned", "pk_density", "pk_cleaned_err"):
        v = out[key].cpu().numpy()
        check(v.shape == (19,), f"{label}: {key} shape {v.shape}")
        check(bool(np.isfinite(v[full]).all() and (v[full] >= 0).all()),
              f"{label}: {key} not finite and >= 0 in populated bins")
    check(bool(torch.isfinite(out["sigma_data"])), f"{label}: sigma_data")
    log(f"{label}: {wall * 1e3:.2f} ms wall; stages ms "
        + json.dumps({k: round(v, 3) for k, v in stages.items()}))
    return dict(out=out, wall=wall, stages=stages)


def counted(label: str, expect: tuple, body):
    """Run ``body`` with the launch counters reset just before and read
    just after; fail unless every kernel in ``expect`` launched."""
    from fastbox_tpu_torch.ops.cuda import _build

    _build.reset_launch_counts()
    result = body()
    counts = _build.launch_counts()
    log(f"{label}: launch counts {json.dumps(counts)}")
    for name in expect:
        check(counts.get(name, 0) > 0, f"{name} never launched on {label}")
    check_route_off(counts, label)
    return result, counts


def check_route_off(counts: dict, label: str) -> None:
    """A path run with the K10 route off must not launch K10."""
    check(counts.get(K10, 0) == 0,
          f"{label}: K10 launched {counts.get(K10)} times with the route off")


def mid_k_ratio(outs, cosmo, grid) -> np.ndarray:
    """mean pk_density / P_nl over realisations on 2 kmin < k < 0.3 kmax
    (tests/test_pipeline.py:92-107)."""
    k = outs[0]["k"]
    mean = np.mean([o["pk_density"].double().cpu().numpy() for o in outs],
                   axis=0)
    th = cosmo.pk_nl(k.double()).cpu().numpy()
    k = k.double().cpu().numpy()
    sel = np.isfinite(mean) & (k > 2 * grid.kmin) & (k < 0.3 * grid.kmax)
    return mean[sel] / th[sel]


def wall_ms(fn) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def max_rel(a, b) -> float:
    a, b = a.double().cpu().numpy(), b.double().cpu().numpy()
    ok = np.isfinite(b) & (b != 0)
    return float(np.max(np.abs(a[ok] - b[ok]) / np.abs(b[ok])))


def phase_paths(dev, cosmo, grid, fn256) -> dict:
    """The pipeline's other entry points and configurations; returns the
    launches of K5, K6, K9a and K9b on their paths."""
    from fastbox_tpu_torch.fields.gaussian import realise_density
    from fastbox_tpu_torch.grid import GridSpec
    from fastbox_tpu_torch.ops.spectra import binned_power_spectrum
    from fastbox_tpu_torch.pipeline import (PipelineConfig, draw_inputs,
                                            make_chained_pipeline,
                                            make_ensemble_pipeline,
                                            make_pipeline)

    launches = {}
    gen = torch.Generator(device=dev).manual_seed(300)
    grid512 = GridSpec.create(box_scale=BOX, nsamp=N_BIG, redshift=Z)

    # anisotropic box: K5 bins it
    ga256 = GridSpec.create(box_scale=ANISO_BOX, nsamp=N_MAIN, redshift=Z)
    ga512 = GridSpec.create(box_scale=ANISO_BOX, nsamp=N_BIG, redshift=Z)
    fa256 = make_pipeline(ga256, cosmo, PipelineConfig(), device=dev)
    fa512 = make_pipeline(ga512, cosmo, PipelineConfig(), device=dev)

    def aniso():
        runs = [run_pipeline(fa256, dev, f"anisotropic 256^3 realisation {i}",
                             ga256, generator=gen) for i in range(3)]
        run = run_pipeline(fa512, dev, "anisotropic 512^3 realisation 0",
                           ga512, generator=gen)
        return runs, run

    (runs, run), counts = counted("the anisotropic path",
                                  ("binned_pk_half_dual",), aniso)
    launches["binned_pk_half_dual"] = counts["binned_pk_half_dual"]
    log(f"anisotropic 4x4x2 Gpc: 256^3 {runs[-1]['wall'] * 1e3:.2f} ms per "
        f"realisation (realisation 2), 512^3 {run['wall'] * 1e3:.2f} ms "
        "(first call)")

    # pallas_draw 'on' and 'vz': K9a and K9b draw the density
    for draw, name in (("on", "colored_half_draw"),
                       ("vz", "colored_half_draw_vz")):
        cfg = PipelineConfig(pallas_draw=draw)
        f256 = make_pipeline(grid, cosmo, cfg, device=dev)
        f512 = make_pipeline(grid512, cosmo, cfg, device=dev)

        def drawn():
            runs = [run_pipeline(f256, dev, f"pallas_draw={draw} 256^3 "
                                 f"realisation {i}", grid, generator=gen)
                    for i in range(3)]
            run = run_pipeline(f512, dev, f"pallas_draw={draw} 512^3 "
                               "realisation 0", grid512, generator=gen)
            return runs, run

        (runs, run), counts = counted(f"pallas_draw={draw}", (name,), drawn)
        launches[name] = counts[name]
        ratio = mid_k_ratio([r["out"] for r in runs], cosmo, grid)
        log(f"pallas_draw={draw}: 256^3 {runs[-1]['wall'] * 1e3:.2f} ms per "
            f"realisation, 512^3 {run['wall'] * 1e3:.2f} ms (first call); "
            "mean pk_density/P_nl over 3 realisations on the mid-k bins: "
            + " ".join(f"{v:.3f}" for v in ratio))
        check(ratio.size >= 3 and bool(np.all((ratio > 0.6) & (ratio < 1.6))),
              f"pallas_draw={draw}: pk_density/P_nl {ratio}")

    # the instrument response, and the subspace clean, on the same draws
    draws = draw_inputs(grid, torch.Generator(device=dev).manual_seed(31))
    base = fn256(draws=draws)
    f_inst = make_pipeline(grid, cosmo, PipelineConfig(
        beam_dish_m=13.5, kpar_min=0.05), device=dev)
    inst = f_inst(draws=draws)
    inst2 = run_pipeline(f_inst, dev, "instrument response 256^3", grid,
                         generator=gen)
    s0, s1 = base["sigma_data"].item(), inst["sigma_data"].item()
    log(f"instrument response (beam 13.5 m, kpar_min 0.05): sigma_data "
        f"{s1:.5f} vs {s0:.5f} without; {inst2['wall'] * 1e3:.2f} ms per "
        "realisation")
    check(s1 < s0, "the instrument response did not lower sigma_data")
    f_sub = make_pipeline(grid, cosmo, PipelineConfig(pca_exact=False),
                          device=dev)
    sub = f_sub(draws=draws)
    sub2 = run_pipeline(f_sub, dev, "pca_exact=False 256^3", grid,
                        generator=gen)
    full = populated_bins(grid, dev)
    rel = np.abs(sub["pk_cleaned"].double().cpu().numpy()[full]
                 / base["pk_cleaned"].double().cpu().numpy()[full] - 1)
    log("pca_exact=False vs exact, same draws, pk_cleaned per-bin rel "
        "diff: " + " ".join(f"{v:.2e}" for v in rel)
        + f"; {sub2['wall'] * 1e3:.2f} ms per realisation")
    check(bool(np.all(np.isfinite(rel))), "pca_exact=False: not finite")

    # make_chained_pipeline: chain 16 at 256^3 (bench.py:236).  Both
    # hoists must reproduce single calls bit for bit: 'off' runs the same
    # calls, and 'on''s batched eigh decomposes each 256 x 256 matrix with
    # the solver a single call uses (bitwise equal on an H100).
    singles = [fn256(torch.Generator(device=dev).manual_seed(600 + i))
               for i in range(2)]
    for hoist in ("off", "on"):
        chain = make_chained_pipeline(grid, cosmo,
                                      PipelineConfig(eigh_hoist=hoist),
                                      device=dev)
        gens = [torch.Generator(device=dev).manual_seed(600 + i)
                for i in range(16)]
        out, ms = wall_ms(lambda: chain(generators=gens))
        check(out["pk_cleaned"].shape == (16, 19), "chain: output shape")
        same = all(torch.equal(out[k][i].nan_to_num(), one[k].nan_to_num())
                   for i, one in enumerate(singles) for k in one)
        rel_c = max(max_rel(out["pk_cleaned"][i], one["pk_cleaned"])
                    for i, one in enumerate(singles))
        rel_d = max(max_rel(out["pk_density"][i], one["pk_density"])
                    for i, one in enumerate(singles))
        log(f"chain 16 at 256^3, eigh_hoist={hoist}: {ms / 16:.2f} ms per "
            f"realisation ({ms:.1f} ms); first two vs single calls: bitwise "
            f"{same}, pk_cleaned {rel_c:.2e}, pk_density {rel_d:.2e}")
        check(same, f"chain eigh_hoist={hoist} differs from single calls "
              f"(pk_cleaned {rel_c}, pk_density {rel_d})")

    # make_ensemble_pipeline: 8 x 128^3 in a 2 Gpc box
    g128 = GridSpec.create(box_scale=2e3, nsamp=N_ENS, redshift=Z)
    ens = make_ensemble_pipeline(g128, cosmo, PipelineConfig(), device=dev)
    ens([torch.Generator(device=dev).manual_seed(700)])           # warm-up
    gens = [torch.Generator(device=dev).manual_seed(701 + i) for i in range(8)]
    out, ms = wall_ms(lambda: ens(generators=gens))
    pk = out["pk_cleaned"].cpu().numpy()
    ok = populated_bins(g128, dev)
    check(pk.shape == (8, 19) and bool(np.isfinite(pk[:, ok]).all()),
          "ensemble: shape or finiteness")
    check(not np.array_equal(pk[0], pk[1]), "ensemble: equal realisations")
    log(f"ensemble 8 x 128^3 (2 Gpc): {ms / 8:.2f} ms per realisation "
        f"({ms:.1f} ms)")

    # the full-spectrum estimator on K6
    def estimate():
        _, delta_k = realise_density(torch.Generator(device=dev)
                                     .manual_seed(800), grid, cosmo)
        return binned_power_spectrum(grid, delta_k=delta_k)

    (kc, pk, _), counts = counted("binned_power_spectrum(delta_k=...)",
                                  ("binned_pk_full",), estimate)
    launches["binned_pk_full"] = counts["binned_pk_full"]
    kc64 = kc.double()
    ratio = (pk.double() / cosmo.pk_nl(kc64)).cpu().numpy()
    kcn = kc64.cpu().numpy()
    sel = np.isfinite(ratio) & (kcn > 2 * grid.kmin) & (kcn < 0.3 * grid.kmax)
    log("realise_density 256^3 -> binned_power_spectrum (K6): P/P_nl on the "
        "mid-k bins: " + " ".join(f"{v:.3f}" for v in ratio[sel]))
    check(sel.sum() >= 3 and bool(np.all((ratio[sel] > 0.6)
                                         & (ratio[sel] < 1.6))),
          f"K6 estimator: P/P_nl {ratio[sel]}")
    return launches


def truth_aniso(dev, cosmo_cpu, cosmo) -> None:
    """The anisotropic 256^3 box in f32 on the card against the port on
    the CPU, same draws.  Over the bins whose modes the f32 and the f64
    digitize agree on, against the CPU f64 run: pk_density within 3x the
    port's own f32-vs-f64 error on the CPU (tests/test_torch_pipeline.py
    :126-135); pk_cleaned within the cube's truth bound, with the card's
    and the CPU f32's largest errors printed side by side.  A bin that
    the two digitizes fill differently (the fundamentals along the long
    axes sit one f64 ulp below the first edge) has no f64 counterpart: it
    is held against the CPU f32 run, which bins the same modes."""
    from fastbox_tpu_torch.grid import GridSpec
    from fastbox_tpu_torch.pipeline import (PipelineConfig, draw_inputs,
                                            make_pipeline)

    ga = GridSpec.create(box_scale=ANISO_BOX, nsamp=N_MAIN, redshift=Z)
    draws = draw_inputs(ga, torch.Generator().manual_seed(8), torch.float64)
    gpu = make_pipeline(ga, cosmo, PipelineConfig(), device=dev)(draws=draws)
    t0 = time.perf_counter()
    cpu64 = make_pipeline(ga, cosmo_cpu, PipelineConfig(dtype="float64"),
                          device="cpu")(draws=draws)
    cpu32 = make_pipeline(ga, cosmo_cpu, PipelineConfig(),
                          device="cpu")(draws=draws)
    log(f"anisotropic truth: the CPU f64 and f32 runs took "
        f"{time.perf_counter() - t0:.1f} s")
    full = populated_bins(ga, dev) & np.isfinite(cpu64["pk_density"].numpy())
    n_moved, moved = moved_modes(ga, dev)
    moved = moved[full]
    log(f"anisotropic truth: {n_moved} modes change bin between the f32 and "
        f"f64 digitize, in retained bins "
        f"{[int(b) + 1 for b in np.flatnonzero(full)[moved]]}")
    check(moved.sum() <= 1, "more than one retained bin changes membership")
    for name in ("pk_density", "pk_cleaned"):
        c = cpu64[name].numpy()[full]
        gv = gpu[name].double().cpu().numpy()[full]
        fv = cpu32[name].double().numpy()[full]
        g = (np.abs(gv - c) / np.abs(c))[~moved]
        f = (np.abs(fv - c) / np.abs(c))[~moved]
        m = (np.abs(gv - fv) / np.abs(fv))[moved]
        log(f"anisotropic truth {name} per-bin rel err vs CPU f64, bins of "
            f"unchanged membership, card f32: "
            + " ".join(f"{v:.2e}" for v in g))
        log(f"anisotropic truth {name} per-bin rel err vs CPU f64, bins of "
            f"unchanged membership, CPU f32:  "
            + " ".join(f"{v:.2e}" for v in f))
        log(f"anisotropic truth {name}: largest card {g.max():.3e}, 3 x "
            f"largest CPU f32 {3 * f.max():.3e}; moved bin, card vs CPU f32: "
            + " ".join(f"{v:.2e}" for v in m))
        bound = 3.0 * f.max() if name == "pk_density" else TRUTH_BOUND[name]
        check(g.max() <= bound,
              f"anisotropic truth {name}: {g.max()} > {bound}")
        check(bool(np.all(m <= TRUTH_BOUND[name])),
              f"anisotropic truth {name}, moved bin vs CPU f32: {m}")


def phase_k7(dev, cosmo) -> dict:
    """K7 bitwise equal to its twin on coordinates wrapped beforehand, at
    bands 2 and 4, f32 and f64, on every line of RSD_CASES, and at band 3
    on the cube (the direct path); timed on the cube at both bands."""
    from fastbox_tpu_torch.ops.cuda import rsd_fused as k

    errs, ms = [], {}
    for band, cells in ((2, 1.9), (4, 3.9), (3, 2.9)):
        for case in RSD_CASES if band != 3 else RSD_CASES[:1]:
            vals, vel, z, fill, wrap, inv_hz, _ = rsd_case_inputs(
                cosmo, dev, case, cells, seed=70 + band)
            s = torch.remainder(z[None, :] - vel * inv_hz - wrap[0],
                                wrap[1]) + wrap[0]
            for dt in (torch.float32, torch.float64):
                args = tuple(t.to(dt).contiguous() for t in (s, vals, z, fill))
                staged = k.staged_path(s.shape[1], band, args[0], args[1])
                got = k.rsd_bracket_interp_cuda(*args, band)
                want = k.rsd_bracket_interp_plain(*args, band)
                same = torch.equal(got, want)
                log(f"K7 band {band} {case[0]} {tuple(got.shape)} {dt} "
                    f"({'staged' if staged else 'direct'}): bitwise "
                    f"{same}, {norm_err(got, want):.3e}")
                check(same, f"K7 band {band} {case[0]} {dt}: not bitwise "
                      "equal to the twin")
                errs.append((got - want).abs().max().item())
            if case[0] == "cube" and band != 3:
                args = (s, vals, z, fill, band)
                ms[band] = (median_ms(lambda: k.rsd_bracket_interp_cuda(*args)),
                            median_ms(lambda: k.rsd_bracket_interp_plain(*args)))
                log(f"K7 band {band} f32 cube: kernel {ms[band][0]:.4f} ms, "
                    f"plain {ms[band][1]:.4f} ms")
    # per target: two one-sided selects over 6B+4 offsets (4 each) and the
    # interpolation (5), at band 2
    return dict(name="rsd_bracket_interp", max_abs_err=max(errs),
                ms=ms[2][0], plain_ms=ms[2][1], library_ms=None,
                **roofline(nbytes(s, vals, z, fill, vals),
                           vals.numel() * (4 * (6 * 2 + 4) + 5)))


def k8_special_rows(ss, z):
    """Sorted rows with duplicate nodes (ds = 0), nodes exactly on targets,
    and first and last nodes exactly on the hull edges, sorted again."""
    ss = ss.clone()
    ss[::3, 10] = ss[::3, 11]
    ss[1::3, 20:24] = ss[1::3, 20:21]
    ss[2::5, 30] = z[31]
    ss[::4, 50] = ss[::4, 51] = z[50]
    ss[::7, 0] = z[0]
    ss[::11, -1] = z[-1]
    return torch.sort(ss, dim=1).values.contiguous()


def phase_k8(dev, nodes: dict) -> dict:
    """K8 bitwise equal to its twin (torch.equal) on the sorted nodes of the
    sharded steps in ``nodes`` (label -> the remap's vals, s, z, fill: the
    256^3 B = 8 step's first), f32 and f64, bands 2 and 4 (the staged
    path); on the first step's rows with duplicate nodes, nodes on targets
    and on the hull edges; on 62-cell and unaligned rows and at band 3
    (the direct path).  Timed on every step's nodes at band 4, f32."""
    from fastbox_tpu_torch.ops.cuda import banded_interp as k

    def same(what, ss, vv, z, fill, band, staged):
        check(k.staged_path(ss.shape[1], band, ss, vv) == staged,
              f"K8 {what}: not on the {'staged' if staged else 'direct'} path")
        got = k.banded_interp_cuda(ss, vv, z, fill, band)
        eq = torch.equal(got, k.banded_interp_plain(ss, vv, z, fill, band))
        log(f"K8 {what} {tuple(ss.shape)} band {band} "
            f"({'staged' if staged else 'direct'}): bitwise {eq}")
        check(eq, f"K8 {what} band {band}: not bitwise equal to the twin")

    ms, row = {}, None
    for label, (vals, s, z, fill) in nodes.items():
        ss, order = torch.sort(s, dim=1, stable=True)
        vv = torch.gather(vals, 1, order)
        del order
        for dt in (torch.float32, torch.float64):
            args = tuple(t.to(dt).contiguous() for t in (ss, vv, z, fill))
            for band in (2, 4):
                same(f"{label} step's nodes, {dt}", *args, band, True)
            if row is None:      # the first step's rows: the special cases
                sp = (k8_special_rows(args[0][:65536], args[2]),
                      args[1][:65536].contiguous(), args[2],
                      args[3][:65536].contiguous())
                for band in (2, 4):
                    same(f"duplicates / on nodes / hull edges, {dt}", *sp,
                         band, True)
                short = tuple(t[:4096, :62].contiguous() for t in sp[:2])
                for band in (2, 3, 4):
                    same(f"62-cell rows, {dt}", *short, sp[2][:62].contiguous(),
                         sp[3][:4096].contiguous(), band, False)
                same(f"band 3, {dt}", *sp, 3, False)
                for band in (2, 4):
                    same(f"unaligned rows, {dt}", unaligned(sp[0]),
                         unaligned(sp[1]), sp[2], sp[3], band, False)
                del sp, short
            del args
        args = (ss, vv, z, fill, 4)
        ms[label] = median_ms(lambda: k.banded_interp_cuda(*args))
        log(f"K8 on the {label} step's sorted nodes {tuple(ss.shape)}, band "
            f"4, f32: kernel {ms[label]:.4f} ms (bound "
            f"{roofline(3 * nbytes(ss) + nbytes(z, fill), 0)['bound_ms']:.4f})")
        if row is None:
            plain_ms = median_ms(lambda: k.banded_interp_plain(*args))
            # per target: 2 band segment terms of ~8 operations each
            row = dict(name="banded_interp", max_abs_err=0.0, ms=ms[label],
                       plain_ms=plain_ms, library_ms=None,
                       **roofline(3 * nbytes(ss) + nbytes(z, fill),
                                  ss.numel() * 64))
        del ss, vv, args
    return row


def run_step(step, dev, label: str, seeds) -> tuple:
    """One sharded step, timed on the host around a synchronise; returns
    (outputs, wall seconds)."""
    from fastbox_tpu_torch.timing import StageClock

    clock = StageClock(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = step(seeds=seeds, clock=clock)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for key in ("pk_cleaned", "pk_density", "pk_cleaned_err"):
        check(out[key].shape == (len(seeds), 19),
              f"{label}: {key} shape {tuple(out[key].shape)}")
    check(bool(torch.isfinite(out["sigma_data"]).all()),
          f"{label}: sigma_data")
    log(f"{label}: {wall * 1e3:.1f} ms, {wall * 1e3 / len(seeds):.2f} ms per "
        f"realisation; stages ms "
        + json.dumps({k: round(v, 2) for k, v in clock.ms().items()}))
    return out, wall


def phase_sharded(dev, cosmo, grid, fn256) -> tuple:
    """The sharded ensemble step on a one-rank ('ens' 1, 'space' 1) mesh
    under NCCL, the rest of the parallel/ slice, then the v2t path; returns
    (K8's row, the launches of K7, K8 and K4t each on its path)."""
    import tempfile

    import torch.distributed as dist

    import fastbox_tpu_torch.parallel.sharded as sharded
    from fastbox_tpu_torch.grid import GridSpec
    from fastbox_tpu_torch.ops.cuda import _build
    from fastbox_tpu_torch.ops.rsd import remap_los_batched
    from fastbox_tpu_torch.parallel import make_mesh
    from fastbox_tpu_torch.parallel.mesh import init_single_rank
    from fastbox_tpu_torch.pipeline import (PipelineConfig,
                                            make_ensemble_pipeline,
                                            make_pipeline)
    from fastbox_tpu_torch.timing import StageClock

    _build.BUILD_ROOT.parent.mkdir(parents=True, exist_ok=True)
    init_single_rank(dev, tempfile.mkdtemp(prefix="pg_",
                                           dir=_build.BUILD_ROOT.parent))
    mesh = make_mesh(device=dev)
    log(f"mesh: {mesh}")
    grid512 = GridSpec.create(box_scale=BOX, nsamp=N_BIG, redshift=Z)
    step256 = sharded.make_sharded_ensemble_step(mesh, grid, cosmo,
                                                 PipelineConfig(), dev)
    step512 = sharded.make_sharded_ensemble_step(mesh, grid512, cosmo,
                                                 PipelineConfig(), dev)
    step_exact = sharded.make_sharded_ensemble_step(
        mesh, grid, cosmo, PipelineConfig(sigma_nl=6000.0), dev)

    # warm-up, keeping the RSD remap's inputs of one real step of each size
    remap = sharded.remap_los_batched
    seen = {}

    def keep(vals, s, z, fill, **kw):
        seen[s.shape[1]] = (vals, s, z, fill, kw)
        return remap(vals, s, z, fill, **kw)

    sharded.remap_los_batched = keep
    try:
        run_step(step256, dev, "sharded 256^3 B=8 warm-up", list(range(8)))
        run_step(step512, dev, "sharded 512^3 B=2 warm-up", [198, 199])
    finally:
        sharded.remap_los_batched = remap

    def main_path():
        torch.cuda.reset_peak_memory_stats()
        out, wall = run_step(step256, dev, "sharded 256^3 B=8",
                             list(range(100, 108)))
        peak256 = torch.cuda.max_memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        run_step(step512, dev, "sharded 512^3 B=2 (first call)", [200, 201])
        _, wall512 = run_step(step512, dev, "sharded 512^3 B=2", [202, 203])
        peak512 = torch.cuda.max_memory_allocated() / 2 ** 30
        return out, wall, peak256, wall512, peak512

    (out, wall, peak256, wall512, peak512), counts = counted(
        "the sharded step", ("banded_interp", "binned_pk_half_dual_v2",
                             "add_scaled_normal"), main_path)
    launches = {"banded_interp": counts["banded_interp"]}
    log(f"sharded step on the one-rank mesh: 256^3 B=8 "
        f"{wall * 1e3 / 8:.2f} ms per realisation (peak device memory "
        f"{peak256:.2f} GiB); 512^3 B=2 {wall512 * 1e3 / 2:.2f} ms per "
        f"realisation (peak {peak512:.2f} GiB); launches K8 "
        f"{counts.get('banded_interp', 0)}, K3 "
        f"{counts.get('interp_sorted', 0)}, K4 "
        f"{counts.get('binned_pk_half_dual_v2', 0)}, K1 "
        f"{counts.get('add_scaled_normal', 0)}")
    # the clean in f64 (ROADMAP C3) against the f32 clean it replaced: the
    # same step with the f64 working copy taken out, in turns
    work, pca_ms = sharded._work, {"f32": [], "f64": []}
    for kind in ("f32", "f64", "f64", "f32"):
        clock = StageClock(dev)
        sharded._work = work if kind == "f64" else (lambda t: t)
        try:
            step256(seeds=list(range(100, 108)), clock=clock)
        finally:
            sharded._work = work
        pca_ms[kind].append(clock.ms()["pca"])
    log("sharded 256^3 B=8, pca stage ms in turns: f64 clean "
        + " ".join(f"{v:.3f}" for v in pca_ms["f64"]) + ", f32 clean "
        + " ".join(f"{v:.3f}" for v in pca_ms["f32"]))
    ratio = mid_k_ratio([{"k": out["k"], "pk_density": p}
                         for p in out["pk_density"]], cosmo, grid)
    log("sharded 256^3: mean pk_density/P_nl over 8 realisations on the "
        "mid-k bins: " + " ".join(f"{v:.3f}" for v in ratio))
    check(ratio.size >= 3 and bool(np.all((ratio > 0.6) & (ratio < 1.6))),
          f"sharded: pk_density/P_nl {ratio}")

    _, counts = counted("the sharded step, sigma_nl=6000 (exact tier)",
                        ("interp_sorted",),
                        lambda: run_step(step_exact, dev,
                                         "sharded 256^3 B=8 sigma_nl=6000",
                                         list(range(300, 308))))

    # K8 on the steps' sorted nodes; then the 256^3 step's remap through K7
    # with the unwrapped coordinates (the batched remap's fused branch)
    k8 = phase_k8(dev, {"256^3 B=8": seen[N_MAIN][:4],
                        "512^3 B=2": seen[N_BIG][:4]})
    del seen[N_BIG]
    vals, s, z, fill, kw = seen[N_MAIN]
    via_k8 = remap(vals, s, z, fill, **kw)
    length = float(z[-1] - z[0])
    u = s + length * torch.round((z[None, :] - s) / length)
    via_k7, counts = counted(
        "remap_los_batched(s_unwrapped=...) on the step's inputs",
        ("rsd_bracket_interp",),
        lambda: remap_los_batched(vals, s, z, fill, ztarget_np=np.asarray(
            grid.z), s_unwrapped=u))
    launches["rsd_bracket_interp"] = counts["rsd_bracket_interp"]
    off = ((via_k7 - via_k8).abs() > 1e-5 * via_k8.abs().max()).sum().item()
    log(f"the step's remap through K7 vs through the sort and K8: {off} of "
        f"{via_k8.numel()} values differ (ties with a periodic image)")
    check(off <= 1e-6 * via_k8.numel(), f"K7 vs K8 remap: {off} differ")
    del vals, s, u, via_k7, via_k8, seen

    # the step against the single pipeline in rows mode, same seeds
    seeds = list(range(400, 408))
    fn_rows = make_pipeline(grid, cosmo, PipelineConfig(noise_scheme="rows"),
                            device=dev)
    got = step256(seeds=seeds)
    singles, walls = [], []
    for sd in seeds:
        one, ms = wall_ms(lambda: fn_rows(seed=sd))
        singles.append(one)
        walls.append(ms)
    full = populated_bins(grid, dev)
    worst = {}
    for name in ("pk_density", "pk_cleaned", "sigma_data"):
        rel = [np.abs(got[name][i].double().cpu().numpy()
                      / one[name].double().cpu().numpy() - 1)
               for i, one in enumerate(singles)]
        if name != "sigma_data":
            rel = [r[full] for r in rel]
        worst[name] = float(np.max(rel))
        log(f"step vs single rows pipeline, {name} per-bin rel diff, "
            "realisation 0: " + " ".join(f"{v:.2e}" for v in
                                          np.atleast_1d(rel[0]))
            + f"; largest over 8: {worst[name]:.3e}")
    check(worst["pk_density"] <= 1e-5,
          f"step vs rows pipeline pk_density {worst['pk_density']}")
    check(worst["pk_cleaned"] <= TRUTH_BOUND["pk_cleaned"],
          f"step vs rows pipeline pk_cleaned {worst['pk_cleaned']}")
    log(f"single pipeline, noise_scheme='rows', 256^3: "
        f"{statistics.median(walls[1:]):.2f} ms per realisation")

    # make_ensemble_pipeline over the mesh against the mesh-less call
    g128 = GridSpec.create(box_scale=2e3, nsamp=N_ENS, redshift=Z)
    gens = lambda: [torch.Generator(device=dev).manual_seed(900 + i)
                    for i in range(8)]
    ens_mesh = make_ensemble_pipeline(g128, cosmo, PipelineConfig(),
                                      device=dev, mesh=mesh)
    ens = make_ensemble_pipeline(g128, cosmo, PipelineConfig(), device=dev)
    a, ms_mesh = wall_ms(lambda: ens_mesh(gens()))
    b, ms_ens = wall_ms(lambda: ens(gens()))
    same = all(torch.equal(a[k].nan_to_num(), b[k].nan_to_num()) for k in b)
    log(f"ensemble 8 x 128^3 over the mesh: {ms_mesh / 8:.2f} ms per "
        f"realisation ({ms_ens / 8:.2f} without); bitwise equal to the "
        f"mesh-less call: {same}")
    check(same, "make_ensemble_pipeline(mesh=...) differs from mesh=None")

    # rsd_method='nearest', one 256^3 realisation
    fn_near = make_pipeline(grid, cosmo, PipelineConfig(rsd_method="nearest"),
                            device=dev)
    fn_near(torch.Generator(device=dev).manual_seed(1))
    run_pipeline(fn_near, dev, "rsd_method='nearest' 256^3", grid,
                 generator=torch.Generator(device=dev).manual_seed(2))
    launches[K4T] = phase_v2t(dev, cosmo, grid, fn256, mesh)
    dist.destroy_process_group()
    return [k8], launches


def phase_v2t(dev, cosmo, grid, fn256, mesh) -> int:
    """pallas_pk='v2t': the 256^3 pipeline, two realisations on supplied
    draws, must launch K4t once each and K4 never, and agree with the
    default run on the same draws; then one 256^3 B=2 step with 'v2t' on
    the one-rank mesh, K4t once per realisation's slab.  Returns K4t's
    launches on both."""
    from fastbox_tpu_torch.parallel import make_sharded_ensemble_step
    from fastbox_tpu_torch.pipeline import (PipelineConfig, draw_inputs,
                                            make_pipeline)

    cfg = PipelineConfig(pallas_pk="v2t")
    fn = make_pipeline(grid, cosmo, cfg, device=dev)
    draws = [draw_inputs(grid, torch.Generator().manual_seed(s))
             for s in (61, 62)]
    runs, counts = counted("the v2t pipeline", (K4T,), lambda: [
        run_pipeline(fn, dev, f"v2t 256^3 realisation {i}", grid, draws=d)
        for i, d in enumerate(draws)])
    check(counts[K4T] == len(draws) and counts.get(K4, 0) == 0,
          f"v2t pipeline: K4t {counts[K4T]}, K4 {counts.get(K4, 0)} launches")
    launches = counts[K4T]
    full = populated_bins(grid, dev)
    for i, (run, d) in enumerate(zip(runs, draws)):
        base = fn256(draws=d)
        for name in ("pk_density", "pk_cleaned"):
            rel = np.abs(run["out"][name].double().cpu().numpy()[full]
                         / base[name].double().cpu().numpy()[full] - 1)
            log(f"v2t vs default, realisation {i}, {name}: largest per-bin "
                f"rel diff {rel.max():.3e}")
            check(rel.max() <= V2T_BOUND, f"v2t vs default {name}: {rel.max()}")
    step = make_sharded_ensemble_step(mesh, grid, cosmo, cfg, dev)
    seeds = [500, 501]
    out, counts = counted("the sharded step, v2t", (K4T,), lambda: run_step(
        step, dev, "sharded 256^3 B=2 v2t", seeds)[0])
    check(counts[K4T] == len(seeds) and counts.get(K4, 0) == 0,
          f"v2t step: K4t {counts[K4T]}, K4 {counts.get(K4, 0)} launches")
    base = make_sharded_ensemble_step(mesh, grid, cosmo, PipelineConfig(),
                                      dev)(seeds=seeds)
    for name in ("pk_density", "pk_cleaned"):
        rel = np.abs(out[name].double().cpu().numpy()[:, full]
                     / base[name].double().cpu().numpy()[:, full] - 1)
        log(f"v2t step vs default step, same seeds, {name}: largest per-bin "
            f"rel diff {rel.max():.3e}")
        check(rel.max() <= V2T_BOUND, f"v2t step vs default {name}")
    return launches + counts[K4T]


def explore_1024(dev) -> None:
    """``--step-1024``: one sharded step at 1024^3 with B = 1 on the
    one-rank mesh, to see whether it fits the card: its wall time, peak
    device memory (or the out-of-memory error) and launch counts.  Not a
    check: it exits 0 either way."""
    import tempfile

    import torch.distributed as dist

    from fastbox_tpu_torch.cosmology import build_cosmology
    from fastbox_tpu_torch.grid import GridSpec
    from fastbox_tpu_torch.ops.cuda import _build
    from fastbox_tpu_torch.parallel import (make_mesh,
                                            make_sharded_ensemble_step)
    from fastbox_tpu_torch.parallel.mesh import init_single_rank
    from fastbox_tpu_torch.pipeline import PipelineConfig

    _build.BUILD_ROOT.parent.mkdir(parents=True, exist_ok=True)
    init_single_rank(dev, tempfile.mkdtemp(prefix="pg_",
                                           dir=_build.BUILD_ROOT.parent))
    cosmo = build_cosmology(COSMO, redshift=Z, device=dev)
    grid = GridSpec.create(box_scale=BOX, nsamp=1024, redshift=Z)
    step = make_sharded_ensemble_step(make_mesh(device=dev), grid, cosmo,
                                      PipelineConfig(), dev)
    for i in range(2):
        _build.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        try:
            run_step(step, dev, f"sharded 1024^3 B=1 call {i}", [i])
        except torch.OutOfMemoryError as e:
            log(f"sharded 1024^3 B=1: out of memory ({str(e)[:200]})")
            break
        finally:
            log(f"peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
                f"launch counts {json.dumps(_build.launch_counts())}")
    dist.destroy_process_group()


def complex_err(got, want) -> float:
    """max|got - want| / max|want| of two complex tensors, in complex128."""
    got, want = got.to(torch.complex128), want.to(torch.complex128)
    return ((got - want).abs().max() / want.abs().max()).item()


def k10_every_length(dev) -> None:
    """K10 at every supported length on both axes and signs, f32 and f64,
    against complex128 torch.fft and its twin; each length also on a
    column count that leaves the kernel's last tile ragged."""
    from fastbox_tpu_torch.ops.cuda import mmdft as k

    g = torch.Generator(device=dev).manual_seed(100)
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    for C in K10_LENGTHS:
        check(k.supported_length(C), f"K10: {C} is not a supported length")
        for shape, axis in (((C, 6, 40), 0), ((6, C, 40), 1), ((C, 3, 7), 0),
                            ((5, C, 3), 1)):
            for dt in (torch.float32, torch.float64):
                xr = torch.randn(shape, generator=g, device=dev, dtype=dt)
                xi = torch.randn(shape, generator=g, device=dev, dtype=dt)
                x = torch.complex(xr.double(), xi.double())
                for sign in (-1, 1):
                    got = torch.complex(*k.dft_c2c_axis_cuda(xr, xi, axis,
                                                             sign, sign > 0))
                    ref = (torch.fft.fft(x, dim=axis) if sign < 0
                           else torch.fft.ifft(x, dim=axis))
                    twin = torch.complex(*k.dft_c2c_axis_plain(
                        xr, xi, axis, sign, sign > 0))
                    e = max(complex_err(got, ref), complex_err(got, twin))
                    worst[dt] = max(worst[dt], e)
                    check(e <= K10_BOUND, f"K10 C={C} {shape} axis {axis} "
                          f"{dt} sign {sign:+d}: {e}")
    log(f"K10 at every supported length {K10_LENGTHS}, both axes and signs, "
        "ragged tiles: largest error of max|y| vs complex128 torch.fft and "
        f"the twin: f32 {worst[torch.float32]:.2e}, f64 "
        f"{worst[torch.float64]:.2e}")


def phase_k10(dev) -> dict:
    """K10 at every supported length, then against its twin and complex128
    torch.fft at the route's planar shapes, both axes and signs; the
    kernel, torch.fft.fft along the same axis and the bound at both shapes
    and axes, forward.  The row is the (256, 256, 129) axis-1 forward
    call."""
    from fastbox_tpu_torch.ops.cuda import mmdft as k

    k10_every_length(dev)
    g = torch.Generator(device=dev).manual_seed(10)
    row = None
    for N in (N_MAIN, N_BIG):
        shape = (N, N, N // 2 + 1)
        xr = torch.randn(shape, generator=g, device=dev)
        xi = torch.randn(shape, generator=g, device=dev)
        x64 = torch.complex(xr.double(), xi.double())
        x32 = torch.complex(xr, xi)
        for axis in (0, 1):
            for sign in (-1, 1):
                inv = sign > 0
                kr, ki = k.dft_c2c_axis_cuda(xr, xi, axis, sign, inv)
                pr, pi = k.dft_c2c_axis_plain(xr, xi, axis, sign, inv)
                ref = (torch.fft.fft(x64, dim=axis) if sign < 0
                       else torch.fft.ifft(x64, dim=axis))
                got = torch.complex(kr, ki)
                e_ref = complex_err(got, ref)
                e_twin = complex_err(got, torch.complex(pr, pi))
                del kr, ki, pr, pi, ref, got
                what = f"K10 {shape} axis {axis} sign {sign:+d}"
                check(e_ref <= K10_BOUND and e_twin <= K10_BOUND,
                      f"{what}: {e_ref} vs torch.fft, {e_twin} vs twin")
                if sign > 0:
                    log(f"{what}: {e_ref:.2e} of max|y| vs complex128 "
                        f"torch.fft, {e_twin:.2e} vs twin")
                    continue
                ms = median_ms(lambda: k.dft_c2c_axis_cuda(xr, xi, axis, -1))
                plain_ms = median_ms(
                    lambda: k.dft_c2c_axis_plain(xr, xi, axis, -1))
                library_ms = median_ms(lambda: torch.fft.fft(x32, dim=axis))
                # 16 bytes per complex element moved; an FFT's 5 log2(C)
                # operations per element, whatever computes it
                bound = roofline(16 * xr.numel(),
                                 5 * np.log2(shape[axis]) * xr.numel())
                log(f"{what}: {e_ref:.2e} of max|y| vs complex128 torch.fft, "
                    f"{e_twin:.2e} vs twin; kernel {ms:.4f} ms, plain "
                    f"{plain_ms:.4f}, torch.fft.fft {library_ms:.4f}, bound "
                    f"{bound['bound_ms']:.4f} ({bound['bound_by']}; the "
                    f"kernel at {bound['bound_ms'] / ms:.0%} of it); kernel "
                    f"<= torch.fft.fft: {ms <= library_ms}")
                if N == N_MAIN and axis == 1:
                    row = dict(name=K10, max_abs_err=e_ref, ms=ms,
                               plain_ms=plain_ms, library_ms=library_ms,
                               **bound)
        del xr, xi, x64, x32
    return row


def phase_route(dev, cosmo, grid, draws, cpu) -> int:
    """The pipeline on the K10 route; returns K10's launches over the
    counted realisations (3 at 256^3, 2 at 512^3)."""
    from fastbox_tpu_torch.grid import GridSpec
    from fastbox_tpu_torch.ops import mmfft
    from fastbox_tpu_torch.ops.cuda import _build
    from fastbox_tpu_torch.pipeline import PipelineConfig, make_pipeline

    fn_dbg = make_pipeline(grid, cosmo, PipelineConfig(debug_stages=True),
                           device=dev)
    fn256 = make_pipeline(grid, cosmo, PipelineConfig(), device=dev)
    grid512 = GridSpec.create(box_scale=BOX, nsamp=N_BIG, redshift=Z)
    fn512 = make_pipeline(grid512, cosmo, PipelineConfig(), device=dev)
    fft_run = fn_dbg(draws=draws)
    gen = torch.Generator(device=dev).manual_seed(2028)
    for N in (N_MAIN, N_BIG):
        s = (N, N, N)
        x = torch.randn(s, generator=gen, device=dev)
        a = torch.fft.rfftn(x)
        log(f"{N}^3 cube transforms, ms: route rfftn3 "
            f"{median_ms(lambda: mmfft.rfftn3(x)):.3f} vs torch.fft.rfftn "
            f"{median_ms(lambda: torch.fft.rfftn(x)):.3f}; route irfftn3 "
            f"{median_ms(lambda: mmfft.irfftn3(a, s)):.3f} vs "
            f"torch.fft.irfftn {median_ms(lambda: torch.fft.irfftn(a, s=s)):.3f}")
        del x, a
    runs = [(f"route 256^3 realisation {i}", fn256, grid) for i in range(3)]
    runs += [(f"route 512^3 realisation {i}", fn512, grid512)
             for i in range(2)]
    launches = 0
    mmfft.PALLAS_DFT = True
    try:
        walls = {}
        for label, fn, g in runs:
            _build.reset_launch_counts()
            walls[label] = run_pipeline(fn, dev, label, g,
                                        generator=gen)["wall"]
            n = _build.launch_counts().get(K10, 0)
            check(n == K10_PER_PIPELINE,
                  f"{label}: K10 launched {n} times, not {K10_PER_PIPELINE}")
            launches += n
        _build.reset_launch_counts()
        route = fn_dbg(draws=draws)
        n = _build.launch_counts().get(K10, 0)
        check(n == K10_PER_PIPELINE, f"route truth run: K10 launched {n}")
    finally:
        mmfft.PALLAS_DFT = False
    log(f"route: K10 launched {K10_PER_PIPELINE} times per realisation; "
        f"256^3 {statistics.median(walls[r[0]] for r in runs[1:3]) * 1e3:.2f}"
        f" ms (median of realisations 1-2), 512^3 "
        f"{walls[runs[4][0]] * 1e3:.2f} ms (realisation 1)")
    for stage in ("delta_x", "vel_z"):
        e = norm_err(route[stage], fft_run[stage])
        log(f"route {stage} vs the cuFFT run, same draws: {e:.2e} of max")
        check(e <= K10_BOUND, f"route {stage}: {e}")
    full = populated_bins(grid, dev)
    for name, bound in TRUTH_BOUND.items():
        g = route[name].double().cpu().numpy()[full]
        c = cpu[name].numpy()[full]
        rel = np.abs(g - c) / np.abs(c)
        f = fft_run[name].double().cpu().numpy()[full]
        log(f"route truth {name} per-bin rel err vs f64 CPU: "
            + " ".join(f"{v:.2e}" for v in rel)
            + f" (max {rel.max():.2e}; the cuFFT run's max "
            f"{(np.abs(f - c) / np.abs(c)).max():.2e})")
        check(bool(np.all(rel <= bound)), f"route truth {name}: {rel.max()}")
    return launches


def phase_cola_route(dev, grid, cosmo0, white, d_fft) -> int:
    """COLA at 256^3 on the K10 route, on the white noise of the cuFFT
    realisation ``d_fft``; returns K10's launches."""
    from fastbox_tpu_torch.fields.cola import ColaEngine
    from fastbox_tpu_torch.ops import mmfft
    from fastbox_tpu_torch.ops.cuda import _build
    from fastbox_tpu_torch.ops.spectra import binned_power_spectrum

    n_steps = ColaEngine(grid, cosmo0, redshift_init=COLA_Z_INIT,
                         device=dev).n_steps
    # cube transforms per realisation (spectral gradient, fields/lpt.py and
    # fields/cola.py): 2LPT 3 + 6 + 1 + 3, per force evaluation 1 R2C + 3
    # C2R, the finish 1 R2C + 1 C2R; K10 runs each on axes 0 and 1
    expect = 2 * (13 + 4 * n_steps + 2)
    mmfft.PALLAS_DFT = True
    try:
        _build.reset_launch_counts()
        (d, _, _), wall = run_cola("COLA 256^3 on the K10 route", grid,
                                   cosmo0, dev, keep_velocities=False,
                                   white=white)
        n = _build.launch_counts().get(K10, 0)
    finally:
        mmfft.PALLAS_DFT = False
    log(f"COLA route: K10 launched {n} times ({n_steps} steps; expected "
        f"{expect}); {wall * 1e3:.1f} ms")
    check(n == expect, f"COLA route: K10 launched {n}, not {expect}")
    cola_health(grid, cosmo0, d, "COLA 256^3 route")
    s_r, s_f = d.double().std().item(), d_fft.double().std().item()
    kc, pk_r, _ = binned_power_spectrum(grid, delta_x=d)
    _, pk_f, _ = binned_power_spectrum(grid, delta_x=d_fft)
    kc, pk_r, pk_f = (t.cpu().numpy() for t in (kc, pk_r, pk_f))
    sel = np.isfinite(pk_f)
    rel = np.abs(pk_r[sel] / pk_f[sel] - 1)
    log(f"COLA route vs cuFFT, same white noise: std(delta) {s_r:.6f} vs "
        f"{s_f:.6f}; largest per-bin P(k) difference {rel.max():.2e} "
        f"(k < k_Nyq/2: "
        f"{rel[kc[sel] < 0.5 * np.pi * grid.N / grid.Lx].max():.2e})")
    return n


def run_gate(dev, grid, keys, variants=None, label: str = "gate") -> tuple:
    """make_truth on the CPU, then check_truth on the card, with launch
    counters reset around the check; returns (truth, summary, spectra,
    counts)."""
    from fastbox_tpu_torch import truth_gate as tg
    from fastbox_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    truth = tg.make_truth(grid, keys, log=log)
    log(f"{label}: truth phase ({len(keys)} keys, CPU f64 and f32) "
        f"{time.perf_counter() - t0:.1f} s")
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    summary, spectra = tg.check_truth(truth, variants, dev, log=log)
    counts = _build.launch_counts()
    log(f"{label}: check phase {time.perf_counter() - t0:.1f} s; launch "
        f"counts {json.dumps(counts)}")
    log(f"{label}: summary {json.dumps(summary)}")
    floor = tg._rel(truth["f32_pk_cleaned"], truth["pk_cleaned"]).max(axis=0)
    log(f"{label}: CPU f32 floor per bin, pk_cleaned: "
        + " ".join(f"{v:.2e}" for v in floor))
    for name, sp in spectra.items():
        rel = tg._rel(sp["pk_cleaned"], truth["pk_cleaned"]).max(axis=0)
        log(f"{label}: {name} per bin, pk_cleaned: "
            + " ".join(f"{v:.2e}" for v in rel))
    return truth, summary, spectra, counts


def phase_gate(dev) -> int:
    """Phase 10: the truth gate at scripts/truth_gate.py's defaults; every
    variant that runs on the card against the f64 oracle.  Returns K4t's
    launches (the pk_v2t variant)."""
    from fastbox_tpu_torch import truth_gate as tg
    from fastbox_tpu_torch.grid import GridSpec
    from fastbox_tpu_torch.ops.cuda.mmdft import supported_length

    grid = GridSpec.create(box_scale=GATE_BOX, nsamp=GATE_N, redshift=Z)
    _, summary, spectra, counts = run_gate(dev, grid, GATE_KEYS,
                                           label=f"gate {GATE_N}^3")
    ran = {n for n, v in summary["variants"].items() if "skipped" not in v}
    # bm_draw needs a box-Muller truth; pallas_dft an axis K10 takes
    want = set(tg.VARIANTS) - {"bm_draw"}
    if not supported_length(GATE_N):
        want.discard("pallas_dft")
    check(ran == want, f"gate: ran {sorted(ran)}, expected {sorted(want)}")
    for name in ran:
        v = summary["variants"][name]
        check(v["pk_density_max"] <= TRUTH_BOUND["pk_density"],
              f"gate {name}: pk_density {v['pk_density_max']}")
        # the subspace clean is another estimator: reported, not bounded
        if name != "pca_subspace":
            check(v["pk_cleaned_max"] <= TRUTH_BOUND["pk_cleaned"],
                  f"gate {name}: pk_cleaned {v['pk_cleaned_max']}")
    for name in ("pk_cleaned", "pk_density"):
        a, b = spectra["pk_v2t"][name], spectra["native_highest"][name]
        ok = np.isfinite(b) & (b != 0)
        rel = float(np.max(np.abs(a[ok] - b[ok]) / np.abs(b[ok])))
        log(f"gate: pk_v2t vs native_highest, {name}: largest per-bin rel "
            f"diff {rel:.3e}")
        check(rel <= V2T_BOUND, f"gate pk_v2t vs native_highest {name}")
    n = counts.get(K4T, 0)
    check(n == len(GATE_KEYS), f"gate: K4t launched {n} times")
    check(counts.get(K10, 0) == (K10_PER_PIPELINE * len(GATE_KEYS)
                                 if "pallas_dft" in ran else 0),
          f"gate: K10 launched {counts.get(K10, 0)} times")
    return n


def per_seed(truth, got, keep) -> tuple:
    """Per key: the largest pk_cleaned error of ``got`` and of the CPU f32
    floor against the f64 oracle over the bins ``keep``."""
    from fastbox_tpu_torch import truth_gate as tg

    t = truth["pk_cleaned"]
    card = tg._rel(got, t)[:, keep].max(axis=1)
    floor = tg._rel(truth["f32_pk_cleaned"], t)[:, keep].max(axis=1)
    return card, floor


def step_truth(dev, grid, cosmo, cosmo_cpu) -> None:
    """The sharded step (one-rank mesh, B = 8) and the single pipeline in
    noise_scheme='rows' on the card, each against the port in f64 on the
    CPU on the same rows (the step's own f32 row draws, cast up), beside
    the CPU f32 run on the same rows."""
    import dataclasses
    import tempfile

    import torch.distributed as dist

    from fastbox_tpu_torch import truth_gate as tg
    from fastbox_tpu_torch.ops.cuda import _build
    from fastbox_tpu_torch.parallel import (make_mesh,
                                            make_sharded_ensemble_step, rng)
    from fastbox_tpu_torch.parallel.mesh import init_single_rank
    from fastbox_tpu_torch.pipeline import (ROWS_DRAW_NAMES, PipelineConfig,
                                            make_pipeline)

    _build.BUILD_ROOT.parent.mkdir(parents=True, exist_ok=True)
    init_single_rank(dev, tempfile.mkdtemp(prefix="pg_",
                                           dir=_build.BUILD_ROOT.parent))
    cfg = PipelineConfig(noise_scheme="rows")
    seeds = list(GATE256_KEYS)
    step = make_sharded_ensemble_step(make_mesh(device=dev), grid, cosmo, cfg,
                                      dev)
    got = step(seeds=seeds)
    dist.destroy_process_group()
    single = make_pipeline(grid, cosmo, cfg, device=dev)
    cpu64 = make_pipeline(grid, cosmo_cpu, dataclasses.replace(
        cfg, dtype="float64"), device="cpu")
    cpu32 = make_pipeline(grid, cosmo_cpu, cfg, device="cpu")
    res = {k: [] for k in ("t", "f", "step", "single")}
    t0 = time.perf_counter()
    for s in seeds:
        rows = {k: v.cpu() for k, v in rng.row_draws(
            s, ROWS_DRAW_NAMES, grid.N, device=dev).items()}
        res["t"].append(cpu64(draws=rows)["pk_cleaned"].numpy())
        res["f"].append(cpu32(draws=rows)["pk_cleaned"].double().numpy())
        del rows
        res["single"].append(single(seed=s)["pk_cleaned"].double().cpu()
                             .numpy())
    log(f"step truth: the CPU f64 and f32 runs took "
        f"{time.perf_counter() - t0:.1f} s")
    res["step"] = got["pk_cleaned"].double().cpu().numpy()
    t = np.stack(res["t"])
    truth = {"pk_cleaned": t, "f32_pk_cleaned": np.stack(res["f"])}
    keep = populated_bins(grid, dev)
    worst = {}
    for name in ("step", "single"):
        card, floor = per_seed(truth, np.asarray(res[name]), keep)
        rel = tg._rel(np.asarray(res[name]), t).max(axis=0)
        log(f"step truth: {name} per bin, pk_cleaned: "
            + " ".join(f"{v:.2e}" for v in rel))
        log(f"step truth: {name} per seed, largest pk_cleaned error / CPU f32 "
            "floor: " + " ".join(f"{c:.2e}/{f:.2e}" for c, f in
                                 zip(card, floor)))
        worst[name] = (card.max(), floor.max())
        log(f"step truth: {name} worst over seeds {seeds[0]}-{seeds[-1]}: "
            f"{worst[name][0]:.3e}, CPU f32 floor {worst[name][1]:.3e} (ratio "
            f"{worst[name][0] / worst[name][1]:.2f})")
    # the step's f32 clean runs in f64 as the single pipeline's does
    # (ROADMAP C3): its worst stays of the floor's size, the cube's bar
    check(worst["step"][0] <= 1.5 * worst["step"][1],
          f"step truth: worst {worst['step'][0]} above 1.5x the CPU f32 "
          f"floor's {worst['step'][1]}")
    spread = tg._rel(np.asarray(res["step"]), np.asarray(res["single"]))
    log(f"step truth: step vs single, largest per-bin pk_cleaned rel diff "
        f"{spread.max():.3e}")


def bin1_source(dev, grid, cosmo, cosmo_cpu, key: int) -> None:
    """Where the card's pk_cleaned error in the first retained bin of
    realisation ``key`` arises: the f32 data cube (stages 1-7) or the f32
    clean (8-9).  Each f32 half is swapped for the f64 oracle's, on the
    card and on the CPU, and the result held to the oracle."""
    import dataclasses

    from fastbox_tpu_torch import truth_gate as tg
    from fastbox_tpu_torch.pipeline import PipelineConfig, make_pipeline

    draws = tg.gate_draws(grid, key)
    cfg = PipelineConfig()
    f64 = make_pipeline(grid, cosmo_cpu, dataclasses.replace(
        cfg, dtype="float64"), device="cpu")
    card = make_pipeline(grid, cosmo, cfg, device=dev)
    cpu32 = make_pipeline(grid, cosmo_cpu, cfg, device="cpu")
    pre64, pre_g, pre_c = (f.pre(draws=draws) for f in (f64, card, cpu32))
    t = f64.post(pre64)["pk_cleaned"].numpy()
    err_g = norm_err(pre_g["data"].cpu(), pre64["data"])
    log(f"bin-1 source, key {key}: f32 data cube vs f64, max|diff| / "
        f"max|data|: card {err_g:.2e}, "
        f"CPU {norm_err(pre_c['data'], pre64['data']):.2e}")
    runs = {
        "card, f32 data and clean": lambda: card.post(pre_g),
        "CPU, f32 data and clean": lambda: cpu32.post(pre_c),
        "f64 clean of the card's f32 data": lambda: f64.post(
            {**pre64, "data": pre_g["data"].double().cpu()}),
        "f64 clean of the CPU's f32 data": lambda: f64.post(
            {**pre64, "data": pre_c["data"].double()}),
        "card f32 clean of the f64 data": lambda: card.post(
            {**pre_g, "data": pre64["data"].float().to(dev)}),
        "CPU f32 clean of the f64 data": lambda: cpu32.post(
            {**pre_c, "data": pre64["data"].float()}),
    }
    for label, run in runs.items():
        got = run()["pk_cleaned"].double().cpu().numpy()
        signed = (got[0] - t[0]) / abs(t[0])
        log(f"bin-1 source, key {key}, {label}: bin 1 {signed:+.2e}, bins "
            f"2-5 largest {tg._rel(got, t)[1:5].max():.2e}")


def truth_256(dev) -> None:
    """``--truth-256``: the gate at the bench size, the anisotropic box,
    and the step against the single rows-mode pipeline.  Fails if a
    pk_density or a finite result is off, or if the cube's bin-1 worst or
    the step's worst over the keys exceeds 1.5x the CPU f32 floor's, or
    the anisotropic box's worst exceeds 3x its floor's."""
    from fastbox_tpu_torch import truth_gate as tg
    from fastbox_tpu_torch.cosmology import build_cosmology
    from fastbox_tpu_torch.grid import GridSpec

    cube = GridSpec.create(box_scale=BOX, nsamp=N_MAIN, redshift=Z)
    truth, summary, spectra, _ = run_gate(dev, cube, GATE256_KEYS,
                                          label=f"gate {N_MAIN}^3 cube")
    for name, v in summary["variants"].items():
        if "skipped" not in v:
            check(v["pk_density_max"] <= TRUTH_BOUND["pk_density"],
                  f"gate 256^3 {name}: pk_density {v['pk_density_max']}")
    # the first retained bin, signed, per key: card and CPU f32 floor
    t = truth["pk_cleaned"][:, 0]
    card = (spectra["native_highest"]["pk_cleaned"][:, 0] - t) / np.abs(t)
    floor = (truth["f32_pk_cleaned"][:, 0] - t) / np.abs(t)
    log("gate 256^3 cube, bin 1 signed error per key, card / CPU f32: "
        + " ".join(f"{c:+.2e}/{f:+.2e}" for c, f in zip(card, floor)))
    worst_card, worst_floor = np.abs(card).max(), np.abs(floor).max()
    log(f"gate 256^3 cube, bin 1 worst over keys {GATE256_KEYS[0]}-"
        f"{GATE256_KEYS[-1]}: card {worst_card:.3e}, CPU f32 floor "
        f"{worst_floor:.3e} (ratio {worst_card / worst_floor:.2f}); mean "
        f"signed card {card.mean():+.2e}, CPU f32 {floor.mean():+.2e}")
    # the card's f32 clean runs in f64 as the CPU's does (filters/pca.py):
    # its bin-1 worst stays of the floor's size
    check(worst_card <= 1.5 * worst_floor,
          f"gate 256^3 cube: bin 1 worst {worst_card} above 1.5x the CPU f32 "
          f"floor's {worst_floor}")
    cosmo = build_cosmology(COSMO, redshift=Z, device=dev)
    cosmo_cpu = build_cosmology(COSMO, redshift=Z)
    bin1_source(dev, cube, cosmo, cosmo_cpu,
                int(truth["keys"][np.argmax(np.abs(card))]))
    ga = GridSpec.create(box_scale=ANISO_BOX, nsamp=N_MAIN, redshift=Z)
    truth, _, spectra, _ = run_gate(dev, ga, GATE256_KEYS, ["native_highest"],
                                    label=f"gate {N_MAIN}^3 anisotropic")
    full = populated_bins(ga, dev)
    _, moved = moved_modes(ga, dev)
    keep = full & ~moved
    card, floor = per_seed(truth, spectra["native_highest"]["pk_cleaned"],
                           keep)
    log("anisotropic gate, bins of unchanged membership, per seed: card "
        "largest pk_cleaned error / CPU f32 floor = ratio: "
        + " ".join(f"{c:.2e}/{f:.2e}={c / f:.2f}" for c, f in
                   zip(card, floor)))
    check(bool(np.all(np.isfinite(card))), "anisotropic gate: not finite")
    # the anisotropic box's criterion: the card's worst pk_cleaned error over
    # the keys, bins of unchanged membership, within 3x the CPU f32 floor's
    # worst
    t = truth["pk_cleaned"]
    card_bin = tg._rel(spectra["native_highest"]["pk_cleaned"], t)[:, keep] \
        .max(axis=0)
    floor_bin = tg._rel(truth["f32_pk_cleaned"], t)[:, keep].max(axis=0)
    log("anisotropic gate, worst over the keys per bin of unchanged "
        "membership, card / 3 x CPU f32 floor: "
        + " ".join(f"{c:.2e}/{3 * f:.2e}" for c, f in zip(card_bin,
                                                           floor_bin)))
    aniso_ok = card_bin.max() <= 3.0 * floor_bin.max()
    log(f"anisotropic criterion: card worst {card_bin.max():.3e}, 3 x the CPU "
        f"f32 floor's worst {3.0 * floor_bin.max():.3e}: "
        f"{'holds' if aniso_ok else 'FAILS'}")
    step_truth(dev, cube, cosmo, cosmo_cpu)
    check(aniso_ok, f"anisotropic gate: card worst {card_bin.max()} above 3x "
          f"the CPU f32 floor's {floor_bin.max()}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check needs an NVIDIA GPU")
    from fastbox_tpu_torch.cosmology import build_cosmology
    from fastbox_tpu_torch.grid import GridSpec
    from fastbox_tpu_torch.ops import mmfft
    from fastbox_tpu_torch.ops.cuda import _build
    from fastbox_tpu_torch.pipeline import (PipelineConfig, draw_inputs,
                                            make_pipeline)

    check("jax" not in sys.modules, "jax was imported")
    mmfft.PALLAS_DFT = False    # phase 9 turns the K10 route on
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
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                log("  " + line.strip())

    if "--step-1024" in sys.argv[1:]:
        explore_1024(dev)
        return
    if "--truth-256" in sys.argv[1:]:
        truth_256(dev)
        return
    grid = GridSpec.create(box_scale=BOX, nsamp=256, redshift=Z)
    cosmo = build_cosmology(COSMO, redshift=Z, device=dev)
    kernels = [phase_k1(dev), phase_k2(dev, cosmo),
               phase_k3(dev, grid, cosmo), phase_k4(dev, grid)]
    k4t = phase_k4t(dev, grid)
    k11 = phase_k11(dev)
    others = [phase_k5(dev), phase_k6(dev)] + phase_k9(dev)
    k7 = phase_k7(dev, cosmo)
    k10 = phase_k10(dev)
    for r in kernels + [k4t] + k11 + others + [k7, k10]:
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
    check_route_off(counts, "the main path")
    for r in kernels:
        r["launches"] = counts.get(r["name"], 0)
        check(r["launches"] > 0, f"{r['name']} never launched on the main path")
    steady = statistics.median(r["wall"] for r in runs256[1:])
    log("pca stage ms (the f32 cube cleaned in f64: mean, covariance, eigh, "
        "projection): 256^3 " + " ".join(f"{r['stages']['pca']:.3f}"
                                         for r in runs256)
        + "; 512^3 " + " ".join(f"{r['stages']['pca']:.3f}" for r in run512))
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
    cpu = make_pipeline(grid, cosmo_cpu, PipelineConfig(dtype="float64"),
                        device="cpu")(draws=draws)
    log(f"truth: f64 CPU reference took {time.perf_counter() - t0:.1f} s")
    full = populated_bins(grid, dev)
    for name, bound in TRUTH_BOUND.items():
        g = gpu[name].double().cpu().numpy()[full]
        c = cpu[name].numpy()[full]
        rel = np.abs(g - c) / np.abs(c)
        log(f"truth {name} per-bin rel err: "
            + " ".join(f"{v:.2e}" for v in rel))
        check(bool(np.all(rel <= bound)), f"truth {name}: max {rel.max()}")

    launches = phase_paths(dev, cosmo, grid, fn256)
    for r in others:
        r["launches"] = launches[r["name"]]
    truth_aniso(dev, cosmo_cpu, cosmo)

    k8, launches = phase_sharded(dev, cosmo, grid, fn256)
    for r in [k7, k4t] + k8:
        r["launches"] = launches[r["name"]]
    cola = phase_cola(dev, k11)

    # The K10 route: the pipeline, then COLA, counted apart
    k10["launches"] = phase_route(dev, cosmo, grid, draws, cpu)
    phase_cola_route(dev, *cola)
    phase_gate(dev)
    kernels += [k4t] + k11 + others + [k7] + k8 + [k10]
    for r in kernels:
        src, rep = KERNELS[r["name"]]
        r.update(route="cuda", source=src, replaces=rep)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
