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
     repeatable; K3 torch.equal to its bracket reference (searchsorted,
     gathers, the kernel's four rounded operations) and within 1e-5 of its
     twin on the 256^3 rows and a sigma_NL 6000 realisation's exact-tier
     rows (the merge walk), f32 and f64, and on rows with duplicate
     nodes, nodes on targets, a narrow hull and clustered nodes, on
     descending, permuted and non-uniform targets, T != C, 62-cell and
     unaligned rows, timed at 256^3 (also the general path) and 512^3;
     K9a/b in supplied mode bitwise on the vector and element paths (f32,
     f64, 256^3, 63^3 and 65^3 half grids), in generated mode the same
     bits on both paths, by the moments and lag-1, lag-C and re/im
     correlations of the normals, timed with a fixed device seed at 256^3
     and 512^3 (and through the generator, which adds draw_seed); K10 (the axis FFT) at
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
     timed on both steps' nodes, K3 on the sigma_NL 6000 step's rows
     torch.equal to its bracket reference and within 1e-5 of its twin,
     timed, the step's remap through K7 (the batched
     remap with unwrapped coordinates, counted), the step against the
     single pipeline in noise_scheme='rows' on the same seeds,
     make_ensemble_pipeline over the mesh against the mesh-less call
     (bitwise), and rsd_method='nearest'; then the pallas_pk='v2t' path:
     the 256^3 pipeline (two realisations, counted: K4t once per
     realisation, K4 never) against the default run on the same draws, and
     one 256^3 B=2 step with 'v2t' on the same mesh, counted;
 7b. still on the one-rank mesh, the estimators (ops/spectra.py,
     ops/nbodykit_compat.py) on a 256^3 realise_density cube in the 4 Gpc
     box at z=0.8, f32: power_spectrum with nmu 1, nmu 5 along z and along
     (1, 1, 1), a cross spectrum, power_multipoles 0-4,
     correlation_function, correlation_multipoles, FFTPower and FFTCorr on
     an ArrayMesh, and ArrayCatalog.to_mesh (TSC, compensated, interlaced)
     of 2^20 uniform particles, each against the port on the CPU in f32 on
     the same cube: modes torch.equal, other values within 1e-4 per
     populated bin (odd P poles and xi poles of l > 0 within 1e-4 of
     max|P_0|, max|xi_0|); the sharded spectra, multipoles
     and correlation factories in f64 against the single-device f64 calls
     on the card (rtol 1e-10, atol 1e-8); make_sharded_pca_filter against
     pca_filter on the 256^3 pipeline's data cube; make_sharded_halo_counts
     bitwise repeatable on one seed with its mean count within 20% of
     nbar V_voxel; then the wall ms (median of 5) and peak device memory of
     power_spectrum (nmu 1 and 5), power_multipoles, correlation_function
     and the sharded power spectrum at 256^3 and 512^3;
  8. the COLA engine (scripts/bench_cola.py's configuration: 256^3 in a
     4 Gpc box, z 15 -> 0 in 16 steps, lattice_B=3, spectral gradient, f32):
     three realisations with the kernels (one with keep_velocities=True and
     per-component gathers), then 512^3 in the same box and in an 8 Gpc box,
     with launch counters reset just before and read just after; then, on
     the same white noise, the engine with the plain twins on the card: the
     first force evaluation per particle, the final field (bitwise equal),
     std(delta) and the binned P(k), and bench_cola.py's health bounds;
 8c. still on the one-rank mesh, the foregrounds and the cleaners: (a)
     the README quickstart at 256^3 in the 4 Gpc box at z=0.8, f32
     (CosmoBox, HI tracer, log-normal, RSD at sigma_NL 120, T_b,
     ForegroundModel, PointSourceModel, NoiseModel), then every cleaner
     of filters/ on the cube (kernel PCA on its 64 x 64-pixel cut) and
     binned_power_spectrum (K6) of each cleaned cube, each step's wall ms
     (median of 3) and peak device memory, launch counters reset just
     before and read just after (K1, K2 and K6 must launch), every output
     finite; (b) the same chain on supplied noise at 64^3 in a 1 Gpc box,
     the card against the CPU in f32 and in f64, every output within its
     bound, the point-source shot maps equal; (c) a 256^3 f32 slab as a
     DTensor through io.save_sharded/load_sharded and the 256^3 box
     through io.save_box/load_box, bitwise, with write and read times;
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
    # K11a and K11c's slab mode: the sharded engine's halo paint and force
    # gather (fastbox_tpu/parallel/lattice.py:48, :119 sum the same terms)
    "cic_paint_lattice_slab": ("fastbox_tpu_torch/csrc/lattice_cic.cu",
                               "fastbox_tpu/ops/pallas/lattice_cic.py:289"),
    "cic_gather3_lattice_slab": ("fastbox_tpu_torch/csrc/lattice_cic.cu",
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
# The estimators (phase 7b): f32 on the card against f32 on the CPU, same
# cube, per populated bin (odd P poles and the xi poles of l > 0 against
# max|P_0|, max|xi_0|: they change sign across bins, where a per-bin
# relative error measures nothing but the crossing); the sharded
# factories in f64 against the single-device f64 call on the card
# (tests/test_parallel_spectra.py's bound); the sharded PCA clean against
# pca_filter, of max|cleaned| (the cleaned cube's f32 rounding).
EST_BOUND = 1e-4
SHARDED_RTOL, SHARDED_ATOL = 1e-10, 1e-8
PCA_SHARDED_BOUND = 1e-6
EST_N_PARTICLES = 2 ** 20
EST_REPS = 5


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


def k3_inputs(dev, cosmo, N: int, seed: int = 3) -> tuple:
    """(ss, vv, z, fill) of the exact RSD tier at the N^3 pipeline's shapes
    (N^2 rows of N cells), nodes displaced by up to 12 cells and sorted."""
    from fastbox_tpu_torch.grid import GridSpec

    grid = GridSpec.create(box_scale=BOX, nsamp=N, redshift=Z)
    vals, vel, z, fill, wrap, inv_hz, _ = rsd_inputs(grid, cosmo, 12.0, dev,
                                                     seed)
    s = torch.remainder(z[None, :] - vel * inv_hz - wrap[0], wrap[1]) + wrap[0]
    del vel
    ss, order = torch.sort(s, dim=1, stable=True)
    del s
    return ss, torch.gather(vals, 1, order), z, fill


def k3_calls(body) -> tuple:
    """(body(), the arguments of every K3 call the RSD remap made in it)."""
    import fastbox_tpu_torch.ops.rsd as rsd

    seen, k3 = [], rsd.interp_sorted

    def keep(*args):
        seen.append(args)
        return k3(*args)

    rsd.interp_sorted = keep
    try:
        return body(), seen
    finally:
        rsd.interp_sorted = k3


def exact_tier_rows(dev, grid, cosmo) -> tuple:
    """The arguments of K3's one call in a 256^3 realisation at sigma_NL
    6000 km/s (the exact tier of the RSD remap), captured on the way."""
    from fastbox_tpu_torch.pipeline import PipelineConfig, make_pipeline

    _, seen = k3_calls(lambda: make_pipeline(
        grid, cosmo, PipelineConfig(sigma_nl=6000.0), device=dev)(
            generator=torch.Generator(device=dev).manual_seed(6000)))
    check(len(seen) == 1, f"sigma_nl=6000: {len(seen)} K3 calls, not 1")
    return seen[0]


def k3_step_rows(args) -> None:
    """K3 on the arguments of its call in the sharded 256^3 B=8 step at
    sigma_NL 6000 (the exact tier's rows of all eight realisations):
    torch.equal to the bracket reference, within 1e-5 of max|value| of the
    twin, and timed (median_ms)."""
    from fastbox_tpu_torch.ops.cuda import rsd_interp as k

    ss, vv, z, fill = args
    staged = k.staged_path(ss.shape[1], z.shape[0], ss, vv)
    got = k.interp_sorted_cuda(*args)
    eq = torch.equal(got, k.interp_sorted_bracket(*args))
    err = norm_err(got, k.interp_sorted_plain(*args))
    ms = median_ms(lambda: k.interp_sorted_cuda(*args))
    bound = roofline(nbytes(ss, vv, z, fill, got), 0)["bound_ms"]
    log(f"K3 on the sharded step's exact tier {tuple(ss.shape)} "
        f"{ss.dtype} ({'staged' if staged else 'direct'}): bitwise {eq} to "
        f"the bracket reference, {err:.3e} of max|value| off the twin; "
        f"{ms:.4f} ms (bound {bound:.4f} ms)")
    check(eq, "K3 on the sharded step's rows: not equal to the bracket "
          "reference")
    check(err <= 1e-5, f"K3 on the sharded step's rows: {err} off the twin")


def k3_times(dev, grid, cosmo, exact: tuple) -> dict:
    """K3's device times (median_ms, f32) through interp_sorted_cuda: the
    256^3 rows displaced by up to 12 cells, the same rows with descending
    targets (the general path), a sigma_NL 6000 realisation's exact-tier
    rows (``exact``), and the 512^3 rows."""
    from fastbox_tpu_torch.ops.cuda import rsd_interp as k

    ss, vv, z, fill = k3_inputs(dev, cosmo, N_MAIN)
    zd = z.flip(0).contiguous()
    t = {f"K3 {N_MAIN}": median_ms(
             lambda: k.interp_sorted_cuda(ss, vv, z, fill)),
         f"K3 {N_MAIN} descending": median_ms(
             lambda: k.interp_sorted_cuda(ss, vv, zd, fill)),
         f"K3 {N_MAIN} sigma_nl 6000": median_ms(
             lambda: k.interp_sorted_cuda(*exact))}
    del ss, vv
    big = k3_inputs(dev, cosmo, N_BIG)
    t[f"K3 {N_BIG}"] = median_ms(lambda: k.interp_sorted_cuda(*big))
    return t


def k3_special_rows(ss, z):
    """Sorted rows with duplicate nodes, nodes exactly on targets, a narrow
    hull (targets outside it on both sides) and 64 nodes clustered inside
    one target interval (past the merge budget), sorted again."""
    ss = ss.clone()
    C = ss.shape[1]
    ss[::3, 10] = ss[::3, 11]
    ss[1::3, 20:24] = ss[1::3, 20:21]
    ss[2::5, 30] = z[31]
    ss[::4, 50] = ss[::4, 51] = z[50]
    ss[::7, 0] = z[0]
    ss[::11, -1] = z[-1]
    lo, hi = z[C // 4], z[3 * C // 4]
    ss[5::13] = lo + (hi - lo) * torch.rand_like(ss[5::13])
    mid = 0.5 * (z[C // 2] + z[C // 2 + 1])
    ss[6::13, 64:128] = mid + (z[1] - z[0]) * 0.4 * torch.rand_like(
        ss[6::13, 64:128])
    return torch.sort(ss, dim=1).values.contiguous()


def phase_k3(dev, grid, cosmo) -> dict:
    """K3 torch.equal to the bracket reference (interp_sorted_bracket:
    searchsorted, gathers and the kernel's four rounded operations) and
    within 1e-5 of max|value| of its twin: on the 256^3 rows displaced by
    up to 12 cells and a sigma_NL 6000 realisation's exact-tier rows (the
    staged path's merge walk), f32 and f64; on rows with duplicate nodes,
    nodes on targets, a narrow hull and clustered nodes; on descending and
    permuted targets (a bisection per target) and non-uniform ascending
    ones; with T != C (100, 512 and 98 targets); on 62-cell and unaligned
    rows (the direct path).  Timed at 256^3
    (also the general path and the realisation's rows) and 512^3."""
    from fastbox_tpu_torch.ops.cuda import rsd_interp as k

    def same(what, ss, vv, z, fill, staged):
        T = z.shape[0]
        check(k.staged_path(ss.shape[1], T, ss, vv) == staged,
              f"K3 {what}: not on the {'staged' if staged else 'direct'} "
              "path")
        got = k.interp_sorted_cuda(ss, vv, z, fill)
        eq = torch.equal(got, k.interp_sorted_bracket(ss, vv, z, fill))
        log(f"K3 {what} {tuple(ss.shape)} -> {tuple(got.shape)} {ss.dtype} "
            f"({'staged' if staged else 'direct'}): bitwise {eq} to the "
            "bracket reference")
        check(eq, f"K3 {what} {ss.dtype}: not equal to the bracket reference")
        return got

    exact = exact_tier_rows(dev, grid, cosmo)
    ss, vv, z, fill = k3_inputs(dev, cosmo, N_MAIN)
    errs = []
    for what, args in (("12-cell displacements", (ss, vv, z, fill)),
                       ("sigma_nl=6000 exact tier", exact)):
        for dt in (torch.float32, torch.float64):
            a = tuple(t.to(dt).contiguous() for t in args)
            got = same(what, *a, True)
            if dt == torch.float32:
                want = k.interp_sorted_plain(*a)
                e = norm_err(got, want)
                log(f"K3 {what}: vs twin {e:.3e} of max|value|")
                check(e <= 1e-5, f"K3 {what}: {e} off the twin")
                errs.append((got - want).abs().max().item())
            del a, got
    rows = slice(0, 8192)
    for dt in (torch.float32, torch.float64):
        zz = z.to(dt)
        sp = (k3_special_rows(ss[rows].to(dt), zz), vv[rows].to(dt)
              .contiguous(), zz, fill[rows].to(dt).contiguous())
        same("duplicates / on nodes / narrow hull / clustered", *sp, True)
        sv, vw, _, fw = sp
        g = torch.Generator(device=dev).manual_seed(31)
        span = zz[-1] - zz[0]
        targets = {
            "descending targets": (zz.flip(0).contiguous(), True),
            "permuted targets": (zz[torch.randperm(zz.shape[0], generator=g,
                                                   device=dev)], True),
            "non-uniform ascending targets":
                (zz[0] - 0.1 * span + 1.2 * span
                 * torch.linspace(0, 1, zz.shape[0], device=dev,
                                  dtype=dt) ** 2, True),
            "100 targets (T != C)": (torch.linspace(
                float(zz[0]) - 50, float(zz[-1]) + 50, 100, device=dev,
                dtype=dt), True),
            "512 targets (T != C)": (torch.linspace(
                float(zz[0]), float(zz[-1]), 512, device=dev, dtype=dt),
                True),
            "98 targets": (torch.linspace(float(zz[0]), float(zz[-1]), 98,
                                          device=dev, dtype=dt), True)}
        for what, (zt, staged) in targets.items():
            same(what, sv, vw, zt.contiguous(), fw, staged)
        short = k3_special_rows(sv[:, :62].contiguous(), zz[:62])
        same("62-cell rows", short, vw[:, :62].contiguous(),
             zz[:62].contiguous(), fw, False)
        same("unaligned rows", unaligned(sv), unaligned(vw), zz, fw, False)
        del sp, sv, vw, fw, short
    t = k3_times(dev, grid, cosmo, exact)
    plain_ms = median_ms(lambda: k.interp_sorted_plain(ss, vv, z, fill))
    bound = roofline(nbytes(ss, vv, z, fill, ss), 0)["bound_ms"]
    log("K3 times (f32): " + ", ".join(f"{n} {v:.4f} ms" for n, v in
                                       t.items())
        + f"; plain 256^3 {plain_ms:.4f} ms; bound 256^3 {bound:.4f} ms")
    # per target: a merge step or two and the interpolation (5 operations)
    return dict(name="interp_sorted", max_abs_err=max(errs),
                ms=t[f"K3 {N_MAIN}"],
                plain_ms=plain_ms, library_ms=None,
                **roofline(nbytes(ss, vv, z, fill, ss), ss.numel() * 8))


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


def k9_times(dev) -> dict:
    """K9's device times (median_ms) through colored_half_draw[_vz]_cuda
    with a fixed device seed, the kernel alone: K9a and K9b on the 256^3
    and 512^3 half grids in f32 and on the 256^3 one in f64; and at 256^3
    the generator form (colored_half_draw[_vz](amp, generator=...)), which
    also launches draw_seed."""
    from fastbox_tpu_torch.grid import GridSpec
    from fastbox_tpu_torch.ops.cuda import half_draw as k
    from fastbox_tpu_torch.pipeline import vz_vectors

    seed = torch.tensor([2026], dtype=torch.int64, device=dev)
    g = torch.Generator(device=dev).manual_seed(9)
    t = {}
    for N in (N_MAIN, N_BIG):
        grid = GridSpec.create(box_scale=BOX, nsamp=N, redshift=Z)
        amp = torch.rand((N, N * (N // 2 + 1)), generator=g, device=dev) * 5
        dts = (torch.float32, torch.float64) if N == N_MAIN else (
            torch.float32,)
        for dt in dts:
            a = amp.to(dt)
            vecs = vz_vectors(grid, 80.0, dt, dev)
            tag = f" {N}" + (" f64" if dt == torch.float64 else "")
            t["K9a" + tag] = median_ms(
                lambda: k.colored_half_draw_cuda(a, seed=seed))
            t["K9b" + tag] = median_ms(
                lambda: k.colored_half_draw_vz_cuda(a, *vecs, seed=seed))
            if N == N_MAIN and dt == torch.float32:
                gen = torch.Generator(device=dev).manual_seed(10)
                t[f"K9a {N} with draw_seed"] = median_ms(
                    lambda: k.colored_half_draw(a, generator=gen))
                t[f"K9b {N} with draw_seed"] = median_ms(
                    lambda: k.colored_half_draw_vz(a, *vecs, generator=gen))
            del a, vecs
        del amp
    return t


def phase_k9(dev) -> list[dict]:
    """K9a/K9b on the 256^3 half grid: supplied mode bitwise against the
    twins (f32 and f64) on the vector path and on an unaligned copy (the
    element path), and on the 63^3 (vector) and 65^3 (C odd: element)
    half grids; generated mode: the element path's bits equal the vector
    path's, a mode's normals depend only on its row and column (65^3
    against the first columns of a wider draw), K9a and K9b the same delta
    for one seed, other bits for another, the interior normals' moments and
    lag-1, lag-C and real/imaginary correlations within 5 sigma, and one
    delta_k for 'on' and 'vz' from one generator seed.  Timed by
    k9_times."""
    from fastbox_tpu_torch.fields import gaussian
    from fastbox_tpu_torch.grid import GridSpec
    from fastbox_tpu_torch.ops.cuda import half_draw as k
    from fastbox_tpu_torch.pipeline import vz_vectors

    def half(n):
        return GridSpec.create(box_scale=BOX, nsamp=n, redshift=Z), n // 2 + 1

    g = torch.Generator(device=dev).manual_seed(9)
    errs = {"colored_half_draw": 0.0, "colored_half_draw_vz": 0.0}
    for n, dt in ((N_MAIN, torch.float32), (N_MAIN, torch.float64),
                  (63, torch.float32), (63, torch.float64),
                  (65, torch.float32), (65, torch.float64)):
        grid, H = half(n)
        amp = torch.rand((n, n * H), generator=g, device=dev, dtype=dt) * 5
        white = torch.complex(torch.randn((n, n * H), generator=g, device=dev,
                                          dtype=dt),
                              torch.randn((n, n * H), generator=g, device=dev,
                                          dtype=dt)) * float(np.sqrt(0.5))
        vecs = vz_vectors(grid, 80.0, dt, dev)
        cases = [(amp, n * H % 4 == 0)]
        if n == N_MAIN:
            cases.append((unaligned(amp), False))
        for am, vec in cases:
            path = "vector" if vec else "element"
            check(k.vector_path(n * H, am, white, *vecs[1:]) == vec,
                  f"K9 {n}^3 {dt}: not on the {path} path")
            pairs = {"colored_half_draw": [(
                k.colored_half_draw_cuda(am, white=white),
                k.colored_half_draw_plain(am, white=white))],
                "colored_half_draw_vz": list(zip(
                    k.colored_half_draw_vz_cuda(am, *vecs, white=white),
                    k.colored_half_draw_vz_plain(am, *vecs, white=white)))}
            for name, ps in pairs.items():
                errs[name] = max([errs[name]] + [(a - b).abs().max().item()
                                                 for a, b in ps])
            same_a, same_b = (all(torch.equal(a, b) for a, b in ps)
                              for ps in pairs.values())
            log(f"K9 supplied mode {n}^3 half grid {dt} ({path} path): K9a "
                f"bitwise {same_a}, K9b bitwise {same_b}")
            check(same_a and same_b,
                  f"K9 supplied mode {n}^3 {dt} {path}: differs from twin")
        del amp, white, vecs, cases
    N = N_MAIN
    grid, H = half(N)
    vecs = vz_vectors(grid, 80.0, torch.float32, dev)
    one = torch.ones((N, N * H), device=dev)
    s1 = torch.tensor([12345], dtype=torch.int64, device=dev)
    s2 = torch.tensor([12346], dtype=torch.int64, device=dev)
    a = k.colored_half_draw_cuda(one, seed=s1)
    b, bvz = k.colored_half_draw_vz_cuda(one, *vecs, seed=s1)
    check(torch.equal(a, b), "K9a and K9b: same seed, different normals")
    check(torch.equal(a, k.colored_half_draw_cuda(one, seed=s1)),
          "K9: same seed, different bits")
    check(not torch.equal(a, k.colored_half_draw_cuda(one, seed=s2)),
          "K9: different seeds, same bits")
    ea = k.colored_half_draw_cuda(unaligned(one), seed=s1)
    eb, evz = k.colored_half_draw_vz_cuda(unaligned(one), *vecs, seed=s1)
    check(torch.equal(a, ea) and torch.equal(b, eb) and torch.equal(bvz, evz),
          "K9: the element path drew other bits than the vector path")
    r65, c65 = 65, 65 * 33
    odd = k.colored_half_draw_cuda(one[:r65, :c65].contiguous(), seed=s1)
    check(not k.vector_path(c65, odd) and torch.equal(odd, a[:r65, :c65]),
          "K9 at 65^3 (element path): not the wider draw's bits")
    log("K9 generated: the element path (unaligned, and 65^3 with C odd) "
        "draws the vector path's bits")
    x = (torch.view_as_real(a.reshape(N, N, H)[:, :, 1:H - 1]).double()
         / np.sqrt(0.5)).reshape(-1)
    m = x.numel()
    mean = x.mean().item()
    var = x.var(correction=0).item()
    kurt = (x ** 4).mean().item() / var ** 2
    check(abs(mean) < 5 / m ** 0.5, f"K9 mean {mean}")
    check(abs(var - 1) < 5 * (2 / m) ** 0.5, f"K9 variance {var}")
    check(abs(kurt - 3) < 5 * (96 / m) ** 0.5, f"K9 kurtosis {kurt}")
    # correlations of the (R, C) real parts with the next column (lag 1)
    # and the next row (lag C), and of each real part with its imaginary one
    re = a.real.double() / np.sqrt(0.5)
    im = a.imag.double() / np.sqrt(0.5)
    corr = {"lag-1": (re[:, :-1] * re[:, 1:]).mean().item(),
            "lag-C": (re[:-1] * re[1:]).mean().item(),
            "re/im": (re * im).mean().item()}
    sizes = {"lag-1": N * (N * H - 1), "lag-C": (N - 1) * N * H,
             "re/im": N * N * H}
    for what, r in corr.items():
        check(abs(r) < 5 / sizes[what] ** 0.5, f"K9 {what} correlation {r}")
    log(f"K9 generated: interior normals mean {mean:.3e} var {var:.6f} "
        f"kurtosis {kurt:.5f} (n={m}); correlations "
        + ", ".join(f"{w} {r:.3e}" for w, r in corr.items()))
    del a, b, bvz, ea, eb, evz, re, im, x
    amp3 = (torch.rand((N, N * H), generator=g, device=dev) * 5) \
        .reshape(N, N, H)
    d_on = gaussian.colored_half_noise(
        torch.Generator(device=dev).manual_seed(3), grid, amp3)
    d_vz, _ = gaussian.colored_half_noise_vz(
        torch.Generator(device=dev).manual_seed(3), grid, amp3, *vecs)
    check(torch.equal(d_on, d_vz), "'on' and 'vz' give different delta_k")
    log("K9 'on' and 'vz' from one generator seed: identical delta_k")
    t = k9_times(dev)
    log("K9 times: " + ", ".join(f"{n} {v:.4f} ms" for n, v in t.items()))
    amp = amp3.reshape(N, N * H)
    gen = torch.Generator(device=dev).manual_seed(10)
    out = []
    for name, key, plain in (
            ("colored_half_draw", f"K9a {N}",
             lambda: k.colored_half_draw_plain(amp, generator=gen)),
            ("colored_half_draw_vz", f"K9b {N}",
             lambda: k.colored_half_draw_vz_plain(amp, *vecs,
                                                  generator=gen))):
        # reads amp (and the three vz vectors), writes delta_k (and vz_k);
        # per mode two normals (~40 for Philox and Box-Muller) and the
        # colouring (2, and ~8 more for the vz weight)
        vz = name.endswith("_vz")
        n_bytes = nbytes(amp) + (2 if vz else 1) * 2 * nbytes(amp) \
            + (nbytes(*vecs) if vz else 0)
        out.append(dict(name=name, max_abs_err=errs[name], ms=t[key],
                        plain_ms=median_ms(plain), library_ms=None,
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


# ----------------------------------------------------------------------
# Phase 8b: the slab-sharded COLA engine and the CosmoBox surface
# ----------------------------------------------------------------------
PAINT_SLAB, GATHER3_SLAB = ("cic_paint_lattice_slab",
                            "cic_gather3_lattice_slab")
SLAB_N = (256, 512)      # make_sharded_cola's cells: 4 and 8 Gpc boxes
SLAB_ROWS = 64           # the four-slab cut of the 256^3 cube
# Four slabs' buffers with their strips added to the neighbours against
# the periodic paint: the same terms, the strips' sums in another order.
SLAB_FOLD_BOUND = {torch.float32: K11_TWIN_BOUND, torch.float64: 1e-12}
# The sharded engine's large-scale growth (tests/test_parallel_cola.py)
SHARDED_GROWTH = (0.5, 1.4)
# The card in f64 against the CPU in f64, of max|delta|: FFT rounding only
SHARDED_F64_BOUND = 1e-9
# CosmoBox, f32 on the card against f32 on the CPU on the same noise:
# fields of max|value| (FFT rounding), P(k) per populated bin; the RSD
# remap bitwise on the same inputs (K1, K2 equal their twins); COLA's 16
# steps amplify f32 rounding of the two devices' FFTs, so its P(k) is held
# per populated bin.
BOX_FIELD_BOUND, BOX_PK_BOUND = 1e-5, 1e-4
BOX_COLA_PK_BOUND = 1e-3
BOX_COLA_N = 128         # in a 2 Gpc box: the 15.6 Mpc cells of phase 8
# The radiometer noise: the pooled std of noise / sigma within 1%, each
# channel's within five standard errors of a std from N^2 draws
NOISE_POOLED_BOUND, NOISE_CHANNEL_SIGMAS = 1e-2, 5.0
HALO_MEAN_BOUND = 0.2


def capture_slab_inputs(fn) -> tuple:
    """Run ``fn`` (a make_sharded_cola call) with the engine's force gather
    wrapped: the last force evaluation's force meshes and displacements,
    (meshes, d) as three (N, N, N) tensors each on a one-rank mesh."""
    import fastbox_tpu_torch.parallel.cola as pc

    seen, inner = {}, pc.halo_gather_many

    def capture(meshes, disp, B, group):
        seen["last"] = (tuple(m.clone() for m in meshes),
                        tuple(a.clone() for a in disp))
        return inner(meshes, disp, B, group)

    pc.halo_gather_many = capture
    try:
        out = fn()
    finally:
        pc.halo_gather_many = inner
    return out, seen["last"]


def slab_kernels(dev, meshes, d) -> list[dict]:
    """(a) K11a/K11c's slab mode against the slab twins, bitwise and
    repeatable, f32 and f64, B = 1, 2, 3, on the 256^3 sharded engine's own
    displacements and force meshes cut into one slab of 256 rows and four
    of 64; the four slabs' paints, each strip added to its neighbour,
    against the periodic closed-band paint, and their gathers against the
    periodic gathers' rows (bitwise).  Times at B = 3 on one slab beside
    the periodic mode, index_add_ (paint) and grid_sample (gather)."""
    from fastbox_tpu_torch.ops.cuda import lattice_cic as k

    N = d[0].shape[0]
    for dt in (torch.float32, torch.float64):
        dd = tuple(a.to(dt).contiguous() for a in d)
        mm = tuple(m.to(dt).contiguous() for m in meshes)
        for B in (1, 2, 3):
            H = B + 1
            periodic = k.cic_paint_lattice_cuda(dd, B, None, openband=False)
            periodic3 = k.cic_gather3_lattice_cuda(mm, dd, B, openband=False)
            for nslab in (1, N // SLAB_ROWS):
                S = N // nslab
                full = torch.zeros_like(periodic)
                for j in range(nslab):
                    ds = tuple(a[j * S:(j + 1) * S] for a in dd)
                    rows = torch.arange(j * S - H, (j + 1) * S + H,
                                        device=dev) % N
                    exts = tuple(m.index_select(0, rows) for m in mm)
                    for wt in (None, mm[0][j * S:(j + 1) * S]):
                        got = k.cic_paint_lattice_slab_cuda(ds, B, wt)
                        same = torch.equal(got, k.cic_paint_lattice_slab_plain(
                            ds, B, wt))
                        again = torch.equal(got, k.cic_paint_lattice_slab_cuda(
                            ds, B, wt))
                        check(same and again, f"K11a slab {dt} B={B} "
                              f"{nslab} slabs: bitwise equal to the twin "
                              f"{same}, repeatable {again}")
                    full.index_add_(0, rows, k.cic_paint_lattice_slab_cuda(
                        ds, B))
                    got3 = k.cic_gather3_lattice_slab_cuda(exts, ds, B)
                    same = all(torch.equal(a, b) for a, b in zip(
                        got3, k.cic_gather3_lattice_slab_plain(exts, ds, B)))
                    again = all(torch.equal(a, b) for a, b in zip(
                        got3, k.cic_gather3_lattice_slab_cuda(exts, ds, B)))
                    rows_eq = all(torch.equal(a, b[j * S:(j + 1) * S])
                                  for a, b in zip(got3, periodic3))
                    check(same and again and rows_eq, f"K11c slab {dt} B={B} "
                          f"{nslab} slabs: bitwise equal to the twin {same}, "
                          f"repeatable {again}, to the periodic gather's rows "
                          f"{rows_eq}")
                e = norm_err(full, periodic)
                log(f"K11a slab {dt} B={B}, {nslab} slab(s) of {S} rows, "
                    f"strips folded: {e:.3e} of max from the periodic paint "
                    f"(bound {SLAB_FOLD_BOUND[dt]:.0e})")
                check(e <= SLAB_FOLD_BOUND[dt], f"K11a slab fold {dt} B={B}")
            del periodic, periodic3, full
        log(f"K11a/K11c slab mode {dt}: bitwise equal to the slab twins and "
            "repeatable at B = 1, 2, 3, one slab and four")
    B, H = 3, 4
    n3 = N ** 3
    ext_rows = torch.arange(-H, N + H, device=dev) % N
    exts = tuple(m.index_select(0, ext_rows) for m in meshes)
    times = {
        PAINT_SLAB: (median_ms(lambda: k.cic_paint_lattice_slab_cuda(d, B)),
                     median_ms(lambda: k.cic_paint_lattice_slab_plain(d, B))),
        GATHER3_SLAB: (
            median_ms(lambda: k.cic_gather3_lattice_slab_cuda(exts, d, B)),
            median_ms(lambda: k.cic_gather3_lattice_slab_plain(exts, d, B)))}
    per = (median_ms(lambda: k.cic_paint_lattice_cuda(d, B, None, False)),
           median_ms(lambda: k.cic_gather3_lattice_cuda(meshes, d, B, False)))
    idx8, w8 = cic_corners(d, N)
    lib_paint = median_ms(lambda: torch.zeros(n3, device=dev)
                          .index_add_(0, idx8, w8))
    del idx8, w8
    lib_gather = grid_sample_ms(meshes, d, B)[1]
    rows_out = N + 2 * H
    bounds = {PAINT_SLAB: roofline(4 * (3 * n3 + rows_out * N * N), 32 * n3),
              GATHER3_SLAB: roofline(4 * (6 * n3 + 3 * rows_out * N * N),
                                     3 * 32 * n3)}
    for name, lib, p in ((PAINT_SLAB, lib_paint, per[0]),
                         (GATHER3_SLAB, lib_gather, per[1])):
        log(f"{name} B=3, one {N}-row slab, f32: kernel {times[name][0]:.4f} "
            f"ms, plain {times[name][1]:.4f} ms, bound "
            f"{bounds[name]['bound_ms']:.4f} ms; periodic mode {p:.4f} ms; "
            f"{'index_add_' if name == PAINT_SLAB else 'grid_sample'} "
            f"{lib:.4f} ms")
    # max_abs_err: the kernels equal their twins bit for bit (checked)
    return [dict(name=name, max_abs_err=0.0, ms=times[name][0],
                 plain_ms=times[name][1], library_ms=lib, **bounds[name])
            for name, lib in ((PAINT_SLAB, lib_paint),
                              (GATHER3_SLAB, lib_gather))]


def growth_ratio(grid, cosmo0, delta) -> float:
    """tests/test_parallel_cola.py's criterion: mean P(k) of ``delta`` over
    mean P_lin on 2.5 k_f < k < 0.05 Mpc^-1."""
    dk = torch.fft.rfftn(delta.double())
    k = grid.kmag(torch.float64, delta.device)[:, :, :grid.N // 2 + 1]
    sel = (k > 2.5 * 2.0 * np.pi / grid.Lx) & (k < 0.05)
    pk = (dk.abs() ** 2 / grid.boxfactor)[sel].mean()
    return (pk / cosmo0.pk_lin(k[sel]).to(pk.device).mean()).item()


def run_sharded_cola(label: str, fn, grid, cosmo0, **kw) -> tuple:
    """One realisation; returns (outputs, wall seconds).  max_disp is read
    once, after the run; it must hold the band (3 cells)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(**kw)
    maxd = out["max_disp"].item()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    delta = out["delta_x"]
    check(delta.shape == grid.shape and bool(torch.isfinite(delta).all()),
          f"{label}: delta_x not finite of shape {grid.shape}")
    ratio = growth_ratio(grid, cosmo0, delta)
    log(f"{label}: {wall * 1e3:.1f} ms, max_disp {maxd:.4f} cells, "
        f"P/P_lin on large scales {ratio:.3f}")
    check(maxd <= 3.0, f"{label}: max_disp {maxd} beyond lattice_B = 3")
    check(SHARDED_GROWTH[0] < ratio < SHARDED_GROWTH[1],
          f"{label}: P/P_lin {ratio}")
    cola_health(grid, cosmo0, delta, label)
    return out, wall


def plain_slab_twins():
    """A stand-in for parallel/lattice.py's kernel module that sends the
    slab paint and gather to their plain twins on CUDA tensors."""
    import types

    from fastbox_tpu_torch.ops.cuda import lattice_cic as k

    def gather3(exts, d, B, out):
        for o, r in zip(out, k.cic_gather3_lattice_slab_plain(exts, d, B)):
            o.copy_(r)
        return out

    return types.SimpleNamespace(
        cic_paint_lattice_slab=k.cic_paint_lattice_slab_plain,
        cic_gather3_lattice_slab_cuda=gather3)


def phase_sharded_cola(dev, mesh) -> list[dict]:
    """Phase 8b on the one-rank NCCL mesh: (a) the slab kernels, (b)
    make_sharded_cola at 256^3 (x3) and 512^3, counted, (c) the plain slab
    twins on the same noise, (d) f64 64^3 on the card against the CPU;
    then phase_box.  Returns the slab kernels' rows."""
    import fastbox_tpu_torch.parallel.lattice as hl
    from fastbox_tpu_torch.cosmology import build_cosmology
    from fastbox_tpu_torch.fields.cola import realise_density_cola
    from fastbox_tpu_torch.grid import GridSpec
    from fastbox_tpu_torch.ops.cuda import _build
    from fastbox_tpu_torch.ops.spectra import binned_power_spectrum
    from fastbox_tpu_torch.parallel import local, make_sharded_cola

    cosmo0 = build_cosmology(COSMO, redshift=0.0, device=dev)
    grids = {n: GridSpec.create(box_scale=BOX * n / SLAB_N[0], nsamp=n)
             for n in SLAB_N}
    kw = dict(redshift_init=COLA_Z_INIT, n_steps=16, lattice_B=3,
              device=dev)
    fns = {n: make_sharded_cola(mesh, grids[n], cosmo0,
                                keep_velocities=False, **kw) for n in SLAB_N}
    fn_v = make_sharded_cola(mesh, grids[SLAB_N[0]], cosmo0,
                             keep_velocities=True, pk_nbins=20, **kw)
    g256 = grids[SLAB_N[0]]

    # warm-up, keeping the last force evaluation's inputs for (a)
    _, (meshes, d) = capture_slab_inputs(lambda: fns[SLAB_N[0]](seed=99))
    rows = slab_kernels(dev, meshes, d)
    del meshes, d

    # (b) the main path, counted
    _build.reset_launch_counts()
    r0, w0 = run_sharded_cola("sharded COLA 256^3 realisation 0",
                              fns[SLAB_N[0]], g256, cosmo0, seed=0)
    _, w1 = run_sharded_cola("sharded COLA 256^3 realisation 1",
                             fns[SLAB_N[0]], g256, cosmo0, seed=1)
    rv, w2 = run_sharded_cola(
        "sharded COLA 256^3 realisation 2 (keep_velocities, pk_nbins=20)",
        fn_v, g256, cosmo0, seed=2)
    _, w512 = run_sharded_cola("sharded COLA 512^3 in the 8 Gpc box",
                               fns[SLAB_N[1]], grids[SLAB_N[1]], cosmo0,
                               seed=3)
    counts = _build.launch_counts()
    log(f"launch counts over the sharded COLA path: {json.dumps(counts)}")
    check_route_off(counts, "the sharded COLA path")
    steps = kw["n_steps"]
    want = {PAINT_SLAB: 4 * (steps + 1) + 3, GATHER3_SLAB: 4 * steps}
    for name, n in want.items():
        check(counts.get(name, 0) == n, f"{name}: {counts.get(name, 0)} "
              f"launches, the code makes {n}")
    for name in ("cic_paint_lattice", "cic_gather_lattice",
                 "cic_gather3_lattice"):
        check(counts.get(name, 0) == 0, f"{name} launched on the slab path")
    for r in rows:
        r["launches"] = counts.get(r["name"], 0)
    vel = rv["vel"]
    check(vel.shape == (3,) + g256.shape and bool(torch.isfinite(vel).all()),
          "sharded COLA velocities")
    _, pk_ref, _ = binned_power_spectrum(g256, delta_x=rv["delta_x"])
    sel = torch.isfinite(pk_ref) & (pk_ref > 0)
    e_pk = ((rv["pk"][sel] - pk_ref[sel]) / pk_ref[sel]).abs().max().item()
    log(f"sharded COLA 256^3: velocities rms {vel.double().std().item():.2f} "
        f"km/s; in-program P(k) vs binned_power_spectrum of delta_x: "
        f"{e_pk:.3e} per populated bin")
    check(e_pk <= EST_BOUND, f"sharded COLA in-program P(k): {e_pk}")
    single = []
    gen = torch.Generator(device=dev).manual_seed(5)
    for _ in range(3):
        _, ms = wall_ms(lambda: realise_density_cola(
            gen, g256, cosmo0, redshift_init=COLA_Z_INIT, lattice_B=3,
            keep_velocities=False))
        single.append(ms)
    log(f"COLA 256^3: sharded engine (one rank) "
        f"{statistics.median([w0, w1, w2]) * 1e3:.1f} ms per realisation "
        f"(median of 3: {w0 * 1e3:.1f}, {w1 * 1e3:.1f}, {w2 * 1e3:.1f} with "
        f"velocities), single engine {statistics.median(single):.1f} ms "
        f"(median of 3); 512^3 sharded {w512 * 1e3:.1f} ms")

    # (c) the plain slab twins on the same noise
    kernels, hl.k11 = hl.k11, plain_slab_twins()
    try:
        plain, ms = wall_ms(lambda: fns[SLAB_N[0]](seed=0))
    finally:
        hl.k11 = kernels
    same = torch.equal(plain["delta_x"], r0["delta_x"])
    log(f"sharded COLA 256^3 with the plain slab twins: {ms:.1f} ms; delta_x "
        f"bitwise equal to the kernels' run: {same}")
    check(same, "sharded COLA: kernels vs plain twins differ")
    del r0, rv, plain, vel

    # (d) f64 at 64^3 on the card against the port on the CPU
    g64 = GridSpec.create(box_scale=BOX / 4, nsamp=64)
    kw64 = dict(redshift_init=COLA_Z_INIT, n_steps=4, lattice_B=3,
                dtype=torch.float64, pk_nbins=10)
    white = torch.randn((64, 64, 64), dtype=torch.float64,
                        generator=torch.Generator().manual_seed(64))
    gpu = make_sharded_cola(mesh, g64, cosmo0, device=dev, **kw64)(
        white=white)
    t0 = time.perf_counter()
    cpu = local.launch("fastbox_tpu_torch.parallel.local:tasks", 1, dict(
        tasks=["cola"], cola=[dict(grid=(BOX / 4, 64, 0.0), cosmo=COSMO,
                                   space=1, kw=kw64, white=white)]))[0]
    cpu = cpu["cola"][0]
    e = norm_err(gpu["delta_x"].cpu(), cpu["delta_x"])
    e_v = norm_err(gpu["vel"].cpu(), cpu["vel"])
    log(f"sharded COLA 64^3 f64, card vs CPU (one gloo rank, "
        f"{time.perf_counter() - t0:.1f} s): delta_x {e:.3e} of max, vel "
        f"{e_v:.3e}, max_disp {gpu['max_disp'].item():.6f} vs "
        f"{cpu['max_disp'].item():.6f}, pk "
        f"{max_rel(gpu['pk'], cpu['pk']):.3e}")
    check(e <= SHARDED_F64_BOUND, f"sharded COLA f64 card vs CPU: {e}")
    phase_box(dev)
    return rows


def box_call(label: str, expect: tuple, body):
    """``body`` with the launch counters reset just before and read just
    after: every kernel in ``expect`` launched, K10 did not; its wall ms."""
    (result, ms), counts = counted(label, expect, lambda: wall_ms(body))
    log(f"{label}: {ms:.2f} ms on the card")
    return result


def phase_box(dev) -> None:
    """(e) CosmoBox at 256^3 in the 4 Gpc box at z = 0.8, f32, on the card
    against the same box on the CPU on the same supplied noise, each call
    counted; then the noise, halo and beam models."""
    from fastbox_tpu_torch.box import CosmoBox
    from fastbox_tpu_torch.models import beams, halos, noise

    kw = dict(cosmo=COSMO, box_scale=BOX, nsamp=N_MAIN, redshift=Z,
              realise_now=False, dtype=torch.float32)
    gb, cb = CosmoBox(device=dev, **kw), CosmoBox(device="cpu", **kw)
    gen = torch.Generator().manual_seed(21)
    shape = gb.grid.shape
    white = torch.complex(torch.randn(shape, generator=gen),
                          torch.randn(shape, generator=gen))
    box_call("CosmoBox.realise_density_from_whitenoise 256^3", (),
             lambda: gb.realise_density_from_whitenoise(white))
    cb.realise_density_from_whitenoise(white)
    e = norm_err(gb.delta_x.cpu(), cb.delta_x)
    log(f"CosmoBox delta_x, card vs CPU f32: {e:.3e} of max")
    check(e <= BOX_FIELD_BOUND, f"CosmoBox delta_x: {e}")
    v = {}
    for b, name in ((gb, "card"), (cb, "cpu")):
        b.realise_velocity()
        v[name] = torch.fft.ifftn(b.velocity_k[2]).real.contiguous()
    normals = torch.randn(shape, generator=gen)
    for sigma_nl, expect in ((0.0, ("rsd_remap_wrap",)),
                             (120.0, ("rsd_remap_wrap", "add_scaled_normal"))):
        nrm = normals if sigma_nl > 0 else None
        # the CPU box's delta and velocity on both devices: K1 and K2 equal
        # their twins bit for bit, so the two remaps must too
        got = box_call(
            f"CosmoBox.redshift_space_density sigma_nl={sigma_nl:g}", expect,
            lambda: gb.redshift_space_density(cb.delta_x, v["cpu"],
                                              sigma_nl=sigma_nl,
                                              normals=nrm)).cpu()
        ref = cb.redshift_space_density(cb.delta_x, v["cpu"],
                                        sigma_nl=sigma_nl, normals=nrm)
        same = torch.equal(got, ref)
        # each box on its own delta and velocity (FFT rounding apart)
        own = gb.redshift_space_density(gb.delta_x, v["card"],
                                        sigma_nl=sigma_nl, normals=nrm).cpu()
        diff = (own - ref).abs()
        top = ref.abs().max().item()
        log(f"CosmoBox RSD sigma_nl={sigma_nl:g}, card vs CPU f32: on the "
            f"same inputs bitwise equal {same}; on each box's own fields max "
            f"{diff.max().item() / top:.3e} of max, "
            f"{int((diff > BOX_FIELD_BOUND * top).sum())} of {ref.numel()} "
            f"values beyond {BOX_FIELD_BOUND:.0e}")
        check(same, f"CosmoBox RSD sigma_nl={sigma_nl:g}: card vs CPU differ "
              "on the same inputs")
    got = box_call("CosmoBox.binned_power_spectrum 256^3", ("binned_pk_full",),
                   gb.binned_power_spectrum)
    ref = cb.binned_power_spectrum()
    sel = torch.isfinite(ref[1]) & (ref[1] > 0)
    e = ((got[1].cpu()[sel] - ref[1][sel]) / ref[1][sel]).abs().max().item()
    log(f"CosmoBox P(k), card vs CPU f32: {e:.3e} per populated bin")
    check(e <= BOX_PK_BOUND, f"CosmoBox P(k): {e}")
    log(f"CosmoBox sigma8 card {gb.sigma8():.6f}, CPU {cb.sigma8():.6f}")

    # COLA at 128^3 through the box (K11's periodic mode)
    kw128 = dict(kw, nsamp=BOX_COLA_N, box_scale=BOX * BOX_COLA_N / N_MAIN)
    gb2, cb2 = CosmoBox(device=dev, **kw128), CosmoBox(device="cpu", **kw128)
    w128 = torch.complex(*(torch.randn(gb2.grid.shape, generator=gen)
                           for _ in range(2)))
    dg = box_call("CosmoBox.realise_density_cola 128^3",
                  ("cic_paint_lattice", "cic_gather3_lattice"),
                  lambda: gb2.realise_density_cola(white=w128,
                                                   keep_velocities=False))
    t0 = time.perf_counter()
    dc = cb2.realise_density_cola(white=w128, keep_velocities=False)
    log(f"CosmoBox COLA 128^3 on the CPU: {time.perf_counter() - t0:.1f} s")
    cola_health(gb2.grid, gb2.cosmology, dg, "CosmoBox COLA 128^3 (z=0.8)")
    pk_g = gb2.binned_power_spectrum(delta_x=dg)[1].cpu()
    pk_c = cb2.binned_power_spectrum(delta_x=dc)[1]
    sel = torch.isfinite(pk_c) & (pk_c > 0)
    e = ((pk_g[sel] - pk_c[sel]) / pk_c[sel]).abs().max().item()
    log(f"CosmoBox COLA 128^3, card vs CPU f32: delta "
        f"{norm_err(dg.cpu(), dc):.3e} of max, P(k) {e:.3e} per populated bin")
    check(e <= BOX_COLA_PK_BOUND, f"CosmoBox COLA P(k): {e}")
    del gb2, cb2, dg, dc

    # the models
    nm = noise.NoiseModel(gb)
    out = box_call("NoiseModel.realise_radiometer_noise 256^3",
                   ("add_scaled_normal",),
                   lambda: nm.realise_radiometer_noise(18.0, 2.0, 1.0, 64))
    sigma = noise.radiometer_sigma(gb.freq_array(), gb.pixel_array()[0],
                                   18.0, 2.0, 1.0, 64)
    scaled = out.double() / torch.as_tensor(sigma, device=dev)
    pooled = scaled.std().item()
    per = (scaled.std(dim=(0, 1)) - 1).abs().max().item()
    per_bound = NOISE_CHANNEL_SIGMAS / np.sqrt(2.0 * N_MAIN ** 2)
    log(f"NoiseModel noise / sigma: pooled std {pooled:.5f}, largest "
        f"per-channel std off 1 by {per:.4f} (bound {per_bound:.4f})")
    check(abs(pooled - 1) <= NOISE_POOLED_BOUND and per <= per_bound,
          f"NoiseModel std: pooled {pooled}, per channel {per}")
    same = torch.equal(nm.realise_radiometer_noise(
        18.0, 2.0, 1.0, 64, normals=normals.to(dev)).cpu(),
        noise.NoiseModel(cb).realise_radiometer_noise(18.0, 2.0, 1.0, 64,
                                                      normals=normals))
    check(same, "NoiseModel on supplied normals: card vs CPU differ")
    hd = halos.HaloDistribution(gb, (1e12, 1e15), 10)
    counts = box_call("HaloDistribution.halo_count_field 256^3", (),
                      lambda: hd.halo_count_field(gb.delta_x, 1e-3, 1.0))
    mean, want = counts.double().mean().item(), gb.grid.voxel_volume * 1e-3
    log(f"halo counts: mean {mean:.4f} per voxel, nbar V_voxel {want:.4f}")
    check(int(counts.min()) >= 0 and abs(mean / want - 1) <= HALO_MEAN_BOUND,
          f"halo counts mean {mean} vs {want}")
    cat_g = box_call("realise_halo_catalogue_padded 256^3", (),
                     lambda: halos.realise_halo_catalogue_padded(
                         None, counts, gb.grid, 2 ** 24))
    cat_c = halos.realise_halo_catalogue_padded(None, counts.cpu(), cb.grid,
                                                2 ** 24)
    same = all(torch.equal(a.cpu(), b) for a, b in zip(cat_g, cat_c))
    log(f"padded catalogue: {int(cat_g[2])} halos, {int(cat_g[1].sum())} "
        f"kept; card and CPU bitwise equal: {same}")
    check(same, "padded halo catalogue: card vs CPU differ")
    del counts, cat_g, cat_c
    field = cb.delta_x
    got = box_call("GaussianBeamModel.convolve_fft 256^3", (),
                   lambda: beams.GaussianBeamModel(gb, 13.5).convolve_fft(
                       field.to(dev)))
    e = norm_err(got.cpu(),
                 beams.GaussianBeamModel(cb, 13.5).convolve_fft(field))
    log(f"GaussianBeamModel.convolve_fft, card vs CPU f32: {e:.3e} of max")
    check(e <= BOX_FIELD_BOUND, f"beam convolution: {e}")


# ----------------------------------------------------------------------
# Phase 8c: the foreground models, the cleaners and the checkpoints
# ----------------------------------------------------------------------
FG_CHECK_N, FG_CHECK_BOX = 64, 1e3   # (b): the card against the CPU
KPCA_PIX = {N_MAIN: 64, FG_CHECK_N: 32}   # the kernel PCA's pixel cut
FG_REPS = 3
# (b) max|card - CPU| / max|CPU| of each output, on the same noise (PERF.md
# §4, stated before the first run).  The chain's fields: FFT, pow and exp
# rounding, which the f32 RSD remap's brackets magnify (1.67e-5 of max on
# each device's own fields at 256^3, PERF.md §6).  The cleaned cubes are
# ~1e-6 of the data, whose bright point sources reach ~4e6 mK: a
# covariance rounding of eps * 1e12 mK^2 then
# reaches the noise-level eigenvalues that separate the 4th mode from the
# 5th, in f32 and, at eps64, still near them.  On this cube fastbox_tpu and
# the port, both in f64 on the CPU, differ by 6.7e-4 (PCA), 2.4e-3
# (band-power PCA), 1.1e-3 (ICA), 6.1e-2 and 1.0e-1 (kernel PCA), 1.2e-4
# (GPR's 500 Adam steps), 2.1e-8 (LSQ) and 1.1e-11 (NMF) of the cleaned
# cube's max.  In f32 each cleaned cube is held to 3x the CPU's own f32
# floor (the CPU f32 run against the CPU f64 run, measured in the same
# call), as the truth gate holds the card.
FG_STAGE_BOUND = {torch.float64: 1e-10, torch.float32: 1e-4}
FG_CLEAN_BOUND_F64 = {"mean_spectrum_filter": 1e-8,
                      "angular_bandpass_filter": 1e-8, "nmf_filter": 1e-8,
                      "LSQfitting.run_fit": 1e-6,
                      "LSQfitting.give_hest": 1e-6, "gpr_filter": 1e-2,
                      "pca_filter": 0.5, "bandpower_pca_filter": 0.5,
                      "ica_filter": 0.5, "kernel_pca_filter": 0.5,
                      "kernel_pca_filter_legacy": 0.5}
FG_F32_FLOORS = 3.0


def fg_chain(box, noise=None, step=None) -> dict:
    """The README quickstart on ``box`` with the point sources added:
    density, HI bias, log-normal, RSD at sigma_NL 120 km/s (K2, K1), T_b,
    the diffuse foregrounds, the point sources and the radiometer noise
    (K1).  ``noise``: the supplied numbers of every draw (None: the box's
    generator); ``step(label, fn)`` runs each stage (default: once)."""
    from fastbox_tpu_torch.models import (ForegroundModel, HITracer,
                                          NoiseModel, PointSourceModel)

    s = noise or {}
    step = step or (lambda label, fn: fn())
    out = {}
    step("realise_density", lambda: box.realise_density(white=s.get("white")))
    tracer = HITracer(box)
    out["delta_ln"] = step("HITracer bias + lognormal", lambda: box.lognormal(
        box.delta_x * tracer.bias_HI()))
    vel_z = step("realise_velocity + ifftn", lambda: torch.fft.ifftn(
        box.realise_velocity(delta_x=box.delta_x)[2]).real.contiguous())
    out["delta_s"] = step("redshift_space_density sigma_nl=120", lambda:
                          box.redshift_space_density(
                              out["delta_ln"], vel_z, sigma_nl=120.0,
                              normals=s.get("rsd")))
    out["T_b"] = step("T_b", lambda: tracer.signal_amplitude()
                      * (1.0 + out["delta_s"]))
    fgm = ForegroundModel(box)
    out["fg_amp"] = step("ForegroundModel.realise_foreground_amp", lambda:
                         fgm.realise_foreground_amp(
                             57.0, 1.1, 10.0, smoothing_scale=4.0,
                             white=s.get("fg_white")))
    out["fg_alpha"] = step("ForegroundModel.realise_spectral_index", lambda:
                           fgm.realise_spectral_index(
                               2.07, 2e-4, 15.0, normals=s.get("fg_normals")))
    out["fg"] = step("ForegroundModel.construct_cube", lambda:
                     fgm.construct_cube(out["fg_amp"], out["fg_alpha"],
                                        freq_ref=130.0))
    ps = PointSourceModel(box)
    out["ps"], out["tpsmean"] = step(
        "PointSourceModel.construct_cube", lambda: ps.construct_cube(
            flux_cutoff=0.1, beta=-2.7, delta_beta=0.1, seed_clustering=1,
            seed_poisson=2, white_clustering=s.get("ps_white_c"),
            white_poisson=s.get("ps_white_p"),
            spidx_normals=s.get("ps_normals")))
    out["shot"] = torch.as_tensor(ps.shot_map(0.1, seed_poisson=2))
    out["noise"] = step("NoiseModel.realise_radiometer_noise", lambda:
                        NoiseModel(box).realise_radiometer_noise(
                            18.0, 2.0, 1.0, 64, normals=s.get("noise")))
    out["data"] = out["T_b"] + out["fg"] + out["ps"] + out["noise"]
    return out


def fg_cleaners(box, data, tpsmean, w0=None) -> list:
    """(name, call) of every cleaner on ``data``: NMF on the cube shifted
    to be non-negative (where it is not), kernel PCA on the KPCA_PIX cut,
    LSQ's residual reshaped to the cube."""
    import fastbox_tpu_torch.filters as flt

    n = box.N
    lsq = flt.LSQfitting(box)
    freqs = box.freq_array()
    nonneg = data - torch.clamp(data.min(), max=0.0)
    cut = data[:KPCA_PIX[n], :KPCA_PIX[n]].contiguous()
    return [
        ("pca_filter", lambda: flt.pca_filter(data, 4)),
        ("mean_spectrum_filter", lambda: flt.mean_spectrum_filter(data)),
        ("angular_bandpass_filter", lambda: flt.angular_bandpass_filter(
            data, 0.05, 0.3).real.contiguous()),
        ("bandpower_pca_filter", lambda: flt.bandpower_pca_filter(data, 3,
                                                                  4)),
        ("ica_filter", lambda: flt.ica_filter(data, 4, w0=w0)),
        ("nmf_filter", lambda: flt.nmf_filter(nonneg, 4)),
        ("LSQfitting.run_fit", lambda: lsq.run_fit(
            data, freqs, n * n, tpsmean, -2.1)[0].reshape(data.shape)),
        ("LSQfitting.give_hest", lambda: lsq.give_hest(data, -2.1, -2.7, 0.1,
                                                       0.1)[0]),
        ("gpr_filter", lambda: flt.gpr_filter(data)),
        ("kernel_pca_filter", lambda: flt.kernel_pca_filter(cut, 4)),
        ("kernel_pca_filter_legacy", lambda: flt.kernel_pca_filter_legacy(
            cut, 4)),
    ]


def timed_step(times: dict):
    """A ``fg_chain`` step that runs each stage FG_REPS times, logs its
    wall ms (median) and peak device memory, and keeps the median in
    ``times``."""
    def step(label, fn):
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(FG_REPS):
            out, t = wall_ms(fn)
            ms.append(t)
        times[label] = statistics.median(ms)
        log(f"8c {label}: {times[label]:.2f} ms (median of {FG_REPS}: "
            + ", ".join(f"{t:.2f}" for t in ms) + "), peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        return out
    return step


def ica_iterations(fn) -> tuple:
    """(result of ``fn``, the number of symmetric decorrelations it made:
    one for the start and one per FastICA iteration)."""
    ica = sys.modules["fastbox_tpu_torch.filters.ica"]
    inner, calls = ica._sym_decorrelation, []

    def counting(W):
        calls.append(1)
        return inner(W)

    ica._sym_decorrelation = counting
    try:
        return fn(), len(calls)
    finally:
        ica._sym_decorrelation = inner


def phase_foregrounds(dev, mesh) -> None:
    """Phase 8c, on phase 7's one-rank NCCL mesh: (a) the quickstart chain
    and every cleaner at 256^3 on the card, timed, K1/K2/K6 counted; (b)
    the chain on supplied noise at 64^3, card against CPU in f32 and f64;
    (c) save_sharded/load_sharded of a 256^3 slab and save_box/load_box of
    the 256^3 box."""
    from fastbox_tpu_torch.box import CosmoBox
    from fastbox_tpu_torch.ops.cuda import _build

    # (a) the quickstart at 256^3, counted from zero
    kw = dict(cosmo=COSMO, box_scale=BOX, nsamp=N_MAIN, redshift=Z,
              realise_now=False, seed=10, dtype=torch.float32)
    box = CosmoBox(device=dev, **kw)
    times = {}
    step = timed_step(times)
    t0 = time.perf_counter()
    _build.reset_launch_counts()
    chain = fg_chain(box, step=step)
    data = chain["data"]
    check(bool(torch.isfinite(data).all()), "8c: the data cube")
    cleaned = {}
    for name, call in fg_cleaners(box, data, chain["tpsmean"]):
        if name == "ica_filter":
            (out, n_dec) = step(name, lambda: ica_iterations(call))
            log(f"8c ica_filter: {n_dec - 1} FastICA iterations, "
                f"{times[name] / max(n_dec - 1, 1):.3f} ms per iteration")
        else:
            out = step(name, call)
        check(bool(torch.isfinite(out).all()),
              f"8c {name}: non-finite values in the cleaned cube")
        cleaned[name] = out
    for name, cube in cleaned.items():
        if cube.shape != box.grid.shape:
            continue    # the kernel PCA's pixel cut
        k, pk, _ = step(f"binned_power_spectrum of {name}",
                        lambda: box.binned_power_spectrum(delta_x=cube))
        check(bool(torch.isfinite(pk[1:]).any()), f"8c P(k) of {name}")
    counts = _build.launch_counts()
    log(f"8c launch counts over the quickstart and the cleaners: "
        f"{json.dumps(counts)}")
    check_route_off(counts, "phase 8c")
    for name in ("add_scaled_normal", "rsd_remap_wrap", "binned_pk_full"):
        check(counts.get(name, 0) > 0, f"8c: {name} never launched")
    dec = torch.randn((4, 4), dtype=torch.float64, device=dev)
    eigh_ms = median_ms(lambda: torch.linalg.eigh(dec @ dec.T))
    log(f"8c: one 4x4 f64 eigh on the card {eigh_ms:.4f} ms (cuSOLVER, "
        f"FastICA's decorrelation); phase (a) {time.perf_counter() - t0:.1f}"
        " s")

    # (b) card against CPU on supplied noise, f32 and f64
    t0 = time.perf_counter()
    fg_versus_cpu(dev)
    log(f"8c (b): {time.perf_counter() - t0:.1f} s")

    # (c) the checkpoints
    fg_checkpoints(dev, mesh, box)


def fg_noise(n: int, seed: int) -> dict:
    """Every draw of ``fg_chain`` at N = n, from a CPU generator: float64."""
    gen = torch.Generator().manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64)

    def cnormal(*shape):
        return torch.complex(normal(*shape), normal(*shape))

    return {"white": cnormal(n, n, n), "rsd": normal(n, n, n),
            "fg_white": cnormal(n, n), "fg_normals": normal(n, n),
            "ps_white_c": cnormal(n, n), "ps_white_p": cnormal(n, n),
            "ps_normals": normal(n, n), "noise": normal(n, n, n),
            "w0": normal(4, 4)}


def fg_versus_cpu(dev) -> None:
    """(b): the chain and every cleaner at FG_CHECK_N^3 on the same supplied
    noise on the card and on the CPU, in f32 and in f64; each output's
    max|card - CPU| / max|CPU| against its bound (FG_STAGE_BOUND,
    FG_CLEAN_BOUND_F64, FG_F32_FLOORS x the CPU's f32 floor); the shot
    maps equal."""
    from fastbox_tpu_torch.box import CosmoBox
    from fastbox_tpu_torch.fields.gaussian import complex_dtype

    noise = fg_noise(FG_CHECK_N, 8)
    got = {}
    for dtype in (torch.float32, torch.float64):
        for tag, where in (("card", dev), ("cpu", "cpu")):
            box = CosmoBox(cosmo=COSMO, box_scale=FG_CHECK_BOX,
                           nsamp=FG_CHECK_N, redshift=Z, realise_now=False,
                           dtype=dtype, device=where)
            s = {k: v.to(complex_dtype(dtype) if v.is_complex() else dtype)
                 .to(where) for k, v in noise.items()}
            out = fg_chain(box, s)
            for name, call in fg_cleaners(box, out["data"], out["tpsmean"],
                                          w0=s["w0"]):
                out[name] = call()
            got[tag, dtype] = out
    cpu32, cpu64 = got["cpu", torch.float32], got["cpu", torch.float64]
    stages = ("delta_ln", "delta_s", "T_b", "fg_amp", "fg_alpha", "fg", "ps",
              "noise", "data")
    for dtype in (torch.float32, torch.float64):
        card, cpu = got["card", dtype], got["cpu", dtype]
        check(torch.equal(card["shot"], cpu["shot"]),
              "8c: the shot maps differ between the card and the CPU")
        for name, want in cpu.items():
            if name in ("shot", "tpsmean"):
                continue
            check(bool(torch.isfinite(card[name]).all()),
                  f"8c (b) {name}: non-finite values on the card")
            e = norm_err(card[name].cpu(), want)
            floor = norm_err(cpu32[name], cpu64[name])
            if name in stages:
                bound = FG_STAGE_BOUND[dtype]
            elif dtype == torch.float64:
                bound = FG_CLEAN_BOUND_F64[name]
            else:
                bound = FG_F32_FLOORS * floor + 1e-6
            log(f"8c (b) {str(dtype)[6:]} {name}: card vs CPU {e:.3e} of max "
                f"(bound {bound:.3e}; CPU f32 vs f64 {floor:.3e})")
            check(e <= bound, f"8c (b) {name} {dtype}: {e} > {bound}")
    log("8c (b): every output within its bound; shot maps torch.equal")


def fg_checkpoints(dev, mesh, box) -> None:
    """(c): a 256^3 f32 slab as a DTensor (this rank's rows over 'space')
    saved and restored bitwise, and the 256^3 box through save_box /
    load_box, with write and read times.  Files go under build/ and are
    removed."""
    import shutil
    from pathlib import Path

    from torch.distributed.tensor import DTensor, Replicate, Shard

    from fastbox_tpu_torch import io as fio

    root = Path(__file__).resolve().parent / "build" / "chip_smoke_io"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        slab = box.delta_x.contiguous()
        placements = [Replicate(), Shard(0)]
        tree = {"delta": DTensor.from_local(slab, mesh, placements)}
        _, w = wall_ms(lambda: fio.save_sharded(str(root / "ckpt"), tree))
        template = {"delta": DTensor.from_local(torch.full_like(slab, -1.0),
                                                mesh, placements)}
        got, r = wall_ms(lambda: fio.load_sharded(str(root / "ckpt"),
                                                  template))
        same = torch.equal(got["delta"].to_local(), slab)
        mb = slab.numel() * slab.element_size() / 2**20
        log(f"8c (c) save_sharded of a {N_MAIN}^3 f32 slab ({mb:.0f} MiB): "
            f"write {w:.1f} ms, read {r:.1f} ms, bitwise equal {same}")
        check(same, "8c: save_sharded/load_sharded round trip differs")
        path = str(root / "box.npz")
        _, w = wall_ms(lambda: fio.save_box(path, box))
        back, r = wall_ms(lambda: fio.load_box(path, device=dev))
        names = ("delta_x", "delta_k")
        same = (all(torch.equal(getattr(back, n), getattr(box, n))
                    for n in names)
                and all(torch.equal(a, b) for a, b in zip(back.velocity_k,
                                                          box.velocity_k))
                and back.grid == box.grid and back.dtype == box.dtype)
        log(f"8c (c) save_box/load_box of the {N_MAIN}^3 box (delta_x, "
            f"delta_k, velocity_k; {Path(path).stat().st_size / 2**20:.0f} "
            f"MiB compressed): write {w:.0f} ms, read {r:.0f} ms, bitwise "
            f"equal {same}")
        check(same, "8c: save_box/load_box round trip differs")
    finally:
        shutil.rmtree(root, ignore_errors=True)


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
    (K8's row, the launches of K7, K8 and K4t each on its path, the mesh,
    which phase 8b uses and main tears down)."""
    import tempfile

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

    (_, step_k3), counts = counted(
        "the sharded step, sigma_nl=6000 (exact tier)", ("interp_sorted",),
        lambda: k3_calls(lambda: run_step(step_exact, dev,
                                          "sharded 256^3 B=8 sigma_nl=6000",
                                          list(range(300, 308)))))
    check(len(step_k3) == 1, f"the sharded step at sigma_nl=6000: "
          f"{len(step_k3)} K3 calls, not 1")
    k3_step_rows(step_k3.pop())

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
    phase_estimators(dev, cosmo, grid, fn256, mesh)
    return [k8], launches, mesh


def est_held(what: str, got: dict, want: dict, failures: list) -> None:
    """An estimator's dict on the card against the CPU f32 run: ``modes``
    (and the bin edges) ``torch.equal``, every other value within
    EST_BOUND per populated bin, relative (absolute where the value is 0);
    the odd P(k) poles and the xi poles of l > 0, which change sign from
    bin to bin, within EST_BOUND of max|P_0| or max|xi_0|.  Records
    failures; logs the worst of each key."""
    got = {k: torch.as_tensor(v).cpu() for k, v in got.items()}
    want = {k: torch.as_tensor(v) for k, v in want.items()}
    same = torch.equal(got["modes"], want["modes"])
    moved = int((got["modes"] != want["modes"]).sum())
    if not same:
        failures.append(f"{what}: modes differ in {moved} bins")
    pop = want["modes"] > 0
    worst, shown = {}, {}
    for k, w in want.items():
        if k == "modes" or k.endswith("edges"):
            if k != "modes" and not torch.equal(got[k], w):
                failures.append(f"{what}: {k} differ")
            continue
        g, w = got[k].double()[pop], w.double()[pop]
        err = (g - w).abs()
        # a mean that is exactly 0 (mu on kz = 0 modes, r = 0) is held
        # absolutely
        rel = (err / torch.where(w == 0, 1.0, w.abs())).max().item()
        if k[-2:] in ("_1", "_3") or (k.startswith("corr_")
                                       and k != "corr_0"):
            scale = want[k[:-1] + "0"].double()[pop].abs().max()
            worst[k] = (err.max() / scale).item()
            shown[k] = f"{worst[k]:.2e} of max|{k[:-1]}0| (per bin {rel:.2e})"
        else:
            worst[k] = rel
            shown[k] = f"{rel:.2e}"
        if not worst[k] <= EST_BOUND:
            failures.append(f"{what}: {k} {worst[k]:.3e}")
    log(f"estimator {what}: modes torch.equal to the CPU f32 run: {same} "
        f"({pop.sum().item()} populated bins); worst err "
        + ", ".join(f"{k} {v}" for k, v in shown.items()))


def est_time(fn) -> tuple:
    """(median wall ms of EST_REPS calls after a warm-up, each between
    torch.cuda.synchronize() calls; the call's peak device memory above
    what was allocated before it, GiB)."""
    fn()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(EST_REPS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return (statistics.median(times),
            (torch.cuda.max_memory_allocated() - base) / 2 ** 30)


def phase_estimators(dev, cosmo, grid, fn256, mesh) -> None:
    """Phase 7b, on the one-rank mesh: the estimators of ops/spectra.py and
    ops/nbodykit_compat.py on a realise_density cube on the card against
    the port on the CPU in f32 on the same cube; the sharded spectra in f64
    against the single-device f64 calls; the sharded PCA filter against
    pca_filter on the pipeline's 256^3 data cube; the sharded halo counts'
    repeatability and mean; then wall ms and peak memory at 256^3 and
    512^3.  Fails after logging every comparison if any failed."""
    from fastbox_tpu_torch.fields.gaussian import realise_density
    from fastbox_tpu_torch.filters.pca import pca_filter
    from fastbox_tpu_torch.grid import GridSpec
    from fastbox_tpu_torch.ops import nbodykit_compat as nb
    from fastbox_tpu_torch.ops import spectra
    from fastbox_tpu_torch.parallel import (make_sharded_correlation,
                                            make_sharded_halo_counts,
                                            make_sharded_pca_filter,
                                            make_sharded_power_multipoles,
                                            make_sharded_power_spectrum)

    failures = []
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(1313)
    a = realise_density(gen, grid, cosmo)[0]
    b = realise_density(gen, grid, cosmo)[0]
    a_cpu, b_cpu = a.cpu(), b.cpu()
    for dt in (torch.float32, torch.float64):
        same = torch.equal(grid.kmag(dt, dev).cpu(), grid.kmag(dt))
        log(f"|k| at {grid.N}^3 in {dt}: card torch.equal to the CPU: {same}")
        if not same:
            failures.append(f"|k| {dt} differs between card and CPU")

    single = {
        "power_spectrum nmu=1": (spectra.power_spectrum, dict(), False),
        "power_spectrum nmu=5 los z": (spectra.power_spectrum,
                                       dict(nmu=5, los=(0, 0, 1)), False),
        "power_spectrum nmu=5 los (1,1,1)": (spectra.power_spectrum,
                                             dict(nmu=5, los=(1, 1, 1)),
                                             False),
        "power_spectrum cross": (spectra.power_spectrum, dict(), True),
        "power_multipoles 0-4": (spectra.power_multipoles,
                                 dict(poles=(0, 1, 2, 3, 4)), False),
        "correlation_function": (spectra.correlation_function, dict(),
                                 False),
        "correlation_multipoles 0,2,4": (spectra.correlation_multipoles,
                                         dict(poles=(0, 2, 4)), False),
    }
    t_cpu = 0.0
    for what, (fn, kw, cross) in single.items():
        got = fn(grid, a, b if cross else None, **kw)
        t0 = time.perf_counter()
        want = fn(grid, a_cpu, b_cpu if cross else None, **kw)
        t_cpu += time.perf_counter() - t0
        est_held(what, got, want, failures)

    mesh_gpu, mesh_cpu = nb.ArrayMesh(a, BOX), nb.ArrayMesh(a_cpu, BOX)
    for what, make in (
            ("FFTPower 2d Nmu=5 poles 0,2,4", lambda m: nb.FFTPower(
                m, mode="2d", Nmu=5, poles=(0, 2, 4))),
            ("FFTCorr poles 0,2", lambda m: nb.FFTCorr(m, poles=(0, 2)))):
        got, want = make(mesh_gpu), make(mesh_cpu)
        for part in ("power", "corr", "poles"):
            if getattr(want, part, None) is not None:
                est_held(f"{what} .{part}", getattr(got, part),
                         getattr(want, part), failures)
    pos = torch.rand((EST_N_PARTICLES, 3), generator=torch.Generator()
                     .manual_seed(5), dtype=torch.float32) * BOX
    kw = dict(Nmesh=N_MAIN, BoxSize=BOX, window="tsc", compensated=True,
              interlaced=True)
    m_gpu = nb.ArrayCatalog({"Position": pos.to(dev)}).to_mesh(**kw)
    t0 = time.perf_counter()
    m_cpu = nb.ArrayCatalog({"Position": pos}).to_mesh(**kw)
    t_cpu += time.perf_counter() - t0
    err = norm_err(m_gpu.field.cpu(), m_cpu.field)
    log(f"ArrayCatalog.to_mesh ({EST_N_PARTICLES} uniform particles, "
        f"{N_MAIN}^3, TSC, compensated, interlaced): card vs CPU f32 "
        f"max|diff|/max|field| {err:.3e}")
    if not err <= EST_BOUND:
        failures.append(f"to_mesh field {err:.3e}")
    est_held("FFTPower of the to_mesh mesh", nb.FFTPower(m_gpu).power,
             nb.FFTPower(m_cpu).power, failures)
    del m_gpu, m_cpu, mesh_gpu, mesh_cpu, a_cpu, b_cpu
    log(f"estimators: the CPU f32 references took {t_cpu:.1f} s")

    # the sharded factories in f64 on the one-rank mesh
    a64, b64 = a.double(), b.double()
    sharded = {
        "power nmu=1": (make_sharded_power_spectrum, dict(),
                        spectra.power_spectrum),
        "power nmu=5 los (1,1,1) cross": (
            make_sharded_power_spectrum, dict(nmu=5, los=(1, 1, 1),
                                              cross=True),
            spectra.power_spectrum),
        "multipoles 0-4": (make_sharded_power_multipoles,
                           dict(poles=(0, 1, 2, 3, 4)),
                           spectra.power_multipoles),
        "correlation cross": (make_sharded_correlation, dict(cross=True),
                              spectra.correlation_function),
        "correlation poles 0,2,4": (make_sharded_correlation,
                                    dict(poles=(0, 2, 4)),
                                    spectra.correlation_multipoles),
    }
    for what, (make, kw, ref) in sharded.items():
        kw = dict(kw)
        got = make(mesh, grid, dtype=torch.float64, device=dev, **kw)(
            *((a64, b64) if kw.get("cross") else (a64,)))
        cross = kw.pop("cross", False)
        want = ref(grid, a64, b64 if cross else None, **kw)
        worst = 0.0
        for k, w in want.items():
            g = got[k]
            ok = torch.allclose(g, w, rtol=SHARDED_RTOL, atol=SHARDED_ATOL,
                                equal_nan=True)
            fin = torch.isfinite(w)
            worst = max(worst, ((g - w).abs()[fin] / (
                SHARDED_ATOL + SHARDED_RTOL * w.abs()[fin])).max().item())
            if not ok or (k == "modes" and not torch.equal(g, w)):
                failures.append(f"sharded {what}: {k}")
        log(f"sharded {what} (f64, one-rank mesh) vs single-device f64 on the "
            f"card: worst |diff| / (atol + rtol |want|) {worst:.2e} (passes "
            "at <= 1)")

    # the sharded PCA filter on the pipeline's data cube (foregrounds, noise)
    data = fn256.pre(torch.Generator(device=dev).manual_seed(77))["data"]
    cleaned_s, fg_s = make_sharded_pca_filter(mesh, grid, nmodes=4)(data)
    cleaned = pca_filter(data, 4)
    err_c = norm_err(cleaned_s, cleaned)
    err_f = norm_err(fg_s, data.double() - cleaned.double())
    log(f"sharded PCA filter vs pca_filter, {grid.N}^3 pipeline cube: cleaned "
        f"max|diff|/max|cleaned| {err_c:.3e}; fit vs data - cleaned "
        f"{err_f:.3e}")
    if not err_c <= PCA_SHARDED_BOUND:
        failures.append(f"sharded PCA cleaned {err_c:.3e}")
    if not err_f <= PCA_SHARDED_BOUND:
        failures.append(f"sharded PCA fit {err_f:.3e}")
    del data, cleaned_s, fg_s, cleaned

    # the sharded halo counts: the same field twice from one seed
    nbar = 1e-3
    halos = make_sharded_halo_counts(mesh, grid, nbar=nbar, bias=1.5)
    c1, c2 = halos(11, a), halos(11, a)
    mean = c1.double().mean().item() / (nbar * grid.voxel_volume)
    log(f"sharded halo counts at {grid.N}^3: bitwise repeatable "
        f"{torch.equal(c1, c2)}; mean / (nbar V_voxel) {mean:.4f}")
    if not torch.equal(c1, c2) or not abs(mean - 1.0) < 0.2:
        failures.append(f"halo counts: repeatable {torch.equal(c1, c2)}, "
                        f"mean ratio {mean}")
    del c1, c2, a64, b64
    log(f"estimators: checks took {time.perf_counter() - t_phase:.1f} s")

    # wall ms and peak device memory of one call, 256^3 and 512^3, f32
    grid512 = GridSpec.create(box_scale=BOX, nsamp=N_BIG, redshift=Z)
    for g, cube in ((grid, a), (grid512, realise_density(gen, grid512,
                                                         cosmo)[0])):
        timed = {
            "power_spectrum nmu=1": lambda: spectra.power_spectrum(g, cube),
            "power_spectrum nmu=5": lambda: spectra.power_spectrum(
                g, cube, nmu=5),
            "power_multipoles 0,2,4": lambda: spectra.power_multipoles(
                g, cube),
            "correlation_function": lambda: spectra.correlation_function(
                g, cube),
        }
        fn = make_sharded_power_spectrum(mesh, g, dtype=torch.float32,
                                         device=dev)
        timed["sharded power nmu=1 (one-rank mesh)"] = lambda: fn(cube)
        for what, call in timed.items():
            ms, peak = est_time(call)
            log(f"estimator time {g.N}^3 f32 {what}: {ms:.2f} ms per call "
                f"(median of {EST_REPS}), peak device memory {peak:.2f} GiB "
                "above the resident tensors")
        del fn, timed
    log(f"estimators: phase took {time.perf_counter() - t_phase:.1f} s")
    check(not failures, "estimators: " + "; ".join(failures))


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
    import torch.distributed as dist

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

    k8, launches, mesh = phase_sharded(dev, cosmo, grid, fn256)
    for r in [k7, k4t] + k8:
        r["launches"] = launches[r["name"]]
    cola = phase_cola(dev, k11)
    slab = phase_sharded_cola(dev, mesh)
    t0 = time.perf_counter()
    phase_foregrounds(dev, mesh)
    log(f"phase 8c: {time.perf_counter() - t0:.1f} s")
    dist.destroy_process_group()

    # The K10 route: the pipeline, then COLA, counted apart
    k10["launches"] = phase_route(dev, cosmo, grid, draws, cpu)
    phase_cola_route(dev, *cola)
    phase_gate(dev)
    kernels += [k4t] + k11 + slab + others + [k7] + k8 + [k10]
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
