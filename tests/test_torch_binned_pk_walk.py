"""K4/K4t's summation order (csrc/binned_pk_v2.cu), emulated in float64 on
the CPU, against the plain twin and fastbox_tpu.

The kernel walks the half spectrum by rows.  Where kz2h ascends, each bin
is one run of consecutive l per row: the row's first bin from the
thresholds, then each bin's end by bisection over kz2h.  Lane k sums
modes start + k + 32 t of a run in registers, a fixed butterfly adds the
32 lanes, warps add into their own rows of bins, blocks add their warps in
order, and a fixed tree adds the blocks.  Where kz2h does not ascend, each
mode is binned by bisection over the thresholds and the lanes of a chunk
are summed bin by bin.  The emulation repeats that order; the card's own
runs are in chip_smoke.py.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastbox_tpu.ops.pallas.binned_pk_v2 import binned_pk_half_dual_pallas_v2
from fastbox_tpu_torch.grid import GridSpec
from fastbox_tpu_torch.ops import spectra
from fastbox_tpu_torch.ops.cuda import _build
from fastbox_tpu_torch.ops.cuda import binned_pk_v2 as k4
from test_torch_binned_pk import cuda, port_args, setup  # noqa: F401
from test_torch_binned_pk_v2t import uniform_case

LANES = np.arange(32)


def warp_sum3(x, y, z):
    """The kernel's butterfly over 32 lanes: (sum x, sum y, sum z)."""
    hi16, hi8 = (LANES & 16) != 0, (LANES & 8) != 0
    k0, k1 = np.where(hi16, z, x), np.where(hi16, 0.0, y)
    k0 = k0 + np.where(hi16, x, z)[LANES ^ 16]
    k1 = k1 + np.where(hi16, y, 0.0)[LANES ^ 16]
    v = np.where(hi8, k1, k0)
    v = v + np.where(hi8, k0, k1)[LANES ^ 8]
    for off in (4, 2, 1):
        v = v + v[LANES ^ off]
    return v[0], v[8], v[16]


def row_runs(base, kz, thr):
    """The fast path's runs of one row, as (bin, first l, end l)."""
    H, nb = kz.size, thr.size
    b0 = int(np.count_nonzero(thr <= base + kz[0]))
    start, runs = 0, []
    while b0 < nb and start < H:
        # lane k: the end of bin b0 + k, bisected from `start`
        ends = [start + int(np.searchsorted(kz[start:], thr[b] - base))
                for b in range(b0, min(b0 + 32, nb))]
        for k, end in enumerate(ends):
            if start >= H:
                break
            if end != start:
                runs.append((b0 + k, start, end))
                start = end
        b0 += 32
    return runs


def lane_sums(w, a, c, first, end):
    """Each lane's in-order (sum w a, sum w a^2, sum w c) over l = first +
    lane + 32 t < end."""
    s = np.zeros((3, 32))
    for lane in range(32):
        for l in range(first + lane, end, 32):
            wx = w[l] * a[l]
            s[0, lane] += wx
            s[1, lane] += wx * a[l]
            s[2, lane] += w[l] * c[l]
    return s


def emulate(p1, p2, kx2, ky2, kz2h, wz, thr, telescoped=False):
    """The kernel's float64 sums (3, nbins), in its order."""
    Nx, Ny, H = p1.shape
    nb, rows = thr.size, Nx * Ny
    blocks, threads = k4._launch_shape(rows)
    nw = threads // 32
    per = math.ceil(rows / (blocks * nw))
    ascending = bool(np.all(kz2h[:-1] <= kz2h[1:]))
    a_rows, c_rows = p1.reshape(rows, H), p2.reshape(rows, H)
    w = wz.astype(np.float64)
    partial = np.zeros((blocks, 3, nb))
    for blk in range(blocks):
        acc = np.zeros((nw, 3, nb))
        for wp in range(nw):
            r0 = (blk * nw + wp) * per
            for r in range(r0, min(r0 + per, rows)):
                base = int(kx2[r // Ny]) + int(ky2[r % Ny])
                a, c = a_rows[r], c_rows[r]
                if ascending:
                    for b, first, end in row_runs(base, kz2h, thr):
                        acc[wp, :, b] += warp_sum3(*lane_sums(w, a, c, first,
                                                              end))
                    continue
                for l0 in range(0, H, 32):
                    l = l0 + LANES
                    live = l < H
                    lc = np.minimum(l, H - 1)
                    bins = np.where(live, np.searchsorted(
                        thr, base + kz2h[lc], side="right"), nb)
                    x = np.where(bins < nb, w[lc] * a[lc], 0.0)
                    y = np.where(bins < nb, x * a[lc], 0.0)
                    z = np.where(bins < nb, w[lc] * c[lc], 0.0)
                    pending = bins < nb
                    while pending.any():
                        bl = bins[np.flatnonzero(pending)[0]]
                        mine = bins == bl
                        acc[wp, :, bl] += warp_sum3(*(np.where(mine, t, 0.0)
                                                      for t in (x, y, z)))
                        pending &= ~mine
        s = np.zeros((3, nb))
        for wp in range(nw):
            s += acc[wp]
        if telescoped:
            s = np.stack([[sum_in_order(s[st, :e + 1]) for e in range(nb)]
                          for st in range(3)])
        partial[blk] = s
    total = np.zeros((3, nb))
    for st in range(3):
        for b in range(nb):
            total[st, b] = tree_sum(partial[:, st, b])
    if telescoped:
        total = total - np.concatenate([np.zeros((3, 1)), total[:, :-1]], 1)
    return total


def sum_in_order(v):
    s = 0.0
    for x in v:
        s += x
    return s


def tree_sum(v):
    """fbx::sum_partials_kernel: 256 strided in-order sums, then a tree."""
    sh = np.array([sum_in_order(v[t::256]) for t in range(256)])
    half = 128
    while half:
        sh[:half] += sh[half:2 * half]
        half //= 2
    return sh[0]


def plan(N, box=1e3, nbins=20):
    grid = GridSpec.create(box_scale=box, nsamp=N)
    fi2 = spectra._index_sq(grid)
    thr = spectra.kbin_thresholds(grid, spectra.default_kbins(grid, nbins))
    return grid, fi2, thr


@pytest.mark.parametrize("N", [16, 32, 15, 17])
def test_row_runs_are_bin_index_bins(N):
    """Every row's runs cover exactly the modes bin_index puts in bins
    below nbins, each in its own bin."""
    _, fi2, thr = plan(N)
    H = N // 2 + 1
    kz = fi2[:H]
    t = lambda a: torch.as_tensor(a, dtype=torch.int32)
    want = k4.bin_index(t(fi2), t(fi2), t(kz), t(thr)).reshape(N, N, H)
    for i in range(N):
        for j in range(N):
            got = np.full(H, thr.size)
            for b, first, end in row_runs(int(fi2[i]) + int(fi2[j]), kz, thr):
                assert first < end and np.all(got[first:end] == thr.size)
                got[first:end] = b
            np.testing.assert_array_equal(
                got, np.minimum(want[i, j].numpy(), thr.size))


@pytest.mark.parametrize("N", [16, 32, 15])
def test_call_sites_kz_ascends(N):
    """fi2[:H], the kz2h of every call site, ascends: the fast path's
    precondition."""
    _, fi2, _ = plan(N)
    kz = fi2[:N // 2 + 1]
    assert np.all(kz[:-1] <= kz[1:])


def test_warp_sum3_adds_every_lane():
    rng = np.random.default_rng(3)
    x, y, z = rng.uniform(1, 2, (3, 32))
    got = warp_sum3(x, y, z)
    np.testing.assert_allclose(got, [x.sum(), y.sum(), z.sum()], rtol=1e-15)


@pytest.mark.parametrize("telescoped", [False, True])
@pytest.mark.parametrize("N", [16, 32, 15])
def test_emulated_order_matches_twin(rng, N, telescoped):
    """The kernel's order within 1e-12 of the twin per populated bin, in
    float64.  The telescoped mode (on uniform powers) differences prefixes,
    which loses eps * prefix / bin in both: there the bound is 1e-12 of the
    bin's prefix, as in test_torch_binned_pk_v2t.py."""
    case = uniform_case(rng, N) if telescoped else setup(rng, N)
    p1, p2, fi2, thr, wz = case
    H = N // 2 + 1
    got = emulate(p1, p2, fi2, fi2, fi2[:H], wz, thr, telescoped)
    want = k4.binned_pk_half_dual_v2(*port_args(*case), telescoped=telescoped)
    for g, w_ in zip(got, want):
        w_ = w_.numpy()
        ok = w_ != 0
        assert np.all(g[~ok] == 0)
        if telescoped:
            assert np.all(np.abs(g - w_) <= 1e-12 * np.cumsum(w_))
        else:
            np.testing.assert_allclose(g[ok], w_[ok], rtol=1e-12)


@pytest.mark.parametrize("telescoped", [False, True])
@pytest.mark.parametrize("N", [16, 32])
def test_general_path_on_non_ascending_kz(rng, N, telescoped):
    """A kz2h that does not ascend (reversed) takes the general path; its
    order lies within 1e-12 of the twin, which agrees with fastbox_tpu's
    kernel in interpret mode on the same permuted lattice."""
    p1, p2, fi2, thr, wz = uniform_case(rng, N)
    H = N // 2 + 1
    kz = fi2[:H][::-1].copy()
    assert not np.all(kz[:-1] <= kz[1:])
    got = emulate(p1, p2, fi2, fi2, kz, wz, thr, telescoped)
    args = port_args(p1, p2, fi2, thr, wz)
    args = args[:4] + (torch.as_tensor(kz, dtype=torch.int32),) + args[5:]
    twin = k4.binned_pk_half_dual_v2(*args, telescoped=telescoped)
    f = lambda a: jnp.asarray(a, jnp.float64)
    jax_out = binned_pk_half_dual_pallas_v2(
        f(p1), f(p2), f(fi2), f(fi2), f(kz), f(wz),
        f(thr.astype(np.float64) - 0.5), telescoped=telescoped,
        interpret=True)
    for g, t_, j in zip(got, twin, jax_out):
        t_ = t_.numpy()
        bound = 1e-12 * (np.cumsum(t_) if telescoped else np.abs(t_))
        assert np.all(np.abs(g - t_) <= bound)
        np.testing.assert_allclose(t_, np.asarray(j), rtol=1e-12,
                                   atol=1e-12 * t_.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("telescoped", [False, True])
def test_kernel_general_path_matches_twin(cuda, rng, telescoped):  # noqa: F811
    p1, p2, fi2, thr, wz = uniform_case(rng, 64)
    a32 = port_args(p1, p2, fi2, thr, wz, cuda, torch.float32)
    a32 = a32[:4] + (a32[4].flip(0).contiguous(),) + a32[5:]
    a64 = (a32[0].double(), a32[1].double()) + a32[2:5] + (a32[5].double(),
                                                          a32[6])
    _build.reset_launch_counts()
    got = k4.binned_pk_half_dual_v2_cuda(*a32, telescoped=telescoped)
    again = k4.binned_pk_half_dual_v2_cuda(*a32, telescoped=telescoped)
    assert _build.launch_counts() == {k4.NAME_T if telescoped else k4.NAME: 2}
    ref = k4.binned_pk_half_dual_v2_plain(*a64, telescoped=telescoped)
    for g, r, a in zip(got, ref, again):
        full = r != 0
        rel = ((g.double() - r) / r)[full].abs().max().item()
        assert rel <= 1e-6 and torch.equal(g, a)
