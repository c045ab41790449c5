"""K5/K6's walk (csrc/binned_pk.cu), emulated on the CPU, against the
plain twins (which test_torch_binned_pk_v1.py holds to fastbox_tpu).

The kernels walk the spectrum by rows (i, j).  k2(l) = kx2 + (ky2 +
kz2[l]), each add rounded in the dtype, is non-decreasing wherever kz2 is,
so along a monotone segment of a row each bin is one run of consecutive l:
K5's segment is [0, H), K6's are [0, S) and [S, Nz) walked from its end,
S = Nz // 2 + 1.  Per segment the first mode's bin comes from the edges,
then lane k bisects for the end of bin b0 + k on k2 itself.  Lane k sums
modes start + k + 32 t of a run in float64, a fixed butterfly adds the 32
lanes, warps add into their own rows of bins, blocks add their warps in
order, and a fixed tree adds the blocks.  Where kz2 breaks the segment
rule, or a row's kx2 or ky2 is not finite, each mode is binned by
bisection over the edges and the lanes of a chunk are summed bin by bin.
The emulation repeats that order; the card's own runs are in
chip_smoke.py.
"""
import math

import numpy as np
import pytest
import torch

from fastbox_tpu_torch.grid import GridSpec
from fastbox_tpu_torch.ops import spectra
from fastbox_tpu_torch.ops.cuda import _build
from fastbox_tpu_torch.ops.cuda import binned_pk as k5
from test_torch_binned_pk_v1 import BOXES, cuda, physical_plan  # noqa: F401
from test_torch_binned_pk_walk import LANES, tree_sum, warp_sum3

DTYPES = [torch.float32, torch.float64]
PLANS = ["aniso physical", "cube kbin_plan"]


def warp_sum4(x, y, z, w):
    """fbx::warp_sum4 over 32 lanes: (sum x, sum y, sum z, sum w)."""
    hi16, hi8 = (LANES & 16) != 0, (LANES & 8) != 0
    k0, k1 = np.where(hi16, z, x), np.where(hi16, w, y)
    k0 = k0 + np.where(hi16, x, z)[LANES ^ 16]
    k1 = k1 + np.where(hi16, y, w)[LANES ^ 16]
    v = np.where(hi8, k1, k0)
    v = v + np.where(hi8, k0, k1)[LANES ^ 8]
    for off in (4, 2, 1):
        v = v + v[LANES ^ off]
    return v[0], v[8], v[16], v[24]


def warp_sum2(x, y):
    """fbx::warp_sum2 over 32 lanes: (sum x, sum y)."""
    hi16 = (LANES & 16) != 0
    v = np.where(hi16, y, x)
    v = v + np.where(hi16, x, y)[LANES ^ 16]
    for off in (8, 4, 2, 1):
        v = v + v[LANES ^ off]
    return v[0], v[16]


def plan(name, N, dtype):
    """(kx2, ky2, kz2 over the full axis, edges2) as numpy arrays."""
    if name == "aniso physical":
        grid = GridSpec.create(box_scale=BOXES["aniso"], nsamp=N)
        ops = physical_plan(grid, dtype)
    else:
        grid = GridSpec.create(box_scale=BOXES["cube"], nsamp=N)
        ops = spectra.kbin_plan(grid, spectra.default_kbins(grid, 20), dtype)
    return tuple(t.numpy() for t in ops)


def segments(L, full):
    """A row's monotone segments, as positions l in walk order."""
    if not full:
        return [np.arange(L)]
    S = L // 2 + 1
    return [np.arange(S), np.arange(L - 1, S - 1, -1)]


def fast_rule(kz, full):
    """The kernels' device check: kz2 finite and ascending along each
    segment in walk order."""
    return bool(np.all(np.isfinite(kz))) and all(
        np.all(kz[s[:-1]] <= kz[s[1:]]) for s in segments(kz.size, full))


def bisect_lanes(k2, start, edges):
    """Each lane's bisection: the first t >= start with not k2[t] <
    edges[lane] (k2.size if none)."""
    lo = np.full(edges.size, start)
    hi = np.full(edges.size, k2.size)
    while np.any(lo < hi):
        live = lo < hi
        mid = (lo + hi) >> 1
        below = k2[np.minimum(mid, k2.size - 1)] < edges
        lo = np.where(live & below, mid + 1, lo)
        hi = np.where(live & ~below, mid, hi)
    return lo


def segment_runs(kx, ky, kz, seg, edges):
    """The fast path's runs on one segment, as (bin, first t, end t)."""
    k2 = kx + (ky + kz[seg])
    nb, n = edges.size, seg.size
    b0 = int(np.count_nonzero(~(k2[0] < edges)))
    start, runs = 0, []
    while b0 < nb and start < n:
        for k, end in enumerate(bisect_lanes(k2, start, edges[b0:b0 + 32])):
            if start >= n:
                break
            if end != start:
                runs.append((b0 + k, start, int(end)))
                start = int(end)
        b0 += 32
    return runs


def lane_sum(v):
    """Each lane's in-order sum of a (chunks, 32) array."""
    s = np.zeros(32)
    for row in v:
        s = s + row
    return s


def run_sums(a, c, w, pos, full):
    """One run's butterfly sums: lane k adds positions pos[k + 32 t]."""
    idx = np.concatenate([pos, np.full(-pos.size % 32, -1)]).reshape(-1, 32)
    live = idx >= 0
    p = np.where(live, a[idx], 0.0)
    if full:
        return np.array([*warp_sum2(lane_sum(p), lane_sum(p * p)),
                         pos.size])
    wl = np.where(live, w[idx], 0.0)
    wp = wl * p
    return np.array(warp_sum4(lane_sum(wp), lane_sum(wp * p),
                              lane_sum(wl * np.where(live, c[idx], 0.0)),
                              lane_sum(wl)))


def general_row(acc, a, c, w, k2, edges, full):
    """The general path on one row: per chunk of 32 modes, bin by bin in
    order of each bin's lowest lane."""
    L, nb = k2.size, edges.size
    for l0 in range(0, L, 32):
        l = np.minimum(l0 + LANES, L - 1)
        bins = np.where(l0 + LANES < L,
                        np.searchsorted(edges, k2[l], side="right"), nb)
        keep = bins < nb
        p = a[l]
        if full:
            terms = (p, p * p)
        else:
            wp = w[l] * p
            terms = (wp, wp * p, w[l] * c[l], w[l])
        terms = [np.where(keep, t, 0.0) for t in terms]
        while keep.any():
            bl = bins[np.flatnonzero(keep)[0]]
            mine = bins == bl
            sel = [np.where(mine, t, 0.0) for t in terms]
            if full:
                acc[:2, bl] += warp_sum2(*sel)
                acc[2, bl] += np.count_nonzero(mine)
            else:
                acc[:, bl] += warp_sum4(*sel)
            keep &= ~mine


def emulate(fields, kx2, ky2, kz, wz, edges, full):
    """The kernel's float64 sums (3 or 4, nbins), in its order."""
    Nx, Ny, L = fields[0].shape
    rows, nb, nst = Nx * Ny, edges.size, 3 if full else 4
    blocks, threads = k5._launch_shape(rows)
    nw = threads // 32
    per = math.ceil(rows / (blocks * nw))
    fast = fast_rule(kz, full)
    a_rows = fields[0].reshape(rows, L).astype(np.float64)
    c_rows = a_rows if full else fields[1].reshape(rows, L).astype(np.float64)
    w = None if full else wz.astype(np.float64)
    partial = np.zeros((blocks, nst, nb))
    for blk in range(blocks):
        acc = np.zeros((nw, nst, nb))
        for wp in range(nw):
            r0 = (blk * nw + wp) * per
            for r in range(r0, min(r0 + per, rows)):
                kx, ky = kx2[r // Ny], ky2[r % Ny]
                a, c = a_rows[r], c_rows[r]
                if fast and np.isfinite(kx) and np.isfinite(ky):
                    for seg in segments(L, full):
                        for b, first, end in segment_runs(kx, ky, kz, seg,
                                                          edges):
                            acc[wp, :, b] += run_sums(a, c, w,
                                                      seg[first:end], full)
                else:
                    general_row(acc[wp], a, c, w, kx + (ky + kz), edges, full)
        s = np.zeros((nst, nb))
        for wp in range(nw):
            s += acc[wp]
        partial[blk] = s
    return np.array([[tree_sum(partial[:, st, b]) for b in range(nb)]
                     for st in range(nst)])


def twin(fields, kx2, ky2, kz, wz, edges, full):
    t = torch.as_tensor
    if full:
        out = k5.binned_pk_full(t(fields[0]), t(kx2), t(ky2), t(kz), t(edges))
    else:
        out = k5.binned_pk_half_dual(t(fields[0]), t(fields[1]), t(kx2),
                                     t(ky2), t(kz), t(wz), t(edges))
    return np.stack([o.numpy() for o in out])


def inputs(rng, N, full, dtype=np.float64):
    """Powers spanning ~6 decades like |delta_k|^2, and K5's weights."""
    H = N // 2 + 1
    L = N if full else H
    fields = [np.exp(3.0 * rng.standard_normal((N, N, L))).astype(dtype)
              for _ in range(1 if full else 2)]
    wz = np.full(H, 2.0, dtype)
    wz[0] = wz[-1] = 1.0
    return fields, wz


@pytest.mark.parametrize("full", [False, True], ids=["K5", "K6"])
@pytest.mark.parametrize("N", [16, 32, 15, 17])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("which", PLANS)
def test_segment_runs_are_bin_index_sq_bins(which, dtype, N, full):
    """Every row's runs, per monotone segment, cover exactly the modes
    bin_index_sq puts in bins below nbins, each in its own bin."""
    kx2, ky2, kz2, e2 = plan(which, N, dtype)
    kz = kz2 if full else kz2[:N // 2 + 1].copy()
    assert fast_rule(kz, full)
    nb = e2.size
    t = torch.as_tensor
    want = k5.bin_index_sq(t(kx2), t(ky2), t(kz), t(e2)).reshape(N, N, -1)
    got = np.full(want.shape, nb)
    for i in range(N):
        for j in range(N):
            for seg in segments(kz.size, full):
                for b, first, end in segment_runs(kx2[i], ky2[j], kz, seg,
                                                  e2):
                    ls = seg[first:end]
                    assert first < end and np.all(got[i, j, ls] == nb)
                    got[i, j, ls] = b
    np.testing.assert_array_equal(got, np.minimum(want.numpy(), nb))


@pytest.mark.parametrize("N", [16, 32, 15, 17, 64, 63])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("which", PLANS)
def test_call_sites_follow_the_segment_rule(which, dtype, N):
    """kbin_plan's kz2 (the K6 estimator's) is in FFT order and its first
    N // 2 + 1 entries (the pipeline's kz2h for K5) ascend: the fast
    paths' preconditions, on the physical plan of any box as well."""
    _, _, kz2, _ = plan(which, N, dtype)
    assert fast_rule(kz2, full=True)
    assert fast_rule(kz2[:N // 2 + 1].copy(), full=False)
    assert not fast_rule(kz2, full=False)


@pytest.mark.parametrize("full", [False, True], ids=["K5", "K6"])
@pytest.mark.parametrize("N", [16, 32, 15])
@pytest.mark.parametrize("which", PLANS)
def test_emulated_order_matches_twin(rng, which, N, full):
    """The kernel's order within 1e-12 of the twin per populated bin in
    float64; the count (K6) and the weighted count (K5) exactly."""
    kx2, ky2, kz2, e2 = plan(which, N, torch.float64)
    fields, wz = inputs(rng, N, full)
    kz = kz2 if full else kz2[:N // 2 + 1].copy()
    got = emulate(fields, kx2, ky2, kz, wz, e2, full)
    want = twin(fields, kx2, ky2, kz, wz, e2, full)
    np.testing.assert_array_equal(got[-1], want[-1])
    ok = want[-1] != 0
    assert np.all(got[:, ~ok] == 0)
    np.testing.assert_allclose(got[:, ok], want[:, ok], rtol=1e-12)


@pytest.mark.parametrize("full", [False, True], ids=["K5", "K6"])
@pytest.mark.parametrize("N", [16, 17])
def test_general_path_on_a_broken_rule(rng, N, full):
    """A reversed kz2h (K5) or a permuted kz2 (K6) fails the segment rule
    and takes the general path; its order lies within 1e-12 of the twin,
    counts exact.  (The twin bins by searchsorted in any order; it is held
    to fastbox_tpu in test_torch_binned_pk_v1.py.)"""
    kx2, ky2, kz2, e2 = plan("aniso physical", N, torch.float64)
    fields, wz = inputs(rng, N, full)
    kz = rng.permutation(kz2) if full else kz2[:N // 2 + 1][::-1].copy()
    assert not fast_rule(kz, full)
    got = emulate(fields, kx2, ky2, kz, wz, e2, full)
    want = twin(fields, kx2, ky2, kz, wz, e2, full)
    np.testing.assert_array_equal(got[-1], want[-1])
    ok = want[-1] != 0
    np.testing.assert_allclose(got[:, ok], want[:, ok], rtol=1e-12)


@pytest.mark.parametrize("full", [False, True], ids=["K5", "K6"])
def test_rows_with_non_finite_wavenumbers_take_the_general_path(rng, full):
    """A row whose kx2 is inf or NaN bins its modes past the last edge,
    as the twin's searchsorted does; the other rows keep the fast path."""
    N = 16
    kx2, ky2, kz2, e2 = plan("aniso physical", N, torch.float64)
    kx2 = kx2.copy()
    kx2[3], kx2[5] = np.inf, np.nan
    fields, wz = inputs(rng, N, full)
    kz = kz2 if full else kz2[:N // 2 + 1].copy()
    got = emulate(fields, kx2, ky2, kz, wz, e2, full)
    want = twin(fields, kx2, ky2, kz, wz, e2, full)
    np.testing.assert_array_equal(got[-1], want[-1])
    ok = want[-1] != 0
    np.testing.assert_allclose(got[:, ok], want[:, ok], rtol=1e-12)


def test_butterflies_add_every_lane_and_k4_keeps_its_bits():
    """warp_sum4 with w = 0 is K4's three-value butterfly bit for bit (K4
    calls it so), and warp_sum2 adds its two values' lanes."""
    rng = np.random.default_rng(3)
    x, y, z, w = rng.uniform(1, 2, (4, 32)) * 10.0 ** rng.integers(-8, 8,
                                                                   (4, 32))
    four = warp_sum4(x, y, z, np.zeros(32))
    assert four[:3] == warp_sum3(x, y, z) and four[3] == 0.0
    np.testing.assert_allclose(warp_sum4(x, y, z, w),
                               [v.sum() for v in (x, y, z, w)], rtol=1e-15)
    np.testing.assert_allclose(warp_sum2(x, y), [x.sum(), y.sum()],
                               rtol=1e-15)


def kernel_held(got, again, ref, counted):
    """The kernel against its f64 twin per populated bin, the count
    exactly, bitwise repeatable, launched as counted."""
    assert _build.launch_counts() == counted
    assert torch.equal(got[-1].double(), ref[-1])
    for g, r, a in zip(got, ref, again):
        full = r != 0
        assert ((g.double() - r) / r)[full].abs().max().item() <= 1e-6
        assert torch.equal(g, a)


def launcher(full, dev, fields, kx2, ky2, kz, wz, e2):
    """K6 (full) or K5 on the card, as a call without arguments."""
    t = lambda a: torch.as_tensor(a, device=dev)
    if full:
        return lambda: k5.binned_pk_full_cuda(t(fields[0]), t(kx2), t(ky2),
                                              t(kz), t(e2))
    return lambda: k5.binned_pk_half_dual_cuda(
        t(fields[0]), t(fields[1]), t(kx2), t(ky2), t(kz), t(wz), t(e2))


def kernel_held(full, dev, fields, kx2, ky2, kz, wz, e2):
    """The kernel against its f64 twin per populated bin within 1e-6, the
    count exactly, bitwise repeatable, launched as counted."""
    run = launcher(full, dev, fields, kx2, ky2, kz, wz, e2)
    _build.reset_launch_counts()
    got, again = run(), run()
    assert _build.launch_counts() == {k5.NAME_FULL if full else k5.NAME: 2}
    ref = torch.as_tensor(twin([f.astype(np.float64) for f in fields], kx2,
                               ky2, kz, wz.astype(np.float64), e2, full),
                          device=dev)
    assert torch.equal(got[-1].double(), ref[-1])
    for g, r, a in zip(got, ref, again):
        full_bins = r != 0
        rel = ((g.double() - r) / r)[full_bins].abs().max().item()
        assert rel <= 1e-6 and torch.equal(g, a)


@pytest.mark.cuda
@pytest.mark.parametrize("full", [False, True], ids=["K5", "K6"])
def test_kernel_general_path_matches_twin(cuda, rng, full):  # noqa: F811
    N = 64
    kx2, ky2, kz2, e2 = plan("aniso physical", N, torch.float32)
    fields, wz = inputs(rng, N, full, np.float32)
    kz = rng.permutation(kz2) if full else kz2[:N // 2 + 1][::-1].copy()
    kernel_held(full, cuda, fields, kx2, ky2, kz, wz, e2)


@pytest.mark.cuda
@pytest.mark.parametrize("full", [False, True], ids=["K5", "K6"])
def test_kernel_on_an_odd_cube_matches_twin(cuda, rng, full):  # noqa: F811
    N = 63
    kx2, ky2, kz2, e2 = plan("cube kbin_plan", N, torch.float32)
    fields, wz = inputs(rng, N, full, np.float32)
    wz[-1] = 2.0   # odd N: the last plane is interior
    kz = kz2 if full else kz2[:N // 2 + 1].copy()
    kernel_held(full, cuda, fields, kx2, ky2, kz, wz, e2)
