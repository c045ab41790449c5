"""The slab paint's algorithm (K11a's slab mode, csrc/lattice_cic.cu),
emulated pass by pass in plain torch on the CPU and held bit for bit to its
twin, ``fields.lattice_cic.cic_paint_lattice_slab``.

The passes as the kernel runs them, on an array A of a count per bucket
(bucket L's at A[L + 1]) and a record (key, fractions) per particle:

1. count: each particle's floors, the band test fl in [lo - 1, hi], and
   one count on the bucket of its lower-corner cell L of the (S + 2H, N,
   N) buffer;
2. scan: A in place, exclusive, reduce then scan over tiles;
3. fill: each particle claims the next place of its bucket with an atomic
   on A[L + 1], in an arbitrary order (here a random permutation), and
   writes its record there; bucket L is then [A[L], A[L + 1]);
4. sort: each bucket by key, by insertion up to 32 records, beyond that as
   a bitmap of the keys' dense indices, each record's fractions read again
   at its source L - fl;
5. sum: each cell merges its 8 buckets c - e in ascending (o << 3) | e, o
   = key + corner, and sums the in-band terms as the twin nests its rolls
   (partial sums sy -> sx -> acc), every product and sum rounded as torch
   rounds it.

The cases: N in {12, 16}, S in {H, N}, B in {1, 2, 3}, float32 and
float64, unweighted and a C = 3 weight stack (against three single-channel
twins), on uniform displacements, displacements that cross the y/z wrap,
every particle of a region aimed at one cell (a bucket longer than 32:
the bitmap sort), integer displacements (fr = 0) and |d| > B.
"""
import numpy as np
import pytest
import torch

from fastbox_tpu_torch.fields import lattice_cic as twin

FL_BIAS = 32        # csrc/lattice_cic.cu kFlBias
SHORT = 32          # buckets sorted by one thread
TILE = 64           # counts per scan tile (the kernel's 4096; any splits)
NO_KEY = 2 ** 31 - 1
KINDS = ("uniform", "wrap", "cluster", "integer", "beyond")


@pytest.fixture(autouse=True)
def one_thread():
    """The emulation is thousands of small tensor operations: one intra-op
    thread, so that test workers sharing the cores do not contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def slab_disp(rng, kind: str, S: int, n: int, B: int) -> np.ndarray:
    """(3, S, n, n) float64 displacements of one case (cells)."""
    d = rng.uniform(-B, B, (3, S, n, n))
    y = np.arange(n)[None, :, None]
    z = np.arange(n)[None, None, :]
    if kind == "wrap":      # the rows and columns next to the y/z edges
        d[1] = np.where(y < B + 1, -rng.uniform(0.2, B, d[1].shape),
                        np.where(y >= n - B - 1,
                                 rng.uniform(0.2, B, d[1].shape), d[1]))
        d[2] = np.where(z < B + 1, -rng.uniform(0.2, B, d[2].shape),
                        np.where(z >= n - B - 1,
                                 rng.uniform(0.2, B, d[2].shape), d[2]))
    elif kind == "cluster":  # every particle within B + 1 of c lands in c
        c = (S // 2, 1, n - 1)   # next to both periodic edges
        site = [np.arange(S)[:, None, None], y, z]
        off = [np.broadcast_to(site[0] - c[0], (S, n, n))]
        off += [np.broadcast_to((s - ci + n // 2) % n - n // 2, (S, n, n))
                for s, ci in zip(site[1:], c[1:])]
        near = np.all([np.abs(o) <= B + 1 for o in off], axis=0)
        for ax in range(3):
            d[ax] = np.where(near, 0.3 - off[ax], d[ax])
    elif kind == "integer":
        d = rng.integers(-B, B + 1, d.shape).astype(np.float64)
    elif kind == "beyond":  # up to 2.5 cells past the band's reach
        d = rng.uniform(-B - 2.5, B + 2.5, d.shape)
    return d


def key_axis(k, ax: int):
    return ((k >> (12 - 6 * ax)) & 63) - FL_BIAS


def emulate(d, B: int, w=None, gen=None):
    """The kernel's passes on (dx, dy, dz) (S, N, N) and an optional
    (C, S, N, N) weight stack: (C, S + 2H, N, N), and the longest bucket."""
    S, N = d[0].shape[0], d[0].shape[-1]
    H, lo, hi = B + 1, -B, B + 1
    W = hi - lo + 2
    NX = S + 2 * H
    ncell = NX * N * N
    flat = [a.reshape(-1) for a in d]
    # 1. count
    f = torch.stack([torch.floor(a) for a in flat])
    fr = torch.stack(flat) - f
    ok = ((f >= lo - 1) & (f <= hi)).all(0)
    fl = torch.where(ok, f, 0).long()
    s, y, z = (t.reshape(-1) for t in torch.meshgrid(
        torch.arange(S), torch.arange(N), torch.arange(N), indexing="ij"))
    L = ((H + s + fl[0]) * N + (y + fl[1]) % N) * N + (z + fl[2]) % N
    key = ((fl[0] + FL_BIAS) << 12) | ((fl[1] + FL_BIAS) << 6) \
        | (fl[2] + FL_BIAS)
    counted = torch.nonzero(ok).reshape(-1)
    ntile = (ncell + TILE) // TILE
    count = torch.bincount(L[counted], minlength=ncell)
    A = torch.zeros(ntile * TILE, dtype=torch.long)
    A[1:ncell + 1] = count
    # 2. scan: the tiles' sums, their exclusive scan, each tile's own
    tiles = A.reshape(ntile, TILE)
    tile_sum = tiles.sum(1)
    A = ((torch.cumsum(tile_sum, 0) - tile_sum)[:, None]
         + torch.cumsum(tiles, 1) - tiles).reshape(-1)
    assert A[ncell] + count[-1] == len(counted)
    # 3. fill: the atomics in a random order
    order = counted[torch.randperm(len(counted), generator=gen)]
    grouped = order[torch.sort(L[order], stable=True).indices]
    first = torch.cumsum(count, 0) - count
    pos = A[L[grouped] + 1] + torch.arange(len(grouped)) - first[L[grouped]]
    rec_key = torch.full((len(counted) + 2,), -1, dtype=torch.long)
    rec_fr = torch.zeros((3, len(counted) + 2), dtype=d[0].dtype)
    rec_key[pos], rec_fr[:, pos] = key[grouped], fr[:, grouped]
    A = A[:ncell + 1]
    A[1:] += count              # each claim moved A[L + 1] on by one
    # 4. sort each bucket by key
    n = A[1:] - A[:-1]
    for b in torch.nonzero(n >= 2).reshape(-1).tolist():
        b0, b1 = A[b].item(), A[b + 1].item()
        seg = rec_key[b0:b1]
        if b1 - b0 <= SHORT:
            srt = torch.sort(seg).indices + b0
            rec_key[b0:b1], rec_fr[:, b0:b1] = rec_key[srt], rec_fr[:, srt]
            continue
        dense = ((key_axis(seg, 0) - lo + 1) * W + key_axis(seg, 1) - lo
                 + 1) * W + key_axis(seg, 2) - lo + 1
        bits = torch.zeros(W ** 3, dtype=torch.bool)
        bits[dense] = True
        assert int(bits.sum()) == b1 - b0, "keys repeat within a bucket"
        back = torch.nonzero(bits).reshape(-1)
        fb = (back // (W * W) + lo - 1, back // W % W + lo - 1,
              back % W + lo - 1)
        rec_key[b0:b1] = (((fb[0] + FL_BIAS) << 12) | ((fb[1] + FL_BIAS) << 6)
                          | (fb[2] + FL_BIAS))
        cx, cy, cz = b // (N * N), b // N % N, b % N
        g = ((cx - H - fb[0]) * N + (cy - fb[1]) % N) * N + (cz - fb[2]) % N
        rec_fr[:, b0:b1] = torch.stack([a[g] - torch.floor(a[g])
                                        for a in flat])
    # 5. sum: every cell's 8 buckets in ascending (o << 3) | e, in lockstep
    X, Yc, Zc = (t.reshape(-1) for t in torch.meshgrid(
        torch.arange(NX), torch.arange(N), torch.arange(N), indexing="ij"))
    corner = torch.tensor([((e >> 2) << 12) | (((e >> 1) & 1) << 6)
                           | (e & 1) for e in range(8)])
    at, end = [], []
    for e in range(8):
        bx = X - (e >> 2)
        Lc = (bx.clamp(min=0) * N + (Yc - ((e >> 1) & 1)) % N) * N \
            + (Zc - (e & 1)) % N
        at.append(torch.where(bx >= 0, A[Lc], 0))
        end.append(torch.where(bx >= 0, A[Lc + 1], 0))
    at, end = torch.stack(at, 1), torch.stack(end, 1)
    eight = torch.arange(8)
    head = torch.where(at < end, ((rec_key[at] + corner) << 3) | eight,
                       NO_KEY)
    wf = None if w is None else w.reshape(w.shape[0], -1)
    C = 1 if w is None else w.shape[0]
    acc, sx, sy = (torch.zeros((C, ncell), dtype=d[0].dtype)
                   for _ in range(3))
    cur_ox = torch.full((ncell,), lo - 2)
    cur_oy = cur_ox.clone()
    live = torch.nonzero((head != NO_KEY).any(1)).reshape(-1)
    while len(live):   # one entry of every cell not yet done
        p, e = head[live].min(1)
        a = at[live, e]
        at[live, e] = a + 1
        head[live, e] = torch.where(
            a + 1 < end[live, e], ((rec_key[a + 1] + corner[e]) << 3) | e,
            NO_KEY)
        o = [key_axis(p >> 3, ax) for ax in range(3)]
        inb = torch.stack([(oa >= lo) & (oa <= hi) for oa in o]).all(0)
        wx, wy, wz = (torch.where(((e >> (2 - ax)) & 1) == 1, rec_fr[ax, a],
                                  1 - rec_fr[ax, a]) for ax in range(3))
        newx = inb & (o[0] != cur_ox[live])
        newy = inb & ~newx & (o[1] != cur_oy[live])
        sxl, syl, accl = sx[:, live], sy[:, live], acc[:, live]
        flushed = sxl + syl
        acc[:, live] = torch.where(newx, accl + flushed, accl)
        sxl = torch.where(newx, 0.0, torch.where(newy, flushed, sxl))
        syl = torch.where(newx | newy, 0.0, syl)
        cur_ox[live] = torch.where(newx, o[0], cur_ox[live])
        cur_oy[live] = torch.where(newx | newy, o[1], cur_oy[live])
        src = ((X[live] - H - o[0]) * N + (Yc[live] - o[1]) % N) * N \
            + (Zc[live] - o[2]) % N
        px = wx[None] if wf is None else wx * wf[:, torch.where(inb, src, 0)]
        sx[:, live] = sxl
        sy[:, live] = torch.where(inb, syl + px * wy * wz, syl)
        live = live[(head[live] != NO_KEY).any(1)]
    sx = sx + sy
    acc = acc + sx
    return acc.reshape(C, NX, N, N), int(n.max())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
@pytest.mark.parametrize("B", (1, 2, 3))
@pytest.mark.parametrize("n, slab", ((12, "min"), (12, "cube"), (16, "min"),
                                     (16, "cube")))
def test_emulated_passes_equal_the_slab_twin(n, slab, B, dtype, kind):
    S = B + 1 if slab == "min" else n
    seed = [n, S, B, KINDS.index(kind), int(dtype == torch.float64)]
    rng = np.random.default_rng(seed)
    d = tuple(torch.as_tensor(a, dtype=dtype).contiguous()
              for a in slab_disp(rng, kind, S, n, B))
    w = torch.as_tensor(rng.standard_normal((3, S, n, n)), dtype=dtype)
    gen = torch.Generator().manual_seed(int(rng.integers(2 ** 31)))
    got, longest = emulate(d, B, gen=gen)
    assert torch.equal(got[0], twin.cic_paint_lattice_slab(d, B))
    got3, _ = emulate(d, B, w, gen=gen)
    for c in range(3):
        assert torch.equal(got3[c], twin.cic_paint_lattice_slab(d, B, w[c]))
    if kind == "cluster":   # the warp's bitmap sort ran
        assert longest > SHORT
