"""K11a's periodic paint (csrc/lattice_cic.cu ``paint_kernel``), emulated
block by block in plain torch on the CPU and held bit for bit to its twin,
``fields.lattice_cic.cic_paint_lattice``.

The kernel's blocks each own a face of FY x FZ cells (y, z) and a run of
RUN cell planes (x), and march down x over the source planes s that reach
the run, s from X0 + R - 1 - lo down to X0 - hi.  At each step:

1. stage and push: every source of the plane s, the face grown by the band
   (periodic in x, y and z), that paints (every floor fl in [lo - 1, hi])
   stages its eight corner terms ((wx w) wy) wz, corner e at 4 ex + 2 ey +
   ez, and its corner base 7 - 4 fx - 2 fy - fz (f = fl - lo + 1); each of
   its corners e whose cell L + e lies in the face and whose plane in the
   run, with the offset o = fl + e in the band, sets the bit (oy - lo) D +
   (oz - lo) (D = hi - lo + 1) of that cell's mask for the target kx = ox
   - lo, and the bit kx of the cell's word of live targets, atomicOr's in
   any order (here a random permutation);
2. sum: each cell walks its live targets' masks, each in ascending bit
   order,
   reads the term of the source c - o at 4 kx + 2 (oy - lo) + (oz - lo) +
   its base, nests the terms as the twin nests its rolls (sy over oz, sx
   over oy), adds sx to the target plane's sum in a ring of D slots, and
   writes the plane X = s + hi, which is then complete.

Marching down in s gives every cell its ox ascending, the twin's outer
order.  The cases: N in {12, 16}, B in {1, 2, 3}, the open and the closed
band, float32 and float64, unweighted and weighted; uniform displacements,
displacements across the periodic wrap, every particle of a region aimed at
one cell (the deepest masks: many sources in one cell), integer
displacements (fr = 0) and |d| > B.  The kernel's geometry (16 x 32 faces,
32-plane runs: one block at these N, every staged row and lane wrapped) and
a small one (several blocks, ragged faces and runs).
"""
import numpy as np
import pytest
import torch

from fastbox_tpu_torch.fields import lattice_cic as twin

KERNEL = (16, 32, 32)      # csrc/lattice_cic.cu: face rows, kFaceZ, kRun
SMALL = (2, 8, 5)          # several blocks a side, ragged at N = 12, 16
KINDS = ("uniform", "wrap", "cluster", "integer", "beyond")


@pytest.fixture(autouse=True)
def one_thread():
    """The emulation is thousands of small tensor operations: one intra-op
    thread, so that test workers sharing the cores do not contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lattice_disp(rng, kind: str, n: int, B: int) -> np.ndarray:
    """(3, n, n, n) float64 displacements of one case (cells)."""
    d = rng.uniform(-B, B, (3, n, n, n))
    site = np.arange(n)
    if kind == "wrap":      # the planes next to every periodic edge
        for ax in range(3):
            s = site.reshape([n if i == ax else 1 for i in range(3)])
            d[ax] = np.where(s < B + 1, -rng.uniform(0.2, B, d[ax].shape),
                             np.where(s >= n - B - 1,
                                      rng.uniform(0.2, B, d[ax].shape),
                                      d[ax]))
    elif kind == "cluster":  # every particle within B + 1 of c lands in c
        c = (n // 2, 1, n - 1)   # next to two periodic edges
        off = [((site.reshape([n if i == ax else 1 for i in range(3)]) - c[ax]
                 + n // 2) % n - n // 2) for ax in range(3)]
        off = [np.broadcast_to(o, (n, n, n)) for o in off]
        near = np.all([np.abs(o) <= B + 1 for o in off], axis=0)
        for ax in range(3):
            d[ax] = np.where(near, 0.3 - off[ax], d[ax])
    elif kind == "integer":
        d = rng.integers(-B, B + 1, d.shape).astype(np.float64)
    elif kind == "beyond":  # up to 2.5 cells past the band's reach
        d = rng.uniform(-B - 2.5, B + 2.5, d.shape)
    return d


def emulate(d, B: int, openband: bool, w, geometry, gen):
    """The kernel's blocks and steps on (dx, dy, dz) (N, N, N) and weights
    w: the unweighted and the weighted paint, (2, N, N, N)."""
    fy, fz, run = geometry
    N = d[0].shape[0]
    lo, hi = -B, (B if openband else B + 1)
    span = hi - lo
    D = span + 1
    nw = (D * D + 31) // 32
    PY, PZ = fy + span, fz + span
    dt = d[0].dtype
    flat = [a.reshape(-1) for a in d] + [w.reshape(-1)]
    bx, by, bz = torch.meshgrid(torch.arange(-(-N // run)),
                                torch.arange(-(-N // fy)),
                                torch.arange(-(-N // fz)), indexing="ij")
    X0, y0, z0 = bx.reshape(-1) * run, by.reshape(-1) * fy, bz.reshape(-1) * fz
    nb = X0.numel()
    R = torch.clamp(N - X0, max=run)
    # staged rows and lanes of each block, wrapped
    ys = (y0[:, None] - hi + torch.arange(PY)) % N            # (nb, PY)
    zs = (z0[:, None] - hi + torch.arange(PZ)) % N            # (nb, PZ)
    rr = torch.arange(PY)[None, :, None].expand(nb, PY, PZ)
    qq = torch.arange(PZ)[None, None, :].expand(nb, PY, PZ)
    bb = torch.arange(nb)[:, None, None].expand(nb, PY, PZ)
    ty = torch.arange(fy)[None, None, :, None]                # cell rows
    tz = torch.arange(fz)[None, None, None, :]                # cell lanes
    kk = torch.arange(D)
    acc = torch.zeros((2, nb, D, fy, fz), dtype=dt)
    out = torch.full((2, N, N, N), float("nan"), dtype=dt)
    written = torch.zeros((N, N, N), dtype=torch.long)
    base = (R - 1) % D
    for t in range(int(R.max()) + span):
        s = X0 + R - 1 - lo - t                               # (nb,)
        active = s >= X0 - hi
        g = ((s % N)[:, None, None] * N + ys[:, :, None]) * N + zs[:, None, :]
        v = [a[g] for a in flat]                              # (nb, PY, PZ)
        # 1. stage and push
        f = [torch.floor(a) for a in v[:3]]
        fr = [a - fa for a, fa in zip(v[:3], f)]
        ok = torch.ones_like(f[0], dtype=torch.bool)
        fl = []
        for fa in f:
            ok = ok & (fa >= lo - 1) & (fa <= hi)
            fl.append(torch.where(ok, fa, 0).long())
        fi = [a - lo + 1 for a in fl]
        cbase = 7 - 4 * fi[0] - 2 * fi[1] - fi[2]              # (nb, PY, PZ)
        wts = [[1 - a, a] for a in fr]
        px = [torch.stack([wx, wx * v[3]]) for wx in wts[0]]  # unweighted,
        terms = torch.stack([(px[e >> 2] * wts[1][(e >> 1) & 1])  # weighted
                             * wts[2][e & 1] for e in range(8)], 1)
        pushes = []
        for e in range(8):
            ex, ey, ez = e >> 2, (e >> 1) & 1, e & 1
            ox, oy, oz = fl[0] + ex, fl[1] + ey, fl[2] + ez
            cy, cz = rr - hi + oy, qq - hi + oz
            X = s[:, None, None] + ox
            sel = (ok & active[:, None, None]
                   & (ox >= lo) & (ox <= hi) & (X >= X0[:, None, None])
                   & (X < (X0 + R)[:, None, None])
                   & (oy >= lo) & (oy <= hi) & (cy >= 0) & (cy < fy)
                   & (oz >= lo) & (oz <= hi) & (cz >= 0) & (cz < fz))
            bit = (oy - lo) * D + oz - lo
            pushes.append(torch.stack([bb[sel], (ox - lo)[sel], cy[sel],
                                       cz[sel], bit[sel]]))
        pushes = torch.cat(pushes, 1)
        pushes = pushes[:, torch.randperm(pushes.shape[1], generator=gen)]
        b_, k_, cy_, cz_, bit_ = pushes
        cell_bit = (((b_ * D + k_) * fy + cy_) * fz + cz_) * D * D + bit_
        assert cell_bit.unique().numel() == cell_bit.numel(), \
            "a mask bit set twice"
        words = torch.zeros((nb, D, nw, fy, fz), dtype=torch.long)
        words.index_put_((b_, k_, bit_ >> 5, cy_, cz_), 1 << (bit_ & 31),
                         accumulate=True)             # distinct bits: or
        live = torch.zeros((nb, D, fy, fz), dtype=torch.bool)
        live[b_, k_, cy_, cz_] = True  # each cell's words of live targets
        bits = ((words[:, :, torch.arange(D * D) >> 5]
                 >> (torch.arange(D * D) & 31)[:, None, None]) & 1) == 1
        bits = bits.permute(0, 1, 3, 4, 2)                    # (.., D*D)
        # 2. sum each target's bits in ascending order
        X = s[:, None] + lo + kk                              # (nb, D)
        inrun = (X >= X0[:, None]) & (X < (X0 + R)[:, None]) \
            & active[:, None]
        assert torch.equal(live, bits.any(-1)), "a live bit without a mask"
        assert not bool((live & ~inrun[:, :, None, None]).any())
        bits = bits & live[..., None]
        count = bits.sum(-1)
        order = torch.where(bits, torch.arange(D * D), D * D).sort(-1).values
        sx = torch.zeros((2, nb, D, fy, fz), dtype=dt)
        sy = torch.zeros_like(sx)
        cur = torch.full((nb, D, fy, fz), -1)
        for j in range(int(count.max()) if count.numel() else 0):
            on = j < count
            bit = torch.where(on, order[..., j], 0)
            oyi, ozi = bit // D, bit % D
            r = ty + span - oyi
            q = tz + span - ozi
            src = (torch.arange(nb)[:, None, None, None], r, q)
            e = kk[None, :, None, None] * 4 + 2 * oyi + ozi + cbase[src]
            assert bool(((e >= 0) & (e < 8))[on].all())
            term = terms[(slice(None), e.clamp(0, 7)) + src]
            new = on & (oyi != cur)
            sx = torch.where(new, sx + sy, sx)
            sy = torch.where(new, 0.0, sy)
            cur = torch.where(new, oyi, cur)
            sy = torch.where(on, sy + term, sy)
        slot = (base[:, None] + kk) % D                       # (nb, D)
        idx = slot[None, :, :, None, None].expand_as(acc)
        mine = acc.gather(2, idx)
        mine = torch.where(count > 0, mine + (sx + sy), mine)
        # the plane X = s + hi is complete
        Xf = X[:, span]
        for b in torch.nonzero(inrun[:, span]).reshape(-1).tolist():
            yy = y0[b] + torch.arange(fy)
            zz = z0[b] + torch.arange(fz)
            ry, rz = yy < N, zz < N
            blk = mine[:, b, span][:, ry][:, :, rz]
            out[:, Xf[b], yy[ry][:, None], zz[rz][None, :]] = blk
            written[Xf[b], yy[ry][:, None], zz[rz][None, :]] += 1
        mine[:, :, span] = torch.where(inrun[None, :, span, None, None], 0.0,
                                       mine[:, :, span])
        acc.scatter_(2, idx, mine)
        base = (base - 1) % D
    assert bool((written == 1).all()), "a cell written other than once"
    return out


def lattice_case(n: int, B: int, openband: bool, dtype, kind: str):
    seed = [n, B, int(openband), KINDS.index(kind),
            int(dtype == torch.float64)]
    rng = np.random.default_rng(seed)
    d = tuple(torch.as_tensor(a, dtype=dtype).contiguous()
              for a in lattice_disp(rng, kind, n, B))
    w = torch.as_tensor(rng.standard_normal((n, n, n)), dtype=dtype)
    gen = torch.Generator().manual_seed(int(rng.integers(2 ** 31)))
    return d, w, gen


def deepest_cell(d, B: int, openband: bool) -> int:
    """The most painting sources whose lower corner is one cell."""
    lo, hi = -B, (B if openband else B + 1)
    n = d[0].shape[0]
    f = [torch.floor(a).long() for a in d]
    ok = torch.stack([(a >= lo - 1) & (a <= hi) for a in f]).all(0)
    s = torch.arange(n)
    L = (((s[:, None, None] + f[0]) % n) * n + (s[None, :, None] + f[1]) % n) \
        * n + (s[None, None, :] + f[2]) % n
    return int(torch.bincount(L[ok], minlength=n ** 3).max())


def held(d, w, gen, B, openband, geometry):
    got = emulate(d, B, openband, w, geometry, gen)
    assert torch.equal(got[0], twin.cic_paint_lattice(d, B, None, openband))
    assert torch.equal(got[1], twin.cic_paint_lattice(d, B, w, openband))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
@pytest.mark.parametrize("openband", (True, False))
@pytest.mark.parametrize("B", (1, 2, 3))
@pytest.mark.parametrize("n", (12, 16))
def test_emulated_paint_equals_the_twin(n, B, openband, dtype, kind):
    d, w, gen = lattice_case(n, B, openband, dtype, kind)
    held(d, w, gen, B, openband, KERNEL)
    if kind == "cluster":   # one cell's sources fill most of its masks
        assert deepest_cell(d, B, openband) > (2 * B) ** 3 // 2


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("B", (1, 3))
@pytest.mark.parametrize("n", (12, 16))
def test_emulated_paint_in_small_blocks_equals_the_twin(n, B, kind):
    """Faces and runs smaller than the grid: block edges, ragged blocks."""
    for openband, dtype in ((True, torch.float32), (False, torch.float64)):
        d, w, gen = lattice_case(n, B, openband, dtype, kind)
        held(d, w, gen, B, openband, SMALL)


def test_plain_paint_counts_one_a_call_under_a_clock():
    """Each plain paint counts ``latpaint.plain`` once on the active clock
    (the benchmark's lattice_paint_kernel_share), nothing without one."""
    from fastbox_tpu_torch import timing
    from fastbox_tpu_torch.ops.cuda import lattice_cic as k

    d, w, _ = lattice_case(12, 1, True, torch.float32, "uniform")
    k.cic_paint_lattice(d, 1, w)        # no active clock: nothing counted
    clock = timing.StageClock("cpu")
    with timing.active(clock):
        k.cic_paint_lattice(d, 1)
        k.cic_paint_lattice_plain(d, 1, w)
    assert clock.counts() == {"latpaint.plain": 2}


@pytest.mark.parametrize("openband", [True, False])
def test_kernel_paint_refuses_bands_past_its_live_word(openband):
    """K11a's word of live targets holds D = hi - lo + 1 <= 32 planes:
    the wrapper refuses a wider band with a ValueError before it looks
    for a card, and PAINT_MAX_B is the widest band whose D fits."""
    from fastbox_tpu_torch.ops.cuda import lattice_cic as k

    def planes(B):
        return 2 * B + (1 if openband else 2)

    assert planes(k.PAINT_MAX_B) <= 32 < planes(k.PAINT_MAX_B + 1)
    assert k.PAINT_MAX_B < k.MAX_B
    d, w, _ = lattice_case(12, 1, openband, torch.float32, "uniform")
    with pytest.raises(ValueError, match="periodic paint"):
        k.cic_paint_lattice_cuda(d, k.PAINT_MAX_B + 1, w, openband)
    with pytest.raises(ValueError, match="CUDA"):
        k.cic_paint_lattice_cuda(d, k.PAINT_MAX_B, w, openband)
