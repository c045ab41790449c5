"""R2/R2w's pass structure (csrc/row_draw.cu, the Poisson draws), emulated
in plain torch on the CPU and held bit for bit to the twin,
``ops.cuda.row_draw._poisson``.

R rows of L rates, each row under its own key (R2: the folded row keys;
R2w: one row a field, its key as given), in the kernels' four passes:

0. chains: each row's keys r_0 (the row key) .. r_C, r_{t+1} = fold(r_t,
   0), and the subkeys fold(r_t, 1), fold(r_t, 2) of steps t + 1 <= C,
   into a table that every tile reads; a walk past step C derives its keys
   on from r_C;
1. Knuth, over (row, tile) tiles of T elements (shorter than a row, longer,
   ragged): each element's Knuth count (0 at rate 0, -1 at NaN); each
   tile's rejection elements appended to the list at a base from one
   atomic (tiles in a random order, a tile's elements in a random order),
   as far as the list's capacity holds them, and their row flagged;
2. first acceptances, over the flagged rows' tiles (a random order): each
   element's first acceptance of the rejection loop, a Knuth element's at
   rate 1e5; the row's step count S the largest over its tiles;
3. the walk: each listed element (every rejection element where more were
   listed than the capacity holds) walks S[row] steps and keeps the k of
   its last acceptance.

The capacity is the kernels' (``scratch_words``, mirrored from
``poisson_scratch_words``), and the cases force it below the number of
rejection elements too.  The cases: all Knuth, all rejection, a row whose
only rejection element is its last, rows of different S, rates of 0 and
NaN, float64 rates just under 10 that round to 10.0f, one key and three,
float32 and float64.  Against ``jax.random.poisson`` and
``fastbox_tpu.parallel.halos.row_poisson`` the emulation (the twin) holds
what tests/test_torch_row_draws.py holds the twin to: Knuth counts equal;
the rejection counts only in distribution (XLA's and torch's f32 lgamma
and log round differently, ROADMAP C).
"""
import numpy as np
import pytest
import torch

from fastbox_tpu_torch.keys import PRNGKey
from fastbox_tpu_torch.ops.cuda import row_draw
from fastbox_tpu_torch.ops.cuda.row_draw import M32, threefry2x32

KCHAIN = 32             # csrc/row_draw.cu kChain
CHAIN_WORDS = 130       # sizeof(Chains) / 4: 2 * kChain + 1 keys
CASES = ("knuth", "rejection", "last", "steps", "zero_nan", "round10",
         "mixed")
TAG = 5


@pytest.fixture(autouse=True)
def one_thread():
    """Many small tensor operations: one intra-op thread, so that test
    workers sharing the cores do not contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def poisson_case(case: str, shape, dtype, seed: int = 0) -> torch.Tensor:
    """Rates of one case, (rows, L) flattened from ``shape`` (the last
    axis L's): Knuth rates are 1e-3..9.99, rejection rates 10..1e4."""
    rng = np.random.default_rng(seed)
    R, L = shape[0] * (int(np.prod(shape[1:-1])) if len(shape) > 2 else 1), \
        shape[-1]
    knuth = rng.uniform(1e-3, 9.99, (R, L))
    if case == "knuth":
        lam = knuth
    elif case == "rejection":
        lam = rng.uniform(10.0, 1e4, (R, L))
    elif case == "last":       # a row's only rejection element is its last
        lam = knuth
        lam[::2, -1] = rng.uniform(10.0, 1e4, lam[::2, -1].shape)
    elif case == "steps":      # rows of few and of many rejection elements
        lam = knuth
        for r in range(R):
            pick = rng.random(L) < (r + 1) / (R + 1)
            lam[r, pick] = rng.uniform(10.0, 50.0, pick.sum())
    elif case == "zero_nan":
        lam = np.where(rng.random((R, L)) < 0.3,
                       rng.uniform(10.0, 1e3, (R, L)), knuth)
        lam.reshape(-1)[::7] = 0.0
        lam.reshape(-1)[3::11] = np.nan
        lam[0] = 0.0           # a row of zeros
        lam[-1, ::2] = np.nan
    elif case == "round10":    # f64 rates that round to 10.0f: rejection
        lam = knuth
        lam.reshape(-1)[::5] = np.nextafter(10.0, 0.0)
        lam.reshape(-1)[1::5] = 10.0 - 2.0 ** -30
        lam.reshape(-1)[2::5] = np.float32(np.nextafter(np.float32(10.0),
                                                        np.float32(0.0)))
    else:                      # mixed: every regime
        lam = 10.0 ** rng.uniform(-3.0, 4.0, (R, L))
        lam.reshape(-1)[::13] = 0.0
        lam.reshape(-1)[5::29] = np.nan
    return torch.as_tensor(lam, dtype=dtype).reshape(shape)


def scratch_words(R: int, L: int, elem_bytes: int) -> int:
    """csrc/row_draw.cu poisson_scratch_words: the chains, the list's
    length, each row's S and flag, then the list, the whole at most the
    rate field's size (or the fixed part where that is larger)."""
    fixed = R * (CHAIN_WORDS + 2) + 2
    n = R * L
    if n > M32:
        return fixed
    return max(fixed, min(n * elem_bytes // 4, n + fixed))


def capacity(R: int, L: int, elem_bytes: int) -> int:
    return scratch_words(R, L, elem_bytes) - (R * (CHAIN_WORDS + 2) + 2)


def chains(K0, K1, chain: int):
    """Pass 0: the (2, chain, R) subkey words (k0, k1) and each row's
    r_chain."""
    r0, r1 = K0, K1
    s0 = torch.empty((2, chain) + K0.shape, dtype=torch.int64)
    s1 = torch.empty_like(s0)
    for t in range(chain):
        for d in (0, 1):
            s0[d, t], s1[d, t] = threefry2x32(r0, r1, 0, d + 1)
        r0, r1 = threefry2x32(r0, r1, 0, 0)
    return s0, s1, (r0, r1)


class Keys:
    """The keys of step t (from 1) for elements of rows ``row``: the table
    up to the chain's length, beyond it derived on from r_chain, as each
    thread of the kernels derives them."""

    def __init__(self, table, row):
        self.s0, self.s1, (n0, n1) = table
        self.row = row
        self.r = (n0[row], n1[row])

    def at(self, t: int, d: int, sel):
        if t <= self.s0.shape[1]:
            rl = self.row[sel]
            return self.s0[d, t - 1][rl], self.s1[d, t - 1][rl]
        return tuple(w[sel] for w in threefry2x32(*self.r, 0, d + 1))

    def advance(self, t: int) -> None:
        if t > self.s0.shape[1]:
            self.r = threefry2x32(*self.r, 0, 0)


def knuth_counts(table, row, j, x):
    """Pass 1's threads: Knuth counts of rates 0 < x < 10 (float32); 0 at
    0, -1 at NaN or below 0."""
    out = torch.where(x == 0, 0.0, -1.0)
    todo = torch.nonzero(x > 0).reshape(-1)
    k = torch.zeros(x.shape, dtype=torch.int64)
    lp = torch.zeros_like(x)
    keys = Keys(table, row)
    live = todo
    t = 0
    while live.numel():
        t += 1
        k[live] = t
        u0, u1 = keys.at(t, 0, live)
        lp[live] += torch.log(row_draw._unit(u0, u1, j[live],
                                             torch.float32))
        keys.advance(t)
        live = live[(lp[live] > -x[live]) & (t < row_draw.MAX_ITERS)]
    out[todo] = (k[todo] - 1).to(out.dtype)
    return out


def rejection_walk(table, row, j, x, steps=None):
    """Pass 2's threads (``steps`` None: each element's first acceptance)
    or pass 3's (each element ``steps`` steps: the k of its last
    acceptance, -1 if none)."""
    consts = row_draw._rejection_consts(x)
    keys = Keys(table, row)
    n = x.numel()
    first = torch.full((n,), row_draw.MAX_ITERS, dtype=torch.int64)
    last = torch.full((n,), -1.0)
    live = torch.arange(n)
    t = 0
    while live.numel() and t < (row_draw.MAX_ITERS if steps is None
                                else int(steps.max())):
        t += 1
        if steps is not None:
            live = live[steps[live] >= t]
        (u0, u1), (v0, v1) = keys.at(t, 0, live), keys.at(t, 1, live)
        k, accept = row_draw._rejection_step(
            u0, u1, v0, v1, j[live], x[live], [c[live] for c in consts])
        keys.advance(t)
        if steps is None:
            first[live[accept]] = t
            live = live[~accept]
        else:
            last[live] = torch.where(accept, k, last[live])
    return first if steps is None else last


def emulate(K0, K1, lam, tile: int, cap: int, chain: int, rng):
    """The four passes on rates ``lam`` (R, L), row r under (K0[r], K1[r]),
    tiles of ``tile`` elements, a list of ``cap`` entries; returns the
    counts in ``lam``'s dtype and whether the walk took every element."""
    R, L = lam.shape
    x = lam.reshape(-1).to(torch.float32)
    idx = torch.arange(R * L)
    row, j = idx // L, idx % L
    table = chains(K0, K1, chain)
    knuth = torch.isnan(x) | (x < 10.0)
    out = torch.full((R * L,), float("inf"))
    # pass 1: Knuth counts; the list, tile by tile in a random order
    out[knuth] = knuth_counts(table, row[knuth], j[knuth], x[knuth])
    per_row = -(-L // tile)
    tiles = [(r, i * tile, min(L, (i + 1) * tile))
             for r in range(R) for i in range(per_row)]
    flags = torch.zeros(R, dtype=torch.bool)
    listed, entries = 0, torch.full((cap,), -1, dtype=torch.int64)
    for t in rng.permutation(len(tiles)):
        r, a, b = tiles[t]
        mine = r * L + a + torch.nonzero(~knuth[r * L + a:r * L + b]) \
            .reshape(-1)
        mine = mine[torch.as_tensor(rng.permutation(mine.numel()),
                                    dtype=torch.int64)]
        at = listed + torch.arange(mine.numel())
        entries[at[at < cap]] = mine[at < cap]
        listed += mine.numel()
        flags[r] |= mine.numel() > 0
    # pass 2: first acceptances over the flagged rows' tiles
    flagged = flags[row]
    first = torch.zeros(R * L, dtype=torch.int64)
    first[flagged] = rejection_walk(
        table, row[flagged], j[flagged],
        torch.where(knuth, 1e5, x)[flagged])
    S = torch.zeros(R, dtype=torch.int64)
    for t in rng.permutation(len(tiles)):
        r, a, b = tiles[t]
        if flags[r]:
            S[r] = max(int(S[r]), int(first[r * L + a:r * L + b].max()))
    # pass 3: the walk, from the list or (overflowed) over every element
    every = listed > cap
    walk = torch.nonzero(~knuth).reshape(-1) if every else entries[:listed]
    if walk.numel():
        out[walk] = rejection_walk(table, row[walk], j[walk], x[walk],
                                   S[row[walk]])
    assert not torch.isinf(out).any()
    return out.view(R, L).to(lam.dtype), every


def twin(K0, K1, lam):
    out = torch.empty_like(lam)
    row_draw._poisson(K0, K1, lam, out)
    return out


def same(a, b) -> bool:
    return torch.equal(a.nan_to_num(-9.0), b.nan_to_num(-9.0))


# (keys, rows, L): R2's rows of three keys, R2w's fields of one and three
SHAPES = {"rows": (3, 4, 100), "field": (1, 1, 512), "fields": (3, 1, 256)}


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kind", tuple(SHAPES))
def test_emulated_passes_equal_the_twin(kind, case, dtype):
    B, nrows, L = SHAPES[kind]
    lam = poisson_case(case, (B * nrows, L), dtype,
                       seed=CASES.index(case)).reshape(B * nrows, L)
    keys = torch.stack([PRNGKey(s) for s in (2 ** 32 + 5, -7, 1234)[:B]])
    if kind == "rows":
        K0, K1 = row_draw._row_keys(keys, TAG, 13, nrows)
    else:
        K0, K1 = keys[:, 0], keys[:, 1]
    want = twin(K0, K1, lam)
    rng = np.random.default_rng(7)
    R = B * nrows
    n_rej = int((~(torch.isnan(lam.float()) | (lam.float() < 10))).sum())
    kernel_cap = capacity(R, L, lam.element_size())
    # tiles shorter than a row (32, L - 36, 64: a ragged last tile) and
    # longer (4 L); chains of 32 keys and of 2 and 3 (the keys past them
    # derived); the kernels' capacity, one too short by one (the walk over
    # every element) and one just long enough
    for tile, cap, chain in ((32, kernel_cap, KCHAIN),
                             (L - 36, kernel_cap, 2),
                             (4 * L, max(n_rej - 1, 0), KCHAIN),
                             (64, n_rej, 3)):
        got, every = emulate(K0, K1, lam, tile, cap, chain, rng)
        assert same(got, want), (tile, cap, chain)
        assert every == (n_rej > cap)


SCRATCH_SHAPES = ((1, 256 ** 3), (256, 256 ** 2), (64, 256 ** 2),
                  (8 * 16, 256 ** 2), (1, 2 ** 15), (8, 4096), (3, 200))


def test_scratch_fits_the_rate_field():
    """At most the rate field's bytes (rows of 134 rates or more); a
    float64 field's list holds every element, a float32 one's all but the
    fixed part's worth, so that an all-rejection float32 field overflows
    it (the walk then takes every element)."""
    for R, L in SCRATCH_SHAPES:
        for eb in (4, 8):
            words = scratch_words(R, L, eb)
            assert words * 4 <= R * L * eb
            assert capacity(R, L, eb) == (R * L if eb == 8 else
                                          R * L - R * (CHAIN_WORDS + 2) - 2)
    assert capacity(1, 100, 4) == 0 and scratch_words(1, 100, 4) == 134
    assert capacity(2, 2 ** 31 + 1, 4) == 0


@pytest.mark.cuda
def test_kernel_scratch_words_equal_the_mirror():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (chip_smoke.py runs the kernels there)")
    from fastbox_tpu_torch.ops.cuda import _build

    lib = _build.load_library()
    for R, L in SCRATCH_SHAPES + ((1, 100), (2, 2 ** 31 + 1)):
        for eb in (4, 8):
            assert lib.fbx_poisson_scratch(R, L, eb) == scratch_words(R, L,
                                                                      eb)


def test_emulation_knuth_counts_equal_jax():
    """The emulated R2w and R2 (equal to the twin above) against jax on a
    mixed 16^3 field: Knuth counts equal, the rejection counts Poisson
    draws of their rates."""
    import jax
    import jax.numpy as jnp

    from fastbox_tpu.parallel.halos import row_poisson as jax_row_poisson

    lam = poisson_case("zero_nan", (16, 16, 16), torch.float32, seed=3)
    flat = lam.reshape(16, 256)
    x = flat.reshape(-1)
    knuth = torch.isnan(x) | (x < 10.0)
    rng = np.random.default_rng(1)
    keys = PRNGKey(11)[None]
    K0, K1 = keys[:, 0], keys[:, 1]
    field, _ = emulate(K0, K1, lam.reshape(1, -1), 512,
                       capacity(1, 4096, 4), KCHAIN, rng)
    want = np.asarray(jax.random.poisson(jax.random.PRNGKey(11),
                                         jnp.asarray(lam.numpy())))
    got = field.reshape(-1).numpy()
    np.testing.assert_array_equal(got[knuth.numpy()],
                                  want.reshape(-1)[knuth.numpy()])
    K0, K1 = row_draw._row_keys(keys, TAG, 0, 16)
    rows, _ = emulate(K0, K1, flat, 100, capacity(16, 256, 4), KCHAIN, rng)
    want = np.asarray(jax_row_poisson(jax.random.PRNGKey(11), TAG, 0,
                                      jnp.asarray(lam.numpy())))
    got = rows.reshape(-1).numpy()
    np.testing.assert_array_equal(got[knuth.numpy()],
                                  want.reshape(-1)[knuth.numpy()])
    rej = ~knuth.numpy()
    lam64 = x.numpy().astype(np.float64)[rej]
    z = (got[rej] - lam64) / np.sqrt(lam64)
    assert abs(z.mean()) * np.sqrt(z.size) < 5 and abs(z.std() - 1) < 0.1
