"""K3's bracket search (csrc/rsd_interp.cu), emulated in numpy on the CPU,
and its path rule.

On the staged path a warp takes a row and its targets in batches of 32,
lane l target t0 + l.  Where the targets ascend (one vote per block), the
warp merges: from w, the count of nodes <= the previous batch's last
target rounded down to a pair, lane i holds nodes ww + 2i and ww + 2i + 1
of a 64-node window (+inf past the row); each lane counts the window's
nodes <= its target by a bisection over the lanes (seven shuffles), and
while some lane's target lies past the window it moves on by 64; after
WINDOW_HOPS moves the lanes still open bisect over the rest of the row.
Targets that do not ascend bisect each.  Every route must give j = the last
node <= z_t, which is ``searchsorted(..., right=True) - 1``; the value is
then ``interp_sorted_bracket``'s, held here to the plain twin and to
fastbox_tpu's Pallas kernel in interpret mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from fastbox_tpu.ops.pallas.rsd_interp import interp_sorted_pallas
from fastbox_tpu_torch.ops.cuda import rsd_interp as k3

C = 32
LANES = np.arange(32)


def last_le(s, lo, hi, zt):
    """The kernel's bisection: the last j in [lo - 1, hi) with s[j] <= zt."""
    while lo < hi:
        mid = (lo + hi) >> 1
        if s[mid] <= zt:
            lo = mid + 1
        else:
            hi = mid
    return lo - 1


def window_count(a, b, zt):
    """window_count: per lane, the count of a 64-node window's nodes <= its
    target; lane i holds nodes 2i (a[i]) and 2i + 1 (b[i]).  Five shuffle
    steps over pairs 0..30, one test of pair 31, one of the second node."""
    P = np.zeros(32, np.int64)
    for step in (16, 8, 4, 2, 1):
        P = np.where(a[P + step - 1] <= zt, P + step, P)
    P = np.where((P == 31) & (a[31] <= zt), 32, P)
    sb = b[(P + 31) & 31]
    return np.where(P == 0, 0, 2 * P - 1 + (sb <= zt))


def walk(s, z):
    """The brackets of one row as the staged kernel finds them, and how
    many targets left the merge for a bisection."""
    n, T = s.shape[0], z.shape[0]
    padded = np.concatenate([s, np.full(64, np.inf, s.dtype)])
    ascending = bool(np.all(z[:-1] <= z[1:])) and not np.isnan(z[0])
    j_out = np.empty(T, np.int64)
    fallbacks, w = 0, 0
    for t0 in range(0, T, 32):
        t = t0 + LANES
        zt = z[np.minimum(t, T - 1)]       # idle lanes repeat the last target
        if ascending:
            ww, hops = w & ~1, 0
            j = np.full(32, -1, np.int64)
            open_ = np.ones(32, bool)
            while True:
                win = padded[ww:ww + 64]
                p = window_count(win[0::2], win[1::2], zt)
                j = np.where(open_, np.minimum(ww + p - 1, n - 1), j)
                open_ &= (p == 64) & (ww + 64 < n)
                if not open_.any():
                    break
                ww += 64
                hops += 1
                if hops == k3.WINDOW_HOPS:
                    for lane in np.nonzero(open_)[0]:
                        j[lane] = last_le(s, ww, n, zt[lane])
                        fallbacks += 1
                    break
            w = j[31] + 1
        else:
            j = np.array([last_le(s, 0, n, x) for x in zt])
        j_out[t[t < T]] = j[t < T]
    return j_out, fallbacks


def rows(rng, kind, M=24, n=C):
    """Sorted rows of n nodes on [0, 100): random, with duplicates and
    nodes on the targets' grid, or clustered (n/2 nodes inside one gap of
    the uniform targets)."""
    s = rng.random((M, n)) * 100.0
    if kind == "duplicates":
        s[:, 10] = s[:, 11]
        s[:, 20:24] = s[:, 20:21]
        s[::2, 5] = 100.0 * 7 / 39       # exactly on target 7 of 40
        s[1::2, 6:9] = 100.0 * 15 / 39
    if kind == "clustered":
        s[:, : n // 2] = 55.5 + 0.5 * rng.random((M, n // 2))
    return np.sort(s, axis=1)


TARGETS = {
    "uniform": np.linspace(0.0, 100.0, 40),
    "T == C": np.linspace(0.0, 100.0, 8 * C),
    "wide": np.linspace(-20.0, 120.0, 100),
    "few": np.linspace(10.0, 90.0, 12),
    "non-uniform": 100.0 * np.linspace(0.0, 1.0, 70) ** 2,
    "repeated": np.repeat(np.linspace(0.0, 100.0, 20), 2),
    "to +inf": np.append(np.linspace(0.0, 100.0, 39), np.inf),
    "descending": np.linspace(100.0, 0.0, 40),
    "permuted": np.random.default_rng(3).permutation(np.linspace(0, 100, 40)),
}


@pytest.mark.parametrize("kind", ["random", "duplicates", "clustered"])
@pytest.mark.parametrize("targets", list(TARGETS))
def test_walk_finds_the_last_node_at_or_below(rng, kind, targets):
    """Rows of 8C nodes (so a batch can cross several windows), f32 and
    f64: the walk's j equals searchsorted's; clustered nodes, or many more
    nodes than targets, send lanes from the merge to the bisection."""
    z = TARGETS[targets]
    ss = rows(rng, kind, n=8 * C)
    total = 0
    for dt in (torch.float32, torch.float64):
        s_t, z_t = torch.tensor(ss, dtype=dt), torch.tensor(z, dtype=dt)
        want = torch.searchsorted(s_t, z_t[None, :].expand(len(ss), -1)
                                  .contiguous(), right=True).numpy() - 1
        for r in range(len(ss)):
            got, fallbacks = walk(s_t[r].numpy(), z_t.numpy())
            np.testing.assert_array_equal(got, want[r])
            total += fallbacks
    if kind == "clustered" and targets in ("uniform", "T == C", "wide"):
        assert total > 0, "clustered nodes must exhaust the window hops"
    if (kind, targets) == ("random", "T == C") or targets in ("descending",
                                                              "permuted"):
        assert total == 0     # about a window of nodes per batch; no merge


def test_staged_rule():
    row = lambda n, dt=torch.float32: torch.zeros((4, n), dtype=dt)
    assert k3.staged_path(256, 256, row(256))
    assert k3.staged_path(256, 98, row(256))
    assert k3.staged_path(4096, 4096, row(4096, torch.float64))
    for n, T in ((62, 256), (4100, 256), (256, 4100)):
        assert not k3.staged_path(n, T, row(n))
    flat = torch.empty(4 * 256 + 1)
    assert not k3.staged_path(256, 256, flat[1:].view(4, 256))


def test_staged_max_fits_one_block():
    """The staged layout at STAGED_MAX cells and targets in float64 (the
    kernel's two buffers of s and v per warp, each row followed by kPad
    +inf nodes, and the block's staged targets) fits one warp's block in
    the H100's 227 KiB of shared memory; the walk's hop budget is read
    from the kernel's source."""
    pad = k3._kernel_constant("kPad")
    per_warp = 2 * (2 * k3.STAGED_MAX + pad) * 8
    assert pad == 64
    assert per_warp + k3.STAGED_MAX * 8 <= 227 * 1024
    assert k3.WINDOW_HOPS == k3._kernel_constant("kWindowHops") >= 1


@pytest.mark.parametrize("targets", ["uniform", "wide", "descending",
                                     "repeated"])
@pytest.mark.parametrize("kind", ["random", "duplicates", "clustered"])
def test_bracket_form_matches_twin_and_pallas(rng, targets, kind):
    """interp_sorted_bracket (the kernel's order of operations) within
    1e-5 of max|value| of the telescoping twin and of the Pallas kernel in
    interpret mode, f32; and 1e-12 in f64 against the twin."""
    z = TARGETS[targets]
    ss = rows(rng, kind, M=32)
    vv = rng.standard_normal(ss.shape)
    fill = rng.standard_normal(ss.shape[0])
    want_p = np.asarray(interp_sorted_pallas(
        jnp.asarray(ss, jnp.float32), jnp.asarray(vv, jnp.float32),
        jnp.asarray(z, jnp.float32), jnp.asarray(fill, jnp.float32),
        interpret=True))
    args32 = [torch.tensor(a, dtype=torch.float32) for a in (ss, vv, z, fill)]
    got = k3.interp_sorted_bracket(*args32).numpy()
    twin = k3.interp_sorted_plain(*args32).numpy()
    scale = np.abs(twin).max()
    assert np.abs(got - twin).max() <= 1e-5 * scale
    assert np.abs(got - want_p).max() <= 1e-5 * scale
    args64 = [torch.tensor(a) for a in (ss, vv, z, fill)]
    got64 = k3.interp_sorted_bracket(*args64)
    twin64 = k3.interp_sorted_plain(*args64)
    assert (got64 - twin64).abs().max().item() <= 1e-12 * twin64.abs().max()


def test_bracket_form_on_the_pallas_sort(rng):
    """Rows sorted by lax.sort_key_val, as the JAX tier sorts them, with
    duplicates: the bracket form agrees with the Pallas kernel."""
    s = rng.random((64, C)) * 100.0
    s[:, 3] = s[:, 4]
    v = rng.standard_normal((64, C))
    z = np.linspace(0.0, 100.0, 48)
    fill = rng.standard_normal(64)
    ss, vv = lax.sort_key_val(jnp.asarray(s), jnp.asarray(v))
    want = interp_sorted_pallas(ss, vv, jnp.asarray(z), jnp.asarray(fill),
                                interpret=True)
    got = k3.interp_sorted_bracket(*(torch.tensor(np.asarray(a)) for a in
                                     (ss, vv, z, fill)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(want)).max())


def test_bracket_form_walk_values_equal_searchsorted_values(rng):
    """The value from the walk's j, in the kernel's rounding, is the
    bracket form's bit for bit (f32), on every row kind."""
    z = TARGETS["uniform"].astype(np.float32)
    for kind in ("random", "duplicates", "clustered"):
        ss = rows(rng, kind).astype(np.float32)
        vv = rng.standard_normal(ss.shape).astype(np.float32)
        fill = rng.standard_normal(ss.shape[0]).astype(np.float32)
        want = k3.interp_sorted_bracket(*(torch.tensor(a) for a in
                                          (ss, vv, z, fill))).numpy()
        for r in range(len(ss)):
            j, _ = walk(ss[r], z)
            out = np.full(z.shape, fill[r], np.float32)
            inside = (z >= ss[r, 0]) & (z <= ss[r, -1])
            for t in np.nonzero(inside)[0]:
                if j[t] >= C - 1:
                    out[t] = vv[r, -1]
                else:
                    s0, s1 = ss[r, j[t]], ss[r, j[t] + 1]
                    v0, v1 = vv[r, j[t]], vv[r, j[t] + 1]
                    frac = np.float32(z[t] - s0) / np.float32(s1 - s0)
                    out[t] = v0 + np.float32(v1 - v0) * frac
            np.testing.assert_array_equal(out, want[r])
