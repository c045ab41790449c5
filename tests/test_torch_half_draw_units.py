"""K9's units (csrc/half_draw.cu), emulated in numpy on the CPU: which
thread draws which mode, with which Philox counter, on the vector and the
element path; and the vector-path rule.

The kernel walks the (R, C) half grid in units of four consecutive
columns of one row: block (bx, by) takes rows by, by + gy, ... and units
bx * 256 + thread, stepping by gx * 256, so a thread finds its row and
column from the grid alone.  Unit u of a row draws two Philox4x32-10
calls, counters (u, row, 2) and (u, row, 3); column 4u + j takes the
Box-Muller pair (x, y) or (z, w) of call j // 2.  The vector path covers a
unit with 16-byte accesses (C % 4 == 0), the element path mode by mode
(the last unit of a row may be partial); both must give every mode the
same counter and pair, and every mode exactly one.  The Philox emulation is
held to Random123's known-answer vectors.
"""
import numpy as np
import pytest
import torch

from fastbox_tpu_torch.ops.cuda import half_draw as k9

THREADS = 256                       # the kernel's kThreads
M0, M1, W0, W1 = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85
MASK = np.uint64(0xFFFFFFFF)


def launch_grid(R, C):
    """The launcher's (gx, gy): units of a row over blocks of THREADS, at
    most 1024 blocks across and 65535 down."""
    U = (C + 3) // 4
    return min(-(-U // THREADS), 1024), min(R, 65535)


def emulate(R, C, vec, grid=None):
    """For every mode (row, col): how often it is drawn, its counter
    (u, row, word) and its Box-Muller pair (0: x, y; 1: z, w)."""
    gx, gy = grid or launch_grid(R, C)
    U = (C + 3) // 4
    hits = np.zeros((R, C), np.int64)
    counter = np.full((R, C, 3), -1, np.int64)
    pair = np.full((R, C), -1, np.int64)
    tid = np.arange(THREADS)
    for by in range(gy):
        for row in range(by, R, gy):
            for bx in range(gx):
                u = bx * THREADS + tid
                while True:
                    live = u[u < U]
                    if live.size == 0:
                        break
                    for j in range(4):
                        col = 4 * live + j
                        if vec:
                            assert (col < C).all(), "a vector unit past the row"
                        col = col[col < C]
                        np.add.at(hits[row], col, 1)
                        counter[row, col] = np.stack(
                            [col // 4, np.full_like(col, row),
                             np.full_like(col, 2 + j // 2)], 1)
                        pair[row, col] = j % 2
                    u = u + gx * THREADS
    return hits, counter, pair


def half_shape(n):
    return n, n * (n // 2 + 1)


@pytest.mark.parametrize("n", [8, 16, 7, 9, 63, 65])
def test_units_cover_every_mode_once(n):
    R, C = half_shape(n)
    paths = [False] + ([True] if C % 4 == 0 else [])
    got = {}
    for vec in paths:
        for grid in (None, (1, 1), (1, 3), (2, R)):
            hits, counter, pair = emulate(R, C, vec, grid)
            assert (hits == 1).all()
            key = counter[..., 0] * 8 + counter[..., 2] * 2 + pair
            assert np.unique(key + counter[..., 1] * (8 * C)).size == R * C
            got.setdefault(vec, (counter, pair))
            np.testing.assert_array_equal(counter, got[vec][0])
            np.testing.assert_array_equal(pair, got[vec][1])
    if True in got:                    # both paths: the same counters
        np.testing.assert_array_equal(got[True][0], got[False][0])
        np.testing.assert_array_equal(got[True][1], got[False][1])


def test_even_grids_take_the_vector_path_and_odd_ones_may_not():
    """N (N/2 + 1) = 2m(m + 1) for N = 2m: every even N has C % 4 == 0."""
    for n in range(2, 130, 2):
        assert half_shape(n)[1] % 4 == 0
    assert half_shape(63)[1] % 4 == 0 and half_shape(65)[1] % 4 != 0


def test_a_modes_counter_depends_only_on_its_row_and_column():
    R = 9
    a = emulate(R, 45, False)[1]
    b = emulate(R, 48, True)[1]
    np.testing.assert_array_equal(a, b[:, :45])


def test_launch_grid_covers_the_rows_and_units():
    assert launch_grid(256, 256 * 129) == (33, 256)
    assert launch_grid(512, 512 * 257) == (129, 512)
    assert launch_grid(70000, 8) == (1, 65535)


def test_vector_path_rule():
    a = torch.zeros((4, 16))
    assert k9.vector_path(16, a, torch.zeros(16))
    assert not k9.vector_path(18, torch.zeros((4, 18)))
    flat = torch.empty(4 * 16 + 1)
    assert not k9.vector_path(16, a, flat[1:].view(4, 16))
    c = torch.zeros((4, 16), dtype=torch.complex64)
    assert k9.vector_path(16, a, c)
    cflat = torch.empty(4 * 16 + 1, dtype=torch.complex64)
    assert not k9.vector_path(16, a, cflat[1:].view(4, 16))


def philox4x32_10(c, k0, k1):
    """Philox4x32-10 as common.cuh spells it, on uint64 arrays of 32-bit
    words: counter words c = (c0, c1, c2, c3), key (k0, k1)."""
    c0, c1, c2, c3 = (np.asarray(x, np.uint64) for x in c)
    k0, k1 = np.uint64(k0), np.uint64(k1)
    for _ in range(10):
        p0 = np.uint64(M0) * c0
        p1 = np.uint64(M1) * c2
        c0, c1, c2, c3 = ((p1 >> np.uint64(32)) ^ c1 ^ k0, p1 & MASK,
                          (p0 >> np.uint64(32)) ^ c3 ^ k1, p0 & MASK)
        k0 = (k0 + np.uint64(W0)) & MASK
        k1 = (k1 + np.uint64(W1)) & MASK
    return c0, c1, c2, c3


@pytest.mark.parametrize("counter, key, want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(counter, key, want):
    got = philox4x32_10([np.array([w]) for w in counter], *key)
    assert tuple(int(g[0]) for g in got) == want


def box_muller(a, b):
    """common.cuh's box_muller in float64: 24-bit uniforms, u1 in (0, 1)."""
    u1 = (a >> np.uint64(8)).astype(np.float64) * 2.0 ** -24 + 2.0 ** -25
    u2 = (b >> np.uint64(8)).astype(np.float64) * 2.0 ** -24
    r = np.sqrt(-2.0 * np.log(u1))
    return r * np.cos(2 * np.pi * u2), r * np.sin(2 * np.pi * u2)


def draw(R, C, seed):
    """The kernel's normals (n_re, n_im) of every mode, in float64."""
    _, counter, pair = emulate(R, C, False)
    u, row, word = (counter[..., i].astype(np.uint64) for i in range(3))
    k0, k1 = seed & 0xFFFFFFFF, seed >> 32
    x, y, z, w = philox4x32_10((u, row, word, np.zeros_like(u)), k0, k1)
    first = pair == 0
    return box_muller(np.where(first, x, z), np.where(first, y, w))


def test_emulated_draw_is_unit_normal_and_uncorrelated():
    """The counter layout gives independent normals: moments, lag-1 and
    lag-C correlations and the real/imaginary correlation within 5 sigma."""
    R, C = half_shape(64)
    re, im = draw(R, C, 12345 + (7 << 32))
    x = np.concatenate([re.ravel(), im.ravel()])
    m = x.size
    assert abs(x.mean()) < 5 / m ** 0.5
    assert abs(x.var() - 1) < 5 * (2 / m) ** 0.5
    assert abs((x ** 4).mean() / x.var() ** 2 - 3) < 5 * (96 / m) ** 0.5
    for r, n in (((re[:, :-1] * re[:, 1:]).mean(), R * (C - 1)),
                 ((re[:-1] * re[1:]).mean(), (R - 1) * C),
                 ((re * im).mean(), R * C)):
        assert abs(r) < 5 / n ** 0.5
    a, _ = draw(R, C, 12346)
    assert not np.array_equal(a, re)
