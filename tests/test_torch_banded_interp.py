"""K8's per-target sum (csrc/banded_interp.cu), emulated in torch on the
CPU, bit for bit against the plain twin; and its path rule.

The kernel forms each segment's ds+ = max(s[c+1] - s[c], 0) and dv once
per row and takes a segment's term without a division where it can:
dv where a = z - s[c] >= ds+, nothing where a <= 0 (a +-0 term), and
dv * (a / ds) only where 0 < a < ds.  On a row whose nodes ascend the
whole terms are a target's first segments and only the next one can
straddle, so a target divides once; other rows go term by term.  Halos
stand for the segments outside the row.  The emulation repeats that
arithmetic in the kernel's order and must equal banded_interp_plain under
torch.equal (which holds +0 and -0 equal).
"""
import numpy as np
import pytest
import torch

from fastbox_tpu_torch.ops.cuda import banded_interp as k8
from fastbox_tpu_torch.ops.cuda import rsd_fused as k7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (chip_smoke.py runs the kernels there)")
    return torch.device("cuda")


def emulate(ss, vv, z, fill, band):
    """K8's staged path in torch: halos of band segments either side (s =
    -inf before the row, +inf after it, ds+ = dv = 0, as at segment C-1)."""
    M, C = ss.shape
    dt = ss.dtype
    inf = torch.full((M, band), float("inf"), dtype=dt)
    pad = torch.zeros((M, band + 1), dtype=dt)
    d = ss[:, 1:] - ss[:, :-1]
    ascending = (d >= 0).all(dim=1, keepdim=True)
    s_h = torch.cat([-inf, ss, inf], 1)                   # node c at band + c
    dsp_h = torch.cat([pad[:, :band], torch.where(d > 0, d, 0.0), pad], 1)
    dv_h = torch.cat([pad[:, :band], vv[:, 1:] - vv[:, :-1], pad], 1)
    t = torch.arange(C)
    init = vv[:, (t - band).clamp(min=0)]

    def seg(k):
        """a, ds+ and dv of segment c = t - band + k of every target."""
        idx = (t + k).expand(M, C)
        return z - s_h.gather(1, idx), dsp_h.gather(1, idx), dv_h.gather(1, idx)

    # ascending rows: the whole terms in order, then the next segment's
    fast, whole = init.clone(), torch.zeros((M, C), dtype=torch.long)
    for k in range(2 * band):
        a, dsp, dv = seg(k)
        w = a >= dsp
        fast = torch.where(w, fast + dv, fast)
        whole += w
    p = (t + whole).clamp(max=C + 2 * band - 1)
    a = z - s_h.gather(1, p)
    dsp = dsp_h.gather(1, p)
    st = (whole < 2 * band) & (a > 0) & (a < dsp)
    q = dv_h.gather(1, p) * (a / torch.where(st, dsp, 1.0))
    fast = torch.where(st, fast + q, fast)
    # other rows: term by term, a division per straddling segment
    slow = init.clone()
    for k in range(2 * band):
        a, dsp, dv = seg(k)
        st = (a > 0) & (a < dsp)
        part = slow + dv * (a / torch.where(st, dsp, 1.0))
        slow = torch.where(a >= dsp, slow + dv, torch.where(st, part, slow))
    out = torch.where(ascending, fast, slow)
    inside = (z >= ss[:, :1]) & (z <= ss[:, -1:])
    return torch.where(inside, out, fill[:, None])


def rows(rng, case, band, dtype, M=96, C=80):
    """(ss, vv, z, fill): nodes within band - 0.4 cells of their rank, sorted
    per row, with duplicates, targets on nodes or nodes on the hull edges;
    or not sorted."""
    z = np.arange(C, dtype=np.float64) * 0.75 - 3.0
    s = z[None] + rng.uniform(-(band - 0.4), band - 0.4, (M, C)) * 0.75
    v = rng.standard_normal((M, C))
    if case == "duplicates":
        s[:, 10] = s[:, 11]
        s[::2, 30:33] = s[::2, 30:31]
    elif case == "on_nodes":
        s[:, 20] = z[20]
        s[::3, 40] = z[41]
        s[1::3, 41] = z[40]
    elif case == "hull_edges":
        s[::2, 0] = z[0]
        s[1::4, 0] = z[0] - 0.3
        s[::3, -1] = z[-1]
        s[2::5, -1] = z[-1] + 0.2
    if case != "unsorted":
        order = np.argsort(s, axis=1, kind="stable")
        s, v = np.take_along_axis(s, order, 1), np.take_along_axis(v, order, 1)
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    return t(s), t(v), t(z), t(rng.standard_normal(M))


@pytest.mark.parametrize("case", ["sorted", "duplicates", "on_nodes",
                                  "hull_edges", "unsorted"])
@pytest.mark.parametrize("band", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_division_free_sum_equals_twin(rng, case, band, dtype):
    ss, vv, z, fill = rows(rng, case, band, dtype)
    got = emulate(ss, vv, z, fill, band)
    want = k8.banded_interp_plain(ss, vv, z, fill, band)
    assert torch.equal(got, want), (got - want).abs().max()


def test_division_free_sum_cases_are_reached(rng):
    """The cases above reach what they name: ds = 0 segments, targets on
    nodes (a = 0), targets outside the hull, and rows that do not ascend."""
    ss, _, z, _ = rows(rng, "duplicates", 4, torch.float64)
    assert (ss[:, 1:] == ss[:, :-1]).any(dim=1).all()
    ss, _, z, _ = rows(rng, "on_nodes", 4, torch.float64)
    assert torch.isin(ss, z).any(dim=1).all()
    ss, _, z, _ = rows(rng, "hull_edges", 4, torch.float64)
    assert ((ss[:, 0] == z[0]).any() and (ss[:, 0] > z[0]).any()
            and (ss[:, -1] < z[-1]).any())
    ss, *_ = rows(rng, "unsorted", 4, torch.float64)
    assert not (ss[:, 1:] >= ss[:, :-1]).all(dim=1).any()


def test_staged_path_rule():
    """K8 takes the staged path by K2/K7's rule: 16-byte aligned rows of a
    multiple of 4 cells, at most STAGED_MAX_C, at bands 2 and 4."""
    assert k8.staged_path is k7.staged_path
    row = lambda C, dtype=torch.float32: torch.empty((4, C), dtype=dtype)
    for C in (4, 132, 256, 512, 4096):
        for dtype in (torch.float32, torch.float64):
            assert k8.staged_path(C, 2, row(C, dtype), row(C, dtype))
            assert k8.staged_path(C, 4, row(C, dtype))
    for C in (62, 130, 257, 4100):
        assert not k8.staged_path(C, 4, row(C))
    for band in (1, 3, 5):
        assert not k8.staged_path(256, band, row(256))
    shifted = torch.empty(4 * 256 + 1)[1:].view(4, 256)
    assert not k8.staged_path(256, 4, row(256), shifted)


def test_staged_rows_fit_a_block():
    """The staged block at STAGED_MAX_C in float64 at band 4: z and one
    warp's six row arrays (two buffers of s and v, ds+ and dv, each with
    4 halo nodes either side) within the H100's 227 KB."""
    C = k7.STAGED_MAX_C
    assert 8 * C + 6 * (4 + C + 4) * 8 <= 227 * 1024


@pytest.mark.cuda
@pytest.mark.parametrize("C", [62, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_equals_twin_duplicates_ragged(cuda, rng, dtype, C):
    ss, vv, z, fill = rows(rng, "duplicates", 4, dtype, M=512, C=C)
    args = tuple(a.to(cuda).contiguous() for a in (ss, vv, z, fill))
    assert k8.staged_path(C, 4, args[0], args[1]) == (C % 4 == 0)
    for band in (2, 4):
        assert torch.equal(k8.banded_interp_cuda(*args, band),
                           k8.banded_interp_plain(*args, band))
