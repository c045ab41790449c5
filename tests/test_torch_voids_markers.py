"""The port's marker-controlled watershed
(fastbox_tpu_torch/analysis/voids.py:_marker_watershed), on the CPU.

tests/test_voids_markers.py's checks on the port, each also holding the
port's labels equal to fastbox_tpu's on the same inputs.  Covers the
reference's ``watershed(markers=...)`` contract
(fastbox/voids.py:139-203): int markers (regular seed grid), explicit
marker arrays, multi-marker basins, flooding order, and a quantified
bound on the documented region-granularity approximation against a
small vendored per-voxel flooding oracle (the algorithm skimage's
Cython watershed implements: a priority flood over voxels in altitude
order starting from the marked voxels).
"""
import heapq
import itertools

import numpy as np
import pytest
import torch

from fastbox_tpu.analysis import voids as jvoids
from fastbox_tpu_torch.analysis import voids as tvoids
from fastbox_tpu_torch.analysis.voids import _regular_seed_array


def watershed_labels(f, mask):
    """The port's basins (on the CPU) as a host array."""
    return tvoids.watershed_labels(f, mask, device="cpu").numpy()


def _marker_watershed(f, mask, markers):
    """The port's marker flood on the CPU, held equal to fastbox_tpu's."""
    out = tvoids._marker_watershed(torch.as_tensor(f), torch.as_tensor(mask),
                                   markers)
    assert np.array_equal(out, jvoids._marker_watershed(f, mask, markers))
    return out


def apply_watershed(field, **kw):
    """The port's void finder on the CPU, held equal to fastbox_tpu's."""
    out = tvoids.apply_watershed(field, device="cpu", **kw)
    assert np.array_equal(out, jvoids.apply_watershed(field, **kw))
    return out


def _oracle_marker_watershed(f, mask, markers):
    """Per-voxel marker watershed: flood from marked voxels in altitude
    order (6-connected, non-periodic) — skimage ``watershed`` semantics.
    Pure numpy + heapq; O(N log N), fine for test-sized grids."""
    f = np.asarray(f, float)
    out = np.zeros(f.shape, np.int64)
    visited = np.zeros(f.shape, bool)
    order = itertools.count()
    pq = []
    for t in map(tuple, np.argwhere((np.asarray(markers) != 0) & mask)):
        out[t] = markers[t]
        visited[t] = True
        heapq.heappush(pq, (f[t], next(order), t))
    shape = f.shape
    while pq:
        _, _, t = heapq.heappop(pq)
        for axis in range(3):
            for d in (-1, 1):
                nb = list(t)
                nb[axis] += d
                if not (0 <= nb[axis] < shape[axis]):
                    continue
                nb = tuple(nb)
                if visited[nb] or not mask[nb]:
                    continue
                visited[nb] = True
                out[nb] = out[t]
                heapq.heappush(pq, (f[nb], next(order), nb))
    return out


def test_regular_seed_array_counts_and_labels():
    seeds = _regular_seed_array((16, 16, 16), 27)
    assert np.array_equal(seeds, jvoids._regular_seed_array((16, 16, 16), 27))
    vals = seeds[seeds > 0]
    # ~27 distinct consecutive labels on a regular grid
    assert vals.size == np.unique(vals).size
    assert np.array_equal(np.sort(vals), np.arange(1, vals.size + 1))
    assert 8 <= vals.size <= 64


def test_one_marker_per_basin_is_exact():
    """With exactly one marker in every basin no flooding happens: the
    output is the basin partition renamed to the marker labels."""
    rng = np.random.default_rng(7)
    f = rng.normal(size=(12, 12, 12))
    # smooth a little so basins are non-trivial
    for ax in range(3):
        f = (f + np.roll(f, 1, ax) + np.roll(f, -1, ax)) / 3.0
    mask = np.ones(f.shape, bool)
    basins = watershed_labels(f, mask)
    nb = basins.max()
    markers = np.zeros(f.shape, np.int64)
    want = np.zeros(nb + 1, np.int64)
    for b in range(1, nb + 1):
        sel = np.argwhere(basins == b)
        t = tuple(sel[np.argmin(f[tuple(sel.T)])])   # the basin minimum
        markers[t] = 100 + b                          # arbitrary labels
        want[b] = 100 + b
    out = _marker_watershed(f, mask, markers)
    assert np.array_equal(out, want[basins])
    # and the per-voxel oracle agrees exactly in this regime too
    assert np.array_equal(out, _oracle_marker_watershed(f, mask, markers))


def test_multi_marker_basin_takes_deepest():
    # single-basin bowl with two markers: the deeper one must win
    x = np.arange(9.0)
    f = ((x[:, None, None] - 4) ** 2 + (x[None, :, None] - 4) ** 2
         + (x[None, None, :] - 4) ** 2)
    mask = np.ones(f.shape, bool)
    markers = np.zeros(f.shape, np.int64)
    markers[4, 4, 4] = 3     # at the minimum (deepest)
    markers[1, 1, 1] = 8     # shallower
    out = _marker_watershed(f, mask, markers)
    assert set(np.unique(out)) == {3}


def test_flooding_order_minimax():
    """An unmarked middle basin must flood from the marker whose path has
    the LOWEST maximum saddle — regression for the pop-time labeling bug
    (relaxation-time labeling let the first-popped flood claim it)."""
    prof = np.array([9, 0, -10, 0, -1, -2, -5, -4, -3, -6, -8, -7, 9.0])
    f = prof[:, None, None] * np.ones((1, 1, 1))
    f = np.broadcast_to(f, (13, 1, 1)).copy()
    mask = np.ones(f.shape, bool)
    markers = np.zeros(f.shape, np.int64)
    markers[2, 0, 0] = 1      # basin A (deeper minimum, HIGHER saddle 0.0)
    markers[10, 0, 0] = 2     # basin B (saddle to middle basin = -3)
    out = _marker_watershed(f, mask, markers)
    # middle basin = x in 4..7 -> label 2 via the -3 saddle
    assert set(np.unique(out[4:8, 0, 0])) == {2}
    assert set(np.unique(out[:4, 0, 0])) == {1}
    assert set(np.unique(out[8:, 0, 0])) == {2}
    # exact agreement with the per-voxel oracle on this profile
    assert np.array_equal(out, _oracle_marker_watershed(f, mask, markers))


def test_disconnected_unmarked_region_stays_zero():
    f = np.zeros((9, 3, 3))
    f[:, :, :] = np.arange(9)[:, None, None] % 3 - 1.0
    mask = np.ones(f.shape, bool)
    mask[4] = False           # splits the cube into two components
    markers = np.zeros(f.shape, np.int64)
    markers[1, 1, 1] = 7      # only the first component is marked
    out = _marker_watershed(f, mask, markers)
    assert set(np.unique(out[:4])) == {7}
    assert set(np.unique(out[5:])) == {0}
    assert np.all(out[4] == 0)


def test_region_granularity_approximation_bound():
    """Quantify the documented approximation: basins are flooded whole,
    while the per-voxel oracle can split an unmarked basin between
    floods.  On a smooth random field the disagreement is bounded to a
    small fraction of voxels, and voxels in MARKED basins always agree."""
    rng = np.random.default_rng(3)
    f = rng.normal(size=(14, 14, 14))
    for _ in range(2):
        for ax in range(3):
            f = (f + np.roll(f, 1, ax) + np.roll(f, -1, ax)) / 3.0
    mask = np.ones(f.shape, bool)
    basins = watershed_labels(f, mask)
    nb = basins.max()
    # mark every OTHER basin at its minimum
    markers = np.zeros(f.shape, np.int64)
    marked = []
    for b in range(1, nb + 1, 2):
        sel = np.argwhere(basins == b)
        t = tuple(sel[np.argmin(f[tuple(sel.T)])])
        markers[t] = b
        marked.append(b)
    out = _marker_watershed(f, mask, markers)
    oracle = _oracle_marker_watershed(f, mask, markers)
    # marked basins are exact
    in_marked = np.isin(basins, marked)
    assert np.array_equal(out[in_marked], oracle[in_marked])
    # overall agreement: the approximation touches only voxels of
    # unmarked basins near contested saddles
    agree = float(np.mean(out == oracle))
    assert agree >= 0.75, f"agreement {agree:.3f} below bound"


def test_apply_watershed_int_markers_end_to_end():
    rng = np.random.default_rng(11)
    field = rng.lognormal(0.0, 0.6, size=(16, 16, 16))
    labels = apply_watershed(field, markers=8, mask_threshold=0.2,
                             merge_threshold=0.05, verbose=False)
    assert labels.shape == field.shape
    assert labels.max() >= 1
    # masked voxels (overdense) stay label 0
    f = field / field.mean() - 1.0
    assert np.all(labels[f > 0.2] == 0)
    # deterministic
    labels2 = apply_watershed(field, markers=8, mask_threshold=0.2,
                              merge_threshold=0.05, verbose=False)
    assert np.array_equal(labels, labels2)


def test_apply_watershed_marker_array_shape_check():
    field = np.random.default_rng(0).normal(size=(8, 8, 8))
    with pytest.raises(ValueError):
        tvoids.apply_watershed(field, markers=np.zeros((4, 4, 4), np.int64),
                               verbose=False, device="cpu")
