"""Void finding and measurement (reference fastbox/voids.py).

Torch counterpart of ``fastbox_tpu/analysis/voids.py``.  The watershed is
a steepest-descent label propagation on the field's device: every unmasked
voxel points to its lowest 6-connected neighbour, and pointer jumping
(ceil(log2 N) + 1 rounds of ``parent = parent[parent]``) resolves every
voxel to its basin minimum.  The marker flooding, the region-adjacency
merge and the measurements run on the host in numpy, as in fastbox_tpu:
the merge's consecutive relabelling follows the order of its union-find
roots, so only the same host code gives the same labels.

Note: the reference's field normalisation has an inverted condition
(``if np.mean(field) == 0.`` at voids.py:175-178, SURVEY.md §2.1 #31);
``apply_watershed`` keeps fastbox_tpu's handling (normalise a
non-negative field with a positive mean).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import device as devices

__all__ = [
    "watershed_labels",
    "apply_watershed",
    "void_centroid",
    "void_radii",
    "trim_by_volume",
    "stack_voids",
]


def _host(a) -> np.ndarray:
    """``a`` as a host numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _neighbors(fm, flat_idx):
    """The 6 face neighbours' (value, flat index), non-periodic: the edge
    row of each roll gets +inf so it never wins, matching skimage's
    boundary handling.  Order: axis 0, 1, 2; roll +1 then -1."""
    for axis in range(3):
        for shift in (1, -1):
            v = torch.roll(fm, shift, dims=axis)
            v.select(axis, 0 if shift == 1 else -1).fill_(torch.inf)
            yield v, torch.roll(flat_idx, shift, dims=axis)


def _steepest_descent_labels(f, mask):
    """Flat basin-root index per voxel (int64; masked voxels -> -1).

    A voxel points to the first strictly lowest of its neighbours (the
    order of ``_neighbors``; ``jnp.argmin`` takes the first of equal
    values, and a NaN neighbour as the minimum), and to itself unless that
    neighbour is strictly lower than the voxel.
    """
    size = f.numel()
    fm = torch.where(mask, f, torch.inf)
    flat_idx = torch.arange(size, device=f.device).reshape(f.shape)

    best_val = best_idx = any_nan = None
    for v, idx in _neighbors(fm, flat_idx):
        if best_val is None:
            best_val, best_idx, any_nan = v, idx, torch.isnan(v)
            continue
        lower = v < best_val
        best_val = torch.where(lower, v, best_val)
        best_idx = torch.where(lower, idx, best_idx)
        any_nan |= torch.isnan(v)
    best_val = torch.where(any_nan, torch.nan, best_val)

    parent = torch.where(best_val < fm, best_idx, flat_idx).reshape(-1)
    parent = torch.where(mask.reshape(-1), parent, -1)

    # Pointer jumping to the basin root: a fixed count, no host read
    for _ in range(int(np.ceil(np.log2(size))) + 1):
        parent = torch.where(parent >= 0, parent[parent.clamp(min=0)], -1)
    return parent.reshape(f.shape)


def watershed_labels(f, mask, device=None):
    """Consecutive integer labels (1..Nregions) per basin; 0 where masked.

    Runs on ``f``'s device (a numpy ``f`` goes to ``device``) and returns
    an int64 tensor there.
    """
    dev = devices.of(f, mask, device=device)
    roots = _steepest_descent_labels(devices.on(f, dev),
                                     devices.on(mask, dev).to(torch.bool))
    uniq, labels = torch.unique(roots, sorted=True, return_inverse=True)
    labels = labels.reshape(roots.shape)
    if int(uniq[0]) == -1:
        return labels  # masked voxels got label 0 automatically
    return labels + 1


def _region_adjacency(labels):
    """Set of (label_i, label_j) 6-connected adjacent pairs (host)."""
    pairs = set()
    for axis in range(3):
        a = np.swapaxes(labels, 0, axis)[:-1]
        b = np.swapaxes(labels, 0, axis)[1:]
        sel = (a != b) & (a > 0) & (b > 0)
        ai, bi = a[sel], b[sel]
        lo = np.minimum(ai, bi)
        hi = np.maximum(ai, bi)
        pairs.update(zip(lo.tolist(), hi.tolist()))
    return pairs


def _regular_seed_array(shape, n_points):
    """~``n_points`` seed labels on a regular grid (skimage's int-markers
    semantics: ``watershed(f, markers=<int>)`` seeds a regular grid via
    ``util.regular_seeds``, not local minima — the reference docstring's
    "placed in local minima" describes markers=None, not the int case)."""
    size = int(np.prod(shape))
    step = max(int(round((size / max(n_points, 1)) ** (1.0 / len(shape)))), 1)
    seeds = np.zeros(shape, dtype=np.int64)
    grid = tuple(slice(step // 2, None, step) for _ in shape)
    seeds[grid] = np.arange(1, seeds[grid].size + 1).reshape(seeds[grid].shape)
    return seeds


def _marker_watershed(f, mask, markers, device=None):
    """Marker-controlled watershed at region granularity.

    Basins come from the steepest descent on ``f``'s device (a numpy ``f``
    goes to ``device``); marker labels are then flooded over the
    region-adjacency graph on the host in order of saddle altitude
    (minimax paths), which reproduces watershed-by-flooding semantics
    whenever each basin holds at most one marker.  A basin holding several
    markers takes the deepest one (documented approximation — exact
    sub-basin splitting needs per-voxel flooding order).  Unreached basins
    (no marked flood arrives) stay 0, like skimage.  Returns host labels.
    """
    import heapq

    basins = _host(watershed_labels(f, mask, device=device))  # 1..R, 0 masked
    f, mask, markers = _host(f), _host(mask), _host(markers)
    nlab = int(basins.max()) + 1
    basin_label = np.zeros(nlab, dtype=np.int64)

    mk = np.where(mask, markers, 0)
    sel = np.nonzero(mk)
    if sel[0].size:
        order = np.argsort(f[sel])[::-1]               # shallowest first
        for b, l in zip(basins[sel][order], mk[sel][order]):
            basin_label[b] = l                         # deepest marker wins

    # Region graph with saddle altitudes: min over the shared boundary of
    # max(f_a, f_b) (NaN altitudes never count).  Taken per pair at once:
    # the order of a basin's neighbours changes no push of the flood below.
    keys, alts = [], []
    for axis in range(3):
        a = np.swapaxes(basins, 0, axis)[:-1]
        b = np.swapaxes(basins, 0, axis)[1:]
        fa = np.swapaxes(f, 0, axis)[:-1]
        fb = np.swapaxes(f, 0, axis)[1:]
        edge = (a != b) & (a > 0) & (b > 0)
        hi = np.maximum(fa[edge], fb[edge])
        keys.append(np.minimum(a[edge], b[edge]) * nlab
                    + np.maximum(a[edge], b[edge]))
        alts.append(hi)
    keys, alts = np.concatenate(keys), np.concatenate(alts)
    keep = ~np.isnan(alts)
    keys, alts = keys[keep], alts[keep]
    order = np.lexsort((alts, keys))            # by pair, lowest first
    first = np.ones(order.size, dtype=bool)
    first[1:] = keys[order][1:] != keys[order][:-1]
    pairs, saddles = keys[order][first], alts[order][first]
    adj = {}
    for key, h in zip(pairs.tolist(), saddles.tolist()):
        i, j = divmod(key, nlab)
        adj.setdefault(i, []).append((j, h))
        adj.setdefault(j, []).append((i, h))

    # Minimax flood from the marked basins.  Dijkstra-style: a basin's
    # label becomes final when it is POPPED (at its minimal water level),
    # not when an edge first touches it — assigning at relaxation time
    # would let a high-saddle flood claim a basin that a lower flood
    # reaches later in queue order, inverting the flooding order.
    # (Python lists: the loop reads one element at a time.)
    label = basin_label.tolist()
    pq = [(-np.inf, b, label[b]) for b in range(1, nlab) if label[b]]
    heapq.heapify(pq)
    done = [False] * nlab
    while pq:
        h, b, lbl = heapq.heappop(pq)
        if done[b]:
            continue
        done[b] = True
        if label[b] == 0:
            label[b] = lbl
        for nb, sh in adj.get(b, []):
            if not done[nb] and label[nb] == 0:
                heapq.heappush(pq, (max(h, sh), nb, label[b]))

    return np.asarray(label, dtype=np.int64)[basins]


def _contrast(field):
    """The field ``apply_watershed`` floods, on ``field``'s device.

    Normalise to a density contrast only for genuine density/count fields
    (non-negative with positive mean).  A contrast field (mean ~ 0, signed)
    passes through unchanged — which is also what the reference's inverted
    condition does in practice for every real input.  The mean is numpy's
    (pairwise, in the field's dtype) and the division is by a tensor on the
    device: a CUDA division by a host scalar multiplies by its reciprocal,
    whose rounding would move ties between basins.
    """
    host = _host(field)
    mean = host.mean()
    if host.min() >= 0.0 and mean > 0.0:
        mean = torch.as_tensor(mean, device=field.device)
        return field.to(mean.dtype) / mean - 1.0
    return field


def apply_watershed(field, markers=None, mask_threshold=0.0,
                    merge_threshold=0.2, verbose=True, device=None):
    """Watershed void finder with RAG mean-density merging (voids.py:139-203).

    ``markers`` follows the reference/skimage contract: None seeds every
    local minimum; an int seeds ~that many points on a regular grid; an
    integer array supplies explicit seed labels.  Marked floods are
    propagated by region-graph minimax flooding (see
    :func:`_marker_watershed`).  The basins are found on ``field``'s device
    (a numpy ``field`` goes to ``device``); returns host labels.
    """
    import time as _time

    f = _contrast(devices.on(field, devices.of(field, device=device)))
    mask = ~(f > mask_threshold)

    if verbose:
        print("Running watershed algorithm")
    t0 = _time.time()
    if markers is None:
        labels = _host(watershed_labels(f, mask))
    else:
        if np.isscalar(markers):
            markers = _regular_seed_array(tuple(f.shape), int(markers))
        else:
            markers = _host(markers)
            if markers.shape != tuple(f.shape):
                raise ValueError(
                    f"markers array shape {markers.shape} != field shape "
                    f"{tuple(f.shape)}")
        labels = _marker_watershed(f, mask, markers)
    f = _host(f)
    nreg = np.unique(labels).size
    if verbose:
        print("Watershed took %2.2f sec" % (_time.time() - t0))
        print("No. regions:", nreg)

    # RAG merge: union regions whose mean densities differ < merge_threshold
    t0 = _time.time()
    if verbose:
        print("Running merging algorithm")
    nlab = labels.max() + 1
    sums = np.bincount(labels.ravel(), weights=f.ravel(), minlength=nlab)
    counts = np.bincount(labels.ravel(), minlength=nlab)
    means = sums / np.maximum(counts, 1)

    parent = np.arange(nlab)

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i, j in _region_adjacency(labels):
        if abs(means[i] - means[j]) < merge_threshold:
            parent[find(i)] = find(j)

    roots = np.array([find(i) for i in range(nlab)])
    # Relabel consecutively, keeping 0 for masked
    uniq = np.unique(roots[1:]) if nlab > 1 else np.array([], dtype=int)
    remap = np.zeros(nlab, dtype=np.int64)
    remap[uniq] = np.arange(1, uniq.size + 1)
    new_labels = np.where(labels > 0, remap[roots[labels]], 0)
    if verbose:
        print("Merging took %2.2f sec" % (_time.time() - t0))
        print("No. regions after merging:", np.unique(new_labels).size)
    return new_labels


def _voxels(labels, cat):
    """label -> ``np.where(labels == label)`` for every label of ``cat``,
    from one stable sort instead of one pass over the grid per label: a
    label's flat indices come out ascending, which is np.where's C order,
    so each void's arrays (and every sum over them) equal fastbox_tpu's."""
    order = np.argsort(labels.ravel(), kind="stable")
    ordered = labels.ravel()[order]
    lo = np.searchsorted(ordered, cat, side="left")
    hi = np.searchsorted(ordered, cat, side="right")
    return {lbl: np.unravel_index(order[a:b], labels.shape)
            for lbl, a, b in zip(cat, lo, hi)}


def void_centroid(void_cat, void_labels, box, field=None, kind="uniform"):
    """Void centroids by several weightings (voids.py:10-79).

    Returns a dict label -> (x, y, z) centroid in box comoving coordinates.
    """
    labels = _host(void_labels).astype(int)
    centroids = {}
    x, y, z = np.asarray(box.x), np.asarray(box.y), np.asarray(box.z)
    cat = _host(void_cat).astype(int)
    voxels = _voxels(labels, cat)
    for lbl in cat:
        idxs = voxels[lbl]
        ix, iy, iz = idxs
        if kind == "minimum":
            ii = np.argmin(_host(field)[idxs])
            centroids[lbl] = np.array([x[ix[ii]], y[iy[ii]], z[iz[ii]]])
            continue
        if kind == "uniform":
            w = np.full(ix.size, 1.0 / ix.size)
        elif kind == "density":
            w = -_host(field)[idxs].astype(float)
            w[w < 0.0] = 0.0
            w /= np.sum(w)
        else:
            raise ValueError(f"Centroid kind '{kind}' not recognised.")
        centroids[lbl] = np.array([np.sum(w * x[ix]), np.sum(w * y[iy]),
                                   np.sum(w * z[iz])])
    return centroids


def void_radii(void_cat, void_labels, box):
    """Volume-equivalent void radii in Mpc (voids.py:82-113)."""
    dV = ((box.x[1] - box.x[0]) * (box.y[1] - box.y[0])
          * (box.z[1] - box.z[0]))
    labels = _host(void_labels)
    cat = _host(void_cat)
    voxels = _voxels(labels, cat)
    out = {}
    for lbl in cat:
        ncells = voxels[lbl][0].size
        out[lbl] = (3.0 * dV * ncells / (4.0 * np.pi)) ** (1.0 / 3.0)
    return out


def trim_by_volume(void_labels, nmin, nmax):
    """Labels of voids within a voxel-count range (voids.py:116-136)."""
    unique, counts = np.unique(_host(void_labels), return_counts=True)
    return unique[np.logical_and(counts >= nmin, counts <= nmax)]


def stack_voids(void_cat, void_labels, box, field, centroid_kind="density",
                grid_scale=1.0, grid_pix=31):
    """Radius-normalised void stack (voids.py:206-301).

    Each void's voxels are re-centred on its centroid, scaled by its radius,
    interpolated onto a common grid, and averaged with a validity mask.
    """
    import scipy.interpolate

    centroids = void_centroid(void_cat=void_cat, void_labels=void_labels,
                              box=box, field=field, kind="uniform")
    radii = void_radii(void_cat=void_cat, void_labels=void_labels, box=box)

    grid = np.linspace(-grid_scale, grid_scale, grid_pix)
    gx, gy, gz = np.meshgrid(grid, grid, grid)

    labels = _host(void_labels)
    field = _host(field)
    cat = _host(void_cat)
    voxels = _voxels(labels, cat)
    stacks, failures = [], []
    for lbl in cat:
        idxs = voxels[lbl]
        xi, yi, zi = idxs
        _x = (np.asarray(box.x)[xi] - centroids[lbl][0]) / radii[lbl]
        _y = (np.asarray(box.y)[yi] - centroids[lbl][1]) / radii[lbl]
        _z = (np.asarray(box.z)[zi] - centroids[lbl][2]) / radii[lbl]
        try:
            vg = scipy.interpolate.griddata(
                np.column_stack((_x, _y, _z)), field[idxs].ravel(),
                xi=(gx.ravel(), gy.ravel(), gz.ravel()),
                method="linear", fill_value=np.nan).reshape(gx.shape)
        except Exception:
            failures.append(lbl)
            continue
        stacks.append(np.ma.masked_invalid(vg))
    return np.ma.mean(np.ma.array(stacks), axis=0), failures
