"""Datacube utilities (reference fastbox/analysis.py).

Torch counterpart of ``fastbox_tpu/analysis/datacube.py``: NaN handling,
grid-to-grid interpolation and catalogue gridding as tensor operations on
the input's device (a numpy input goes to ``device``; None means the
card).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import device as devices

__all__ = [
    "replace_nan_with_channel_mean",
    "interpolate_onto_grid",
    "grid_catalogue",
]


def replace_nan_with_channel_mean(field, device=None):
    """Replace NaNs with each channel's non-NaN mean (analysis.py:5-28)."""
    field = devices.on(field, devices.of(field, device=device))
    shape = field.shape
    d = field.reshape(-1, shape[-1])
    good = ~torch.isnan(d)
    avg = torch.where(good, d, 0.0).sum(dim=0) / good.sum(dim=0)
    return torch.where(good, d, avg[None, :]).reshape(shape)


def _interp1d_weights(xs, xt):
    """Indices/weights for linear interp from grid xs to targets xt.

    Out-of-range targets get NaN (matching RegularGridInterpolator with
    bounds_error=False, fill_value=nan).
    """
    n = xs.shape[0]
    idx = torch.clamp(torch.searchsorted(xs, xt, right=True), 1, n - 1)
    lo, hi = xs[idx - 1], xs[idx]
    w = (xt - lo) / torch.where(hi > lo, hi - lo, 1.0)
    inside = (xt >= xs[0]) & (xt <= xs[-1])
    return idx, w, inside


def interpolate_onto_grid(field, coords_orig, coords_new, device=None):
    """Trilinear regrid of a 3D field (analysis.py:31-70).

    Coordinates must be ascending.  NaNs in the input are replaced with the
    channel mean first; out-of-range output voxels are NaN.
    """
    dev = devices.of(field, device=device)
    out = replace_nan_with_channel_mean(devices.on(field, dev))
    mask = None
    for axis, (xs, xt) in enumerate(zip(coords_orig, coords_new)):
        idx, w, inside = _interp1d_weights(devices.on(xs, dev),
                                           devices.on(xt, dev))
        lo = torch.index_select(out, axis, idx - 1)
        hi = torch.index_select(out, axis, idx)
        shape = [1, 1, 1]
        shape[axis] = -1
        wb = w.reshape(shape)
        out = lo * (1.0 - wb) + hi * wb
        m = inside.reshape(shape)
        mask = m if mask is None else mask & m
    return torch.where(mask, out, torch.nan)


def grid_catalogue(x, y, z, w=None, xlim=None, ylim=None, zlim=None,
                   nx=None, ny=None, nz=None, device=None):
    """Bin a 3D catalogue onto a regular grid (analysis.py:73-118).

    Matches ``np.histogramdd`` semantics: nx equal-width bins over
    [min, max], right-inclusive final edge.  Returns (grid, (xg, yg, zg))
    with xg/yg/zg the host linspace "bin centre" arrays the reference
    returns.
    """
    if nx is None or ny is None or nz is None:
        raise ValueError("nx, ny, and nz must be specified.")
    dev = devices.of(x, y, z, w, device=device)
    x, y, z = (devices.on(a, dev) for a in (x, y, z))

    lims = []
    for arr, lim in ((x, xlim), (y, ylim), (z, zlim)):
        if lim is None:
            lim = (arr.min(), arr.max())
        lims.append(lim)
    (xmin, xmax), (ymin, ymax), (zmin, zmax) = lims

    def digitize(arr, lo, hi, n):
        # a tensor divisor: CUDA divides by a host scalar as a multiply by
        # its reciprocal, which moves points that sit on bin edges
        span = torch.as_tensor(hi - lo, dtype=arr.dtype, device=arr.device)
        t = (arr - lo) / span * n
        i = torch.floor(t).to(torch.int64)
        i = torch.where(arr == hi, n - 1, i)  # top edge inclusive
        valid = (arr >= lo) & (arr <= hi)
        return i, valid

    ix, vx = digitize(x, xmin, xmax, nx)
    iy, vy = digitize(y, ymin, ymax, ny)
    iz, vz = digitize(z, zmin, zmax, nz)
    valid = vx & vy & vz
    flat = (ix * ny + iy) * nz + iz
    flat = torch.where(valid, flat, nx * ny * nz)   # the dump bin

    weights = torch.ones_like(x) if w is None else devices.on(w, dev)
    grid = torch.zeros(nx * ny * nz + 1, dtype=weights.dtype, device=dev)
    grid.index_add_(0, flat, weights)
    grid = grid[:-1].reshape(nx, ny, nz)

    xg = np.linspace(float(xmin), float(xmax), nx)
    yg = np.linspace(float(ymin), float(ymax), ny)
    zg = np.linspace(float(zmin), float(zmax), nz)
    return grid, (xg, yg, zg)
