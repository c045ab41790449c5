"""Redshift-space distortion remap and the scaled-normal draw.

Counterpart of ``fastbox_tpu/ops/rsd.py`` (``add_scaled_normal`` :63-91,
``remap_los_batched`` :170-310, ``redshift_space_density`` :313-386,
``_remap_wrap_tiered`` :389-420).  ``redshift_space_density`` takes the
default TPU path for 'linear': the wrap-fused bracket kernel K2 at band 2
or band 4, and the sort + exact interpolation kernel K3 beyond.  For
'nearest' it wraps and calls ``remap_los_batched``, whose branches are the
bracket scan on pre-wrapped coordinates (K7), the banded interpolation on
sorted nodes (K8), K3, and the 'nearest' rule in plain PyTorch.

Semantics matched to the reference:
  * ``s = z - (v_z + v_nl) / H(a)`` (box.py:422)
  * periodic wrap ``s -> (s - z0) mod Lz + z0`` (box.py:425-426)
  * 1-D ``griddata`` linear: targets outside [min(s), max(s)] get the fill
    value ``0.5 (delta[...,0] + delta[...,-1])`` (box.py:429-437)
  * ``method='nearest'``: scipy's interp1d(kind='nearest',
    fill_value='extrapolate') — nearest endpoint out of range, midpoint
    bisection inside.

The tier is chosen on the host from ``maxdisp``: one ``.item()`` per call
(``sync.rsd_band`` or ``sync.rsd_cover`` in the active clock's counts,
``timing.count``).  Every tier is exact when its band covers ``maxdisp``.
Each remap also counts the tier it took: ``rsd.band<b>``, or
``rsd.exact`` for the sort + K3.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import keys, timing
from ..grid import GridSpec
from .cuda.banded_interp import banded_interp
from .cuda.noise import add_scaled_normal_2d
from .cuda.rsd_fused import rsd_bracket_interp, rsd_remap_wrap, wrap_params
from .cuda.rsd_interp import interp_sorted

__all__ = ["add_scaled_normal", "redshift_space_density", "remap_los_batched"]

METHODS = ("linear", "nearest")


def add_scaled_normal(x, scale_row, key=None, normals=None,
                      return_max: bool = False):
    """x + scale_row[..broadcast..] * N(0,1) along the last axis.

    K1 on a CUDA tensor, its plain twin on a CPU tensor.  The normals are
    ``normals`` (x's shape) when given; else, for a key (an int seed or
    key words, ``keys``), ``jax.random.normal(key, x.shape, x.dtype)``,
    fastbox_tpu's draw off the TPU (fastbox_tpu/ops/rsd.py:87), by R1w and
    then K1's supplied mode (two launches); else K1 draws them from the
    ``torch.Generator`` ``key``.  With ``return_max`` also returns
    ``max|result|`` as a 0-dim tensor — the RSD remap's displacement bound.
    """
    shape = x.shape
    C = shape[-1]
    if normals is None and keys.is_key(key):
        normals = keys.normal(key, shape, x.dtype, device=x.device)
        key = None
    nrm = None if normals is None else normals.reshape(-1, C).contiguous()
    res = add_scaled_normal_2d(x.reshape(-1, C).contiguous(),
                               scale_row.to(x.dtype), key, nrm,
                               return_max)
    if return_max:
        return res[0].reshape(shape), res[1]
    return res.reshape(shape)


def redshift_space_density(delta_x, velocity_z, grid: GridSpec, Hz: float,
                           sigma_nl: float = 0.0, key=None,
                           normals=None, method: str = "linear",
                           vmax=None):
    """Remap a real-space density cube to redshift space (box.py:384-438).

    Parameters:
        delta_x: (N,N,N) real-space density field.
        velocity_z: (N,N,N) LOS (z-axis) velocity in km/s.
        grid: static geometry.
        Hz: H(a) in km/s/Mpc.
        sigma_nl: RMS of incoherent small-scale velocities (km/s); when > 0
            they are drawn with ``key`` (a key: fastbox_tpu's
            ``jax.random.normal`` stream; or a ``torch.Generator``) or taken
            from ``normals``.
        method: 'linear' or 'nearest'.
        vmax: optional max|velocity_z| already at hand (a 0-dim tensor),
            which saves a reduction; ignored when sigma_nl > 0.

    Returns:
        delta_s: (N,N,N) redshift-space density field.
    """
    if method not in METHODS:
        raise ValueError(f"Unsupported RSD interpolation method '{method}'")
    rdtype = delta_x.dtype
    dev = delta_x.device
    N = grid.N
    timing.count_copy("h2d_rsd", dev, 2)    # z, and Hz below
    z = torch.as_tensor(grid.z, dtype=rdtype, device=dev)
    z0 = z[0]
    length_z = z[-1] - z[0]

    vel = velocity_z
    if sigma_nl > 0.0:
        vel, vmax = add_scaled_normal(
            vel, torch.full((N,), sigma_nl, dtype=rdtype, device=dev),
            key, normals, return_max=True)
    elif vmax is None:
        vmax = torch.max(torch.abs(vel))

    fill = 0.5 * (delta_x[..., 0] + delta_x[..., -1])
    if method == "nearest":
        # the wrapped redshift-space coordinate (box.py:422-426), then the
        # generic remap (fastbox_tpu/ops/rsd.py:377-386)
        u = z - vel / torch.tensor(Hz, dtype=rdtype, device=dev)
        s = torch.remainder(u - z0, length_z) + z0
        out = remap_los_batched(
            delta_x.reshape(N * N, N), s.reshape(N * N, N), z,
            fill.reshape(N * N), method=method, ztarget_np=grid.z,
            s_unwrapped=u.reshape(N * N, N))
        return out.reshape(N, N, N)
    inv_hz = 1.0 / torch.tensor(Hz, dtype=rdtype, device=dev)
    maxdisp = vmax * inv_hz
    dz = float(grid.z[1] - grid.z[0])
    out = _remap_wrap_tiered(
        delta_x.reshape(N * N, N).contiguous(),
        vel.reshape(N * N, N).contiguous(), z,
        fill.reshape(N * N).contiguous(), z0, length_z, inv_hz, dz, maxdisp,
        band=4)
    return out.reshape(N, N, N)


def _uniform_targets(ztarget, ztarget_np, C: int):
    """The targets on the host when they are a uniform grid of C points
    (the rank grid the nodes were displaced from), else None."""
    if ztarget_np is None:
        timing.count("sync.rsd_targets")
    zt = np.asarray(ztarget_np if ztarget_np is not None
                    else ztarget.detach().cpu().numpy())
    d = np.diff(zt.astype(np.float64))
    # f32 coordinates carry ~1e-4 jitter in their diffs at Gpc offsets;
    # uniform-enough is all the band bound needs
    if (zt.size != C or d.size == 0 or d.min() <= 0
            or (d.max() - d.min()) > 1e-2 * abs(d.mean())):
        return None
    return zt


def _covers(maxdisp, bound: float) -> bool:
    """maxdisp <= bound, compared in maxdisp's dtype (one host sync)."""
    timing.count("sync.rsd_cover")
    return maxdisp.item() <= torch.tensor(bound, dtype=maxdisp.dtype).item()


def remap_los_batched(vals, s, ztarget, fill, method: str = "linear",
                      band: int = 4, ztarget_np=None, fused: bool = True,
                      s_unwrapped=None):
    """Scattered 1-D interpolation of many lines of sight at once
    (fastbox_tpu/ops/rsd.py:170-310).

    Parameters:
        vals: (M, C) sample values per LOS.
        s: (M, C) sample coordinates per LOS (unsorted, wrapped).
        ztarget: (T,) target grid (shared by all LOS).
        fill: (M,) fill value per LOS ('linear' outside the node hull).
        method: 'linear' or 'nearest'.
        band: displacement bound in cells of the banded tiers.
        ztarget_np: the targets on the host (saves a device read).
        fused: allow the sort-free bracket scan (K7).
        s_unwrapped: (M, C) coordinates before the wrap; with a uniform
            target grid, C a power of two and M a multiple of
            min(256, M) it selects the bracket scan.

    Branches, in fastbox_tpu's order: with ``s_unwrapped``, K7 when
    max|s_unwrapped - z| <= band*dz and the sort + K3 otherwise; else the
    per-row stable sort, then K8 when every sorted node lies within
    ``band`` cells of its rank, K3 otherwise ('linear'), or the nearest-node
    rule.  Uniform targets of length C are required for the banded tiers.

    Returns:
        (M, T) interpolated values.
    """
    if method not in METHODS:
        raise ValueError(f"Unsupported RSD interpolation method '{method}'")
    M, C = s.shape
    zt_np = None
    if method == "linear" and band > 0:
        zt_np = _uniform_targets(ztarget, ztarget_np, C)

    if (fused and method == "linear" and zt_np is not None
            and s_unwrapped is not None and C & (C - 1) == 0
            and M % min(256, M) == 0):
        dz = float(zt_np[1] - zt_np[0])
        maxdisp = torch.max(torch.abs(s_unwrapped - ztarget[None, :]))
        if _covers(maxdisp, band * dz):
            timing.count(f"rsd.band{band}")
            return rsd_bracket_interp(s.contiguous(), vals.contiguous(),
                                      ztarget, fill, band)
        timing.count("rsd.exact")
        ss, order = torch.sort(s, dim=1, stable=True)
        return interp_sorted(ss, torch.gather(vals, 1, order), ztarget, fill)

    ss, order = torch.sort(s, dim=1, stable=True)
    vv = torch.gather(vals, 1, order)
    if method == "linear":
        # K8 and K3 both apply the hull fill
        if zt_np is not None:
            dz = float(zt_np[1] - zt_np[0])
            maxdisp = torch.max(torch.abs(ss - ztarget[None, :]))
            if _covers(maxdisp, band * dz):
                timing.count(f"rsd.band{band}")
                return banded_interp(ss, vv, ztarget, fill, band)
        timing.count("rsd.exact")
        return interp_sorted(ss, vv, ztarget, fill)

    # 'nearest' (interp1d, fill_value='extrapolate'): the value switches at
    # segment midpoints.  fastbox_tpu sums vv_0 + sum_c dv_c [mid_c < z];
    # the count of midpoints below z indexes the same node directly
    # (searchsorted(mids, z, side='left')), without the (M, C-1, T)
    # temporary.
    mids = 0.5 * (ss[:, 1:] + ss[:, :-1])
    zt = ztarget[None, :].expand(M, ztarget.shape[0]).contiguous()
    idx = torch.searchsorted(mids.contiguous(), zt, side="left")
    return torch.gather(vv, 1, idx)


def pick_band(maxdisp, dz: float, band: int = 4) -> int:
    """2, ``band``, or 0 for the exact tier: the narrowest band covering
    ``maxdisp`` (compared in its dtype, as fastbox_tpu's lax.cond does)."""
    timing.count("sync.rsd_band")
    md = maxdisp.item()
    dt = maxdisp.dtype
    for b in ((2, band) if band > 2 else (band,)):
        if md <= torch.tensor(b * dz, dtype=dt).item():
            return b
    return 0


def _remap_wrap_tiered(vals, vel, ztarget, fill, z0, length_z, inv_hz,
                       dz: float, maxdisp, band: int = 4):
    """Band-2 / band-``band`` bracket kernel, or the exact sort-based
    fallback, picked on the host from the displacement bound."""
    wrap = wrap_params(z0, length_z, inv_hz, vals.dtype, vals.device)
    b = pick_band(maxdisp, dz, band)
    timing.count(f"rsd.band{b}" if b else "rsd.exact")
    if b:
        return rsd_remap_wrap(vals, vel, ztarget, fill, wrap, band=b)
    u = ztarget[None, :] - vel * inv_hz
    s = torch.remainder(u - z0, length_z) + z0
    ss, order = torch.sort(s, dim=1, stable=True)
    vv = torch.gather(vals, 1, order)
    return interp_sorted(ss, vv, ztarget, fill)
