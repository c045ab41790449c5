"""Redshift-space distortion remap and the scaled-normal draw.

Counterpart of ``fastbox_tpu/ops/rsd.py`` (``add_scaled_normal`` :63-91,
``redshift_space_density`` :313-386, ``_remap_wrap_tiered`` :389-420) on
its default TPU path: the wrap-fused bracket kernel K2 at band 2 or band
4, and the sort + exact interpolation kernel K3 beyond.

Semantics matched to the reference:
  * ``s = z - (v_z + v_nl) / H(a)`` (box.py:422)
  * periodic wrap ``s -> (s - z0) mod Lz + z0`` (box.py:425-426)
  * 1-D ``griddata`` linear: targets outside [min(s), max(s)] get the fill
    value ``0.5 (delta[...,0] + delta[...,-1])`` (box.py:429-437)

The tier is chosen on the host from ``maxdisp`` (one ``.item()`` per
realisation, the only host sync of the RSD stage).  Every tier is exact
when its band covers ``maxdisp``.
"""
from __future__ import annotations

import torch

from ..grid import GridSpec
from .cuda.noise import add_scaled_normal_2d
from .cuda.rsd_fused import rsd_remap_wrap, wrap_params
from .cuda.rsd_interp import interp_sorted

__all__ = ["add_scaled_normal", "redshift_space_density"]


def add_scaled_normal(x, scale_row, generator=None, normals=None,
                      return_max: bool = False):
    """x + scale_row[..broadcast..] * N(0,1) along the last axis.

    K1 on a CUDA tensor, its plain twin on a CPU tensor.  The normals come
    from ``generator`` or, when given, from ``normals`` (x's shape).  With
    ``return_max`` also returns ``max|result|`` as a 0-dim tensor — the
    RSD remap's displacement bound.
    """
    shape = x.shape
    C = shape[-1]
    nrm = None if normals is None else normals.reshape(-1, C).contiguous()
    res = add_scaled_normal_2d(x.reshape(-1, C).contiguous(),
                               scale_row.to(x.dtype), generator, nrm,
                               return_max)
    if return_max:
        return res[0].reshape(shape), res[1]
    return res.reshape(shape)


def redshift_space_density(delta_x, velocity_z, grid: GridSpec, Hz: float,
                           sigma_nl: float = 0.0, generator=None,
                           normals=None, method: str = "linear",
                           vmax=None):
    """Remap a real-space density cube to redshift space (box.py:384-438).

    Parameters:
        delta_x: (N,N,N) real-space density field.
        velocity_z: (N,N,N) LOS (z-axis) velocity in km/s.
        grid: static geometry.
        Hz: H(a) in km/s/Mpc.
        sigma_nl: RMS of incoherent small-scale velocities (km/s); when > 0
            they are drawn from ``generator`` or taken from ``normals``.
        method: only 'linear' is ported.
        vmax: optional max|velocity_z| already at hand (a 0-dim tensor),
            which saves a reduction; ignored when sigma_nl > 0.

    Returns:
        delta_s: (N,N,N) redshift-space density field.
    """
    if method != "linear":
        raise NotImplementedError(
            f"rsd method '{method}' is not ported yet (ROADMAP.md A3)")
    rdtype = delta_x.dtype
    dev = delta_x.device
    N = grid.N
    z = torch.as_tensor(grid.z, dtype=rdtype, device=dev)
    z0 = z[0]
    length_z = z[-1] - z[0]

    vel = velocity_z
    if sigma_nl > 0.0:
        vel, vmax = add_scaled_normal(
            vel, torch.full((N,), sigma_nl, dtype=rdtype, device=dev),
            generator, normals, return_max=True)
    elif vmax is None:
        vmax = torch.max(torch.abs(vel))

    fill = 0.5 * (delta_x[..., 0] + delta_x[..., -1])
    inv_hz = 1.0 / torch.tensor(Hz, dtype=rdtype, device=dev)
    maxdisp = vmax * inv_hz
    dz = float(grid.z[1] - grid.z[0])
    out = _remap_wrap_tiered(
        delta_x.reshape(N * N, N).contiguous(),
        vel.reshape(N * N, N).contiguous(), z,
        fill.reshape(N * N).contiguous(), z0, length_z, inv_hz, dz, maxdisp,
        band=4)
    return out.reshape(N, N, N)


def pick_band(maxdisp, dz: float, band: int = 4) -> int:
    """2, ``band``, or 0 for the exact tier: the narrowest band covering
    ``maxdisp`` (compared in its dtype, as fastbox_tpu's lax.cond does)."""
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
    if b:
        return rsd_remap_wrap(vals, vel, ztarget, fill, wrap, band=b)
    u = ztarget[None, :] - vel * inv_hz
    s = torch.remainder(u - z0, length_z) + z0
    ss, order = torch.sort(s, dim=1, stable=True)
    vv = torch.gather(vals, 1, order)
    return interp_sorted(ss, vv, ztarget, fill)
