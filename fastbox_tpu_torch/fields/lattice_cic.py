"""Lattice-ordered CIC paint/gather as periodic rolls: the plain twin of K11.

Torch counterpart of ``fastbox_tpu/fields/lattice_cic.py``.  A PM
particle array never reorders, so it IS an (N, N, N) grid in Lagrangian
order, and each particle's wrapped displacement from its own lattice site
is bounded by a few cells.  With ``|d| <= B`` the CIC cloud of the
particle at site ``l`` touches only cells ``l + o`` with per-axis offsets
``o`` in ``[-B, B+1]`` (closed band), or in ``[-B, B]`` when ``|d| < B``
strictly (open band, the ``openband`` flag of
``fastbox_tpu/ops/pallas/lattice_cic.py:62-78``).  The scatter-add becomes
a sum of rolled elementwise weight products, the gather the same sum with
the mesh rolled the other way.

This is the plain version of the CUDA kernels in
``ops/cuda/lattice_cic.py`` (csrc/lattice_cic.cu), which compute the same
sums in the same order.  Exact (summation order aside) against the scatter
``fields/cola.py::cic_paint_particles`` / ``cic_gather`` whenever the
bound holds; callers check it.

The slab forms (``cic_paint_lattice_slab`` and the gathers) are the roll
sums of the slab-sharded engine (``fastbox_tpu/parallel/lattice.py:48-87,
:119-166``): an (S, N, N) slab of particles, the closed band, x not
periodic.  The paint fills an (S + 2H, N, N) buffer (H = B + 1) whose
first and last H rows belong to the neighbouring slabs; the gathers read
a halo-extended (S + 2H, N, N) mesh.
"""
from __future__ import annotations

import torch

__all__ = ["cic_paint_lattice", "cic_gather_lattice", "cic_gather3_lattice",
           "cic_paint_lattice_slab", "cic_gather_lattice_slab",
           "cic_gather3_lattice_slab", "wrapped_displacement",
           "wrapped_displacement_axes"]


def wrapped_displacement(u, N: int):
    """Map positions ``u`` (cell units, shape (N, N, N, 3)) to each
    particle's periodic displacement from its own lattice site, in
    [-N/2, N/2)."""
    idx = torch.stack(torch.meshgrid(
        *(torch.arange(s, dtype=u.dtype, device=u.device)
          for s in u.shape[:-1]), indexing="ij"), dim=-1)
    return torch.remainder(u - idx + N / 2.0, N) - N / 2.0


def wrapped_displacement_axes(u3, N: int):
    """Per-axis wrapped displacements of SoA positions ``u3`` (3, N, N, N):
    a (dx, dy, dz) tuple of contiguous (N, N, N) tensors, the form every
    lattice kernel takes.  Floor-mod is ``torch.remainder`` (``jnp.mod``)."""
    ax = torch.arange(N, dtype=u3.dtype, device=u3.device)
    out = []
    for i, idx in enumerate((ax[:, None, None], ax[None, :, None],
                             ax[None, None, :])):
        d = u3[i] - idx
        out.append(torch.remainder(d + N / 2.0, N) - N / 2.0)
    return tuple(out)


def _disp_axes(disp):
    """(dx, dy, dz) from a tuple or an (N, N, N, 3) tensor."""
    if isinstance(disp, (tuple, list)):
        return tuple(disp)
    return disp[..., 0], disp[..., 1], disp[..., 2]


def _offsets(B: int, openband: bool):
    return range(-B, B + 1 if openband else B + 2)


def _axis_weights(d, B: int, openband: bool):
    """{o: weight field} of one axis: the cloud covers floor(d) (weight
    1-frac) and floor(d)+1 (weight frac)."""
    fl = torch.floor(d)
    fr = d - fl
    return {o: (1.0 - fr) * (fl == o) + fr * (fl == o - 1)
            for o in _offsets(B, openband)}


def cic_paint_lattice(disp, B: int = 2, weights=None, openband: bool = False):
    """Periodic CIC paint of lattice-ordered particles via rolls.

    Parameters:
        disp: (dx, dy, dz) or (N, N, N, 3) displacements from the lattice
            sites in CELL units, wrapped to [-N/2, N/2); exact when
            ``|disp| <= B`` (``< B`` with ``openband``).
        B: displacement bound in cells.
        weights: optional (N, N, N) per-particle weights (default 1).
        openband: offsets [-B, B] instead of [-B, B+1].

    Returns:
        (N, N, N) mesh of summed CIC weights.
    """
    dx, dy, dz = _disp_axes(disp)
    wx = _axis_weights(dx, B, openband)
    wy = _axis_weights(dy, B, openband)
    wz = _axis_weights(dz, B, openband)
    offs = _offsets(B, openband)
    mesh = None
    for ox in offs:
        px = wx[ox] if weights is None else wx[ox] * weights
        sx = None
        for oy in offs:
            pxy = px * wy[oy]
            sy = None
            for oz in offs:
                t = torch.roll(pxy * wz[oz], oz, 2)
                sy = t if sy is None else sy + t
            sy = torch.roll(sy, oy, 1)
            sx = sy if sx is None else sx + sy
        sx = torch.roll(sx, ox, 0)
        mesh = sx if mesh is None else mesh + sx
    return mesh


def cic_gather_lattice(mesh, disp, B: int = 2, openband: bool = False):
    """Trilinear (CIC) interpolation of a periodic mesh at lattice-ordered
    particle positions via rolls, the adjoint of ``cic_paint_lattice``.

    Returns:
        (N, N, N) interpolated values, one per particle.
    """
    dx, dy, dz = _disp_axes(disp)
    wx = _axis_weights(dx, B, openband)
    wy = _axis_weights(dy, B, openband)
    wz = _axis_weights(dz, B, openband)
    offs = _offsets(B, openband)
    out = None
    for oz in offs:
        rz = torch.roll(mesh, -oz, 2)
        for oy in offs:
            ryz = torch.roll(rz, -oy, 1)
            sx = None
            for ox in offs:
                t = wx[ox] * torch.roll(ryz, -ox, 0)
                sx = t if sx is None else sx + t
            term = wy[oy] * wz[oz] * sx
            out = term if out is None else out + term
    return out


def cic_gather3_lattice(meshes, disp, B: int = 2, openband: bool = False):
    """``cic_gather_lattice`` of three meshes at the same particles (the
    PM force components): three gathers."""
    return tuple(cic_gather_lattice(m, disp, B, openband) for m in meshes)


def cic_paint_lattice_slab(disp, B: int, weights=None):
    """CIC paint of an (S, N, N) particle slab into an (S + 2H, N, N)
    buffer, H = B + 1, closed band: particle row s lands on buffer rows
    H + s + o, y and z wrap (``buf`` of fastbox_tpu/parallel/lattice.py:
    64-87).  ``weights``: optional (S, N, N)."""
    dx, dy, dz = _disp_axes(disp)
    S = dx.shape[0]
    H = B + 1
    wx = _axis_weights(dx, B, False)
    wy = _axis_weights(dy, B, False)
    wz = _axis_weights(dz, B, False)
    buf = None
    for ox in _offsets(B, False):
        px = wx[ox] if weights is None else wx[ox] * weights
        sx = None
        for oy in _offsets(B, False):
            pxy = px * wy[oy]
            sy = None
            for oz in _offsets(B, False):
                t = torch.roll(pxy * wz[oz], oz, 2)
                sy = t if sy is None else sy + t
            sy = torch.roll(sy, oy, 1)
            sx = sy if sx is None else sx + sy
        if buf is None:
            buf = sx.new_zeros((S + 2 * H,) + tuple(sx.shape[1:]))
        buf[H + ox:H + ox + S] += sx
    return buf


def cic_gather_lattice_slab(ext, disp, B: int):
    """CIC interpolation of a halo-extended (S + 2H, N, N) mesh at an (S, N,
    N) particle slab, closed band: the adjoint of
    :func:`cic_paint_lattice_slab` (fastbox_tpu/parallel/lattice.py:
    135-166)."""
    dx, dy, dz = _disp_axes(disp)
    S = dx.shape[0]
    H = B + 1
    wx = _axis_weights(dx, B, False)
    wy = _axis_weights(dy, B, False)
    wz = _axis_weights(dz, B, False)
    out = None
    for oz in _offsets(B, False):
        rz = torch.roll(ext, -oz, 2)
        for oy in _offsets(B, False):
            ryz = torch.roll(rz, -oy, 1)
            sx = None
            for ox in _offsets(B, False):
                t = wx[ox] * ryz[H + ox:H + ox + S]
                sx = t if sx is None else sx + t
            term = wy[oy] * wz[oz] * sx
            out = term if out is None else out + term
    return out


def cic_gather3_lattice_slab(exts, disp, B: int):
    """``cic_gather_lattice_slab`` of three halo-extended meshes (the PM
    force components): three gathers."""
    return tuple(cic_gather_lattice_slab(m, disp, B) for m in exts)
