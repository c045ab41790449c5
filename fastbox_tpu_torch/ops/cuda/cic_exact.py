"""K13: COLA's exact CIC tier in one pass (csrc/cic_exact.cu), the paint
K13a and the gather of one or three meshes K13b, and their plain passes.

K13 replaces no Pallas kernel: ``fastbox_tpu``'s exact tier
(``fastbox_tpu/fields/cola.py``) is XLA's ``.at[].add`` scatter and a
gathered sum.  The plain passes are the port's tier as PyTorch writes it:
per axis the two cells of each position and their weights (``_corners``),
then eight ``index_add_`` calls or eight gathered terms.  The kernels work
out the same corners in registers.  K13b sums each output in the plain
order with every operation rounded on its own, so the two are bitwise
equal; K13a adds the plain path's contributions by atomics, in another
order.  Positions are cell units, any finite real, as a (ux, uy, uz) tuple
of (M,) tensors or an (M, 3) tensor; the mesh side ``Nm`` is given apart
from M (a force mesh ``force_factor`` times finer than the particle
grid).  Each call counts ``exactcic.fused`` (the kernel) or
``exactcic.plain`` (the passes) once.
"""
from __future__ import annotations

import torch

from ... import timing
from . import _build

__all__ = ["cic_paint_exact", "cic_gather_exact", "cic_paint_exact_cuda",
           "cic_gather_exact_cuda", "cic_paint_exact_plain",
           "cic_gather_exact_plain"]

PAINT, GATHER = "cic_paint_exact", "cic_gather_exact"


def _axes(u):
    """Positions as (ux, uy, uz): from a tuple of flat components or an
    (M, 3) tensor."""
    if isinstance(u, (tuple, list)):
        return tuple(u)
    return u[:, 0], u[:, 1], u[:, 2]


def _corners(u, N: int):
    """Per axis, the two CIC cells of each position and their weights:
    [(floor mod N, 1 - frac), (floor + 1 mod N, frac)]."""
    out = []
    for a in u:
        fl = torch.floor(a)
        fr = a - fl
        i0 = fl.long()
        out.append(((torch.remainder(i0, N), 1.0 - fr),
                    (torch.remainder(i0 + 1, N), fr)))
    return out


def cic_paint_exact_plain(u, N: int, weights=None):
    """Scatter particles at positions ``u`` onto an (N, N, N) periodic mesh
    with CIC weights, by ``index_add_``."""
    cx, cy, cz = _corners(_axes(u), N)
    ref = cx[0][1]
    mesh = torch.zeros(N**3, dtype=ref.dtype, device=ref.device)
    for ix, wx in cx:
        px = wx if weights is None else weights * wx
        for iy, wy in cy:
            pxy = px * wy
            row = ix * N + iy
            for iz, wz in cz:
                mesh.index_add_(0, row * N + iz, pxy * wz)
    timing.count("exactcic.plain")
    return mesh.reshape(N, N, N)


def cic_gather_exact_plain(meshes, u):
    """Trilinear (CIC) interpolation of each periodic (Nm, Nm, Nm) mesh of
    ``meshes`` at positions ``u``: a tuple of (M,) values a mesh.  The
    corners are built once for all meshes; each sum is the one-mesh
    gather's, term by term."""
    N = meshes[0].shape[0]
    flats = [m.reshape(-1) for m in meshes]
    cx, cy, cz = _corners(_axes(u), N)
    outs = [torch.zeros_like(cx[0][1]) for _ in flats]
    for ix, wx in cx:
        for iy, wy in cy:
            row = ix * N + iy
            for iz, wz in cz:
                idx = row * N + iz
                outs = [o + f[idx] * wx * wy * wz
                        for o, f in zip(outs, flats)]
    timing.count("exactcic.plain")
    return tuple(outs)


def _check_positions(name, u):
    """(ux, uy, uz) and M: three (M,) tensors."""
    ax = tuple(u)
    if len(ax) != 3:
        raise ValueError(f"{name}: positions must be a (ux, uy, uz) tuple")
    M = ax[0].numel()
    for a in ax:
        if a.dim() != 1 or a.numel() != M:
            raise ValueError(f"{name}: positions must be three (M,) tensors, "
                             f"got {[tuple(t.shape) for t in ax]}")
    return ax, M


def _check_tensors(name, *tensors):
    """The one dtype, float32 or float64, of contiguous CUDA tensors on one
    device; raises on anything else."""
    dtype = tensors[0].dtype
    for t in tensors:
        if t.dtype != dtype or dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{name}: expected one dtype, float32 or "
                            f"float64, got {dtype} and {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    _build.require_cuda(name, *tensors, dtype=dtype)
    return dtype


def _launch(name, stem, dtype, device, *args):
    fn = _build.kernel_fn(stem, dtype)
    with torch.cuda.device(device):
        err = fn(*args, _build.stream_ptr(device))
    _build.check(err, name)
    _build.count_launch(name)
    timing.count("exactcic.fused")


def cic_paint_exact_cuda(u, N: int, weights=None):
    """K13a: the (N, N, N) mesh of CIC paints of positions ``u`` (a (ux,
    uy, uz) tuple of contiguous (M,) tensors), weighted by ``weights`` (M,)
    if given."""
    ax, M = _check_positions(PAINT, u)
    ws = () if weights is None else (weights,)
    if weights is not None and weights.shape != (M,):
        raise ValueError(f"{PAINT}: weights must be (M,) = {(M,)}, got "
                         f"{tuple(weights.shape)}")
    if int(N) < 1:
        raise ValueError(f"{PAINT}: the mesh side must be >= 1, got {N}")
    dtype = _check_tensors(PAINT, *ax, *ws)
    mesh = torch.zeros((N, N, N), dtype=dtype, device=ax[0].device)
    _launch(PAINT, "fbx_cic_paint_exact", dtype, mesh.device,
            *(a.data_ptr() for a in ax), _build.ptr(weights),
            mesh.data_ptr(), M, int(N))
    return mesh


def cic_gather_exact_cuda(meshes, u, out=None):
    """K13b: one or three contiguous (Nm, Nm, Nm) meshes gathered at
    positions ``u`` (as in :func:`cic_paint_exact_cuda`); returns a tuple
    of (M,) values a mesh, written into ``out`` (one contiguous (M,) tensor
    a mesh, overlapping no input) where given."""
    meshes = tuple(meshes)
    if len(meshes) not in (1, 3):
        raise ValueError(f"{GATHER}: needs one or three meshes, got "
                         f"{len(meshes)}")
    ax, M = _check_positions(GATHER, u)
    Nm = meshes[0].shape[0]
    for m in meshes:
        if m.shape != (Nm, Nm, Nm):
            raise ValueError(f"{GATHER}: meshes must be (Nm, Nm, Nm) = "
                             f"{(Nm, Nm, Nm)}, got {tuple(m.shape)}")
    outs = tuple(torch.empty_like(ax[0]) for _ in meshes) if out is None \
        else tuple(out)
    if len(outs) != len(meshes):
        raise ValueError(f"{GATHER}: out must hold one tensor a mesh")
    for o in outs:
        if o.shape != (M,):
            raise ValueError(f"{GATHER}: out must be (M,) = {(M,)}, got "
                             f"{tuple(o.shape)}")
    dtype = _check_tensors(GATHER, *meshes, *ax, *outs)
    ins = {t.untyped_storage().data_ptr() for t in meshes + ax}
    if any(o.untyped_storage().data_ptr() in ins for o in outs):
        raise ValueError(f"{GATHER}: out shares storage with an input")
    pad = (None,) * (3 - len(meshes))
    _launch(GATHER, "fbx_cic_gather_exact", dtype, outs[0].device,
            *(m.data_ptr() for m in meshes), *pad,
            *(a.data_ptr() for a in ax),
            *(o.data_ptr() for o in outs), *pad, M, Nm, len(meshes))
    return outs


def _on_card(t, name: str) -> bool:
    if t.device.type in ("cuda", "cpu"):
        return t.device.type == "cuda"
    raise ValueError(f"{name}: unsupported device {t.device}")


def cic_paint_exact(u, N: int, weights=None):
    """Scatter particles at positions ``u`` (cell units, any real; (M, 3)
    or a (ux, uy, uz) tuple of (M,) tensors) onto an (N, N, N) periodic
    mesh with CIC weights: K13a on CUDA tensors (atomic sums), eight
    ``index_add_`` on CPU tensors."""
    ax = _axes(u)
    if _on_card(ax[0], PAINT):
        return cic_paint_exact_cuda(
            tuple(a.contiguous() for a in ax), N,
            None if weights is None else weights.contiguous())
    return cic_paint_exact_plain(ax, N, weights)


def cic_gather_exact(meshes, u, out=None):
    """Trilinear (CIC) interpolation of each of the periodic (Nm, Nm, Nm)
    ``meshes`` (one or three) at positions ``u`` (cell units; (M, 3) or a
    component tuple): a tuple of (M,) values a mesh, written into ``out``
    (one (M,) tensor a mesh) where given.  K13b on CUDA tensors, the plain
    passes on CPU tensors, bitwise equal; each mesh's values are those of
    a gather of that mesh alone."""
    meshes = tuple(meshes)
    if _on_card(meshes[0], GATHER):
        return cic_gather_exact_cuda(
            meshes, tuple(a.contiguous() for a in _axes(u)), out)
    got = cic_gather_exact_plain(meshes, u)
    if out is None:
        return got
    for o, g in zip(out, got):
        o.copy_(g)
    return tuple(out)
