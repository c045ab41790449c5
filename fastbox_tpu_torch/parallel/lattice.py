"""Slab-sharded lattice CIC paint and gather with a halo exchange.

Counterpart of ``fastbox_tpu/parallel/lattice.py``.  Each rank of the
'space' group holds an (S, N, N) slab of the lattice-ordered particles
(rows [r S, (r+1) S) of the leading axis).  A particle with wrapped
displacement ``|d| <= B`` cells reaches cells ``o`` in [-B, B+1] away, so
a slab spills at most ``H = B + 1`` rows into each neighbour (S >= H).
The paint fills an (S + 2H)-row buffer and ships its two H-row strips to
the neighbours; the gather first builds an (S + 2H)-row halo-extended mesh
from the neighbours' edge rows.  Each ``lax.ppermute`` of fastbox_tpu is
a strip exchange here (``torch.distributed.batch_isend_irecv``); with one
rank the strips wrap onto the rank's own slab without a collective.

On CUDA tensors the paint and the gather run K11a and K11c in their slab
mode (``ops/cuda/lattice_cic.py``), on CPU tensors their twins, the roll
sums of ``fields/lattice_cic.py``; the two agree bit for bit.  The
received strips are added in fastbox_tpu's order: head, then tail.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..fields import lattice_cic as twin
from ..fields.lattice_cic import _disp_axes
from ..ops.cuda import lattice_cic as k11
from .mesh import collective

__all__ = ["halo_extend", "halo_paint", "halo_paint_many", "halo_gather",
           "halo_gather_many"]


def _exchange(to_prev, to_next, group):
    """Send ``to_prev`` to the previous rank of ``group`` and ``to_next`` to
    the next (periodically); returns (what the previous rank sent to its
    next, what the next rank sent to its previous).  With two ranks both
    neighbours are one peer: the strips travel in one order with distinct
    tags, so they cannot swap."""
    P = dist.get_world_size(group)
    if P == 1:
        return to_next, to_prev
    r = dist.get_rank(group)
    prev = dist.get_global_rank(group, (r - 1) % P)
    nxt = dist.get_global_rank(group, (r + 1) % P)
    to_prev, to_next = to_prev.contiguous(), to_next.contiguous()
    from_prev, from_next = torch.empty_like(to_next), torch.empty_like(to_prev)
    ops = [dist.P2POp(dist.isend, to_next, nxt, group, 1),
           dist.P2POp(dist.isend, to_prev, prev, group, 2),
           dist.P2POp(dist.irecv, from_prev, prev, group, 1),
           dist.P2POp(dist.irecv, from_next, nxt, group, 2)]
    collective(to_next, to_prev)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return from_prev, from_next


def _check_rows(S: int, B: int) -> int:
    H = B + 1
    if S < H:
        raise ValueError(f"slab height {S} must be >= B+1 = {H}: use fewer "
                         "ranks on 'space' or a smaller band")
    return H


def halo_extend(mesh, H: int, group):
    """Extend slabs ``(..., S, N, N)`` (the slab axis third from last) with
    H ghost rows from each periodic neighbour -> ``(..., S + 2H, N, N)``."""
    S = mesh.shape[-3]
    prev_tail, next_head = _exchange(mesh.narrow(-3, 0, H),
                                     mesh.narrow(-3, S - H, H), group)
    return torch.cat([prev_tail, mesh, next_head], dim=-3)


def _fold(buf, S: int, H: int, group):
    """The slab's rows of an (..., S + 2H, N, N) paint buffer, with the
    neighbours' strips added: the previous rank's tail strip onto the first
    H rows, then the next rank's head strip onto the last H."""
    recv_head, recv_tail = _exchange(buf.narrow(-3, 0, H),
                                     buf.narrow(-3, H + S, H), group)
    core = buf.narrow(-3, H, S).clone()
    core.narrow(-3, 0, H).add_(recv_head)
    core.narrow(-3, S - H, H).add_(recv_tail)
    return core


def halo_paint(disp, B: int, group, weights=None):
    """Periodic CIC paint of a lattice-ordered particle slab.

    Parameters:
        disp: (dx, dy, dz) or (S, N, N, 3) wrapped displacements of this
            rank's particles from their lattice sites, in cells, ``|d| <= B``
            (S = N / ranks >= B + 1).
        B: the displacement bound in cells (closed band).
        group: the 'space' process group of the slab decomposition.
        weights: optional (S, N, N) per-particle weights.

    Returns:
        (S, N, N): this rank's rows of the summed CIC weights, the
        neighbours' halo contributions included.
    """
    d = tuple(t.contiguous() for t in _disp_axes(disp))
    S = d[0].shape[0]
    H = _check_rows(S, B)
    buf = k11.cic_paint_lattice_slab(
        d, B, None if weights is None else weights.contiguous())
    return _fold(buf, S, H, group)


def halo_paint_many(disp, B: int, group, weights):
    """:func:`halo_paint` of a channel stack ``weights`` (C, S, N, N) with
    one strip exchange for all channels; returns (C, S, N, N).  On the card
    one K11a launch paints every channel."""
    d = tuple(t.contiguous() for t in _disp_axes(disp))
    S = d[0].shape[0]
    H = _check_rows(S, B)
    buf = k11.cic_paint_lattice_slab(d, B, weights.contiguous())
    return _fold(buf, S, H, group)


def halo_gather_many(meshes, disp, B: int, group):
    """CIC interpolation of C slab-sharded periodic meshes (C, S, N, N) at
    the particles of this rank's slab, with one halo extension for all
    channels; returns (C, S, N, N).

    K11c gathers three meshes per launch: on the card the channels go in
    threes, a last group of fewer repeating its last mesh."""
    d = tuple(t.contiguous() for t in _disp_axes(disp))
    S = meshes.shape[-3]
    H = _check_rows(S, B)
    ext = halo_extend(meshes, H, group)
    C = ext.shape[0]
    if ext.device.type != "cuda":
        return torch.stack([twin.cic_gather_lattice_slab(ext[c], d, B)
                            for c in range(C)])
    out = torch.empty((C,) + tuple(d[0].shape), dtype=ext.dtype,
                      device=ext.device)
    for c in range(0, C, 3):
        k11.cic_gather3_lattice_slab_cuda(
            tuple(ext[min(c + j, C - 1)] for j in range(3)), d, B,
            out=[out[c + j] if c + j < C else torch.empty_like(d[0])
                 for j in range(3)])
    return out


def halo_gather(mesh, disp, B: int, group):
    """CIC interpolation of a slab-sharded periodic mesh (S, N, N) at this
    rank's particles, the adjoint of :func:`halo_paint`; returns (S, N, N).
    """
    return halo_gather_many(mesh[None], disp, B, group)[0]
