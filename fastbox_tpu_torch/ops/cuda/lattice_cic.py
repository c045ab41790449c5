"""K11: lattice-ordered CIC paint, gather and three-mesh gather
(csrc/lattice_cic.cu) and their plain twins.

Counterparts of ``fastbox_tpu/ops/pallas/lattice_cic.py``:
``cic_paint_lattice_pallas``, ``cic_gather_lattice_pallas`` and
``cic_gather3_lattice_pallas``.  The plain twins are the roll forms of
``fastbox_tpu_torch/fields/lattice_cic.py``; the kernels compute the same
sums in the same order, so the two agree bit for bit.  The displacements
are a (dx, dy, dz) tuple of contiguous (N, N, N) tensors in cell units,
wrapped to [-N/2, N/2); the COLA band ladder guarantees ``|d| < B`` for
the open band (the default here, as in the engine).  The periodic paint
(K11a) marches blocks of cells down x, one staged plane of sources at a
time, and sums each cell's terms in the twin's order from per-cell masks
of the offsets that reach it; it needs no memory beyond its output.  Each
paint call counts ``latpaint.kernel`` (K11a) or ``latpaint.plain`` (the
twin) on the active ``timing`` clock.

The slab mode (``*_slab``) serves the slab-sharded engine
(``parallel/lattice.py``): an (S, N, N) particle slab, the closed band,
a paint into an (S + 2H, N, N) buffer and a three-mesh gather from
(S + 2H, N, N) halo-extended meshes, H = B + 1 (the JAX roll forms at
``fastbox_tpu/parallel/lattice.py:48-166``).  Its twins are the slab roll
forms of ``fields/lattice_cic.py``; kernel and twin agree bit for bit.
The slab paint is a global counting sort of the particles by the buffer
cell of their lower CIC corner, then one thread per cell summing its 8
buckets in the twin's order; it takes a (C, S, N, N) stack of weight
channels and paints them all on one sort, into (C, S + 2H, N, N).  Its
scratch (a record of 4 dtype words a particle, an int32 a buffer cell)
comes from the caching allocator on the tensors' device.
"""
from __future__ import annotations

import torch

from ... import timing
from ...fields import lattice_cic as twin
from . import _build

__all__ = ["cic_paint_lattice", "cic_gather_lattice", "cic_gather3_lattice",
           "cic_paint_lattice_cuda", "cic_gather_lattice_cuda",
           "cic_gather3_lattice_cuda", "cic_paint_lattice_plain",
           "cic_gather_lattice_plain", "cic_gather3_lattice_plain",
           "cic_paint_lattice_slab", "cic_paint_lattice_slab_cuda",
           "cic_gather3_lattice_slab_cuda", "cic_paint_lattice_slab_plain",
           "cic_gather3_lattice_slab_plain"]

PAINT, GATHER, GATHER3 = ("cic_paint_lattice", "cic_gather_lattice",
                          "cic_gather3_lattice")
PAINT_SLAB, GATHER3_SLAB = ("cic_paint_lattice_slab",
                            "cic_gather3_lattice_slab")
MAX_B = 16  # csrc/lattice_cic.cu kMaxB
# K11a's word of live targets holds the D = hi - lo + 1 <= 32 cell planes a
# source plane feeds: B <= 15 in the open band and the closed
PAINT_MAX_B = 15


def _check(name, meshes, disp, B):
    d = tuple(disp)
    if len(d) != 3:
        raise ValueError(f"{name}: disp must be a (dx, dy, dz) tuple")
    N = d[0].shape[0]
    for t in meshes + d:
        if t.shape != (N, N, N):
            raise ValueError(f"{name}: every tensor must be (N, N, N), "
                             f"got {tuple(t.shape)}")
    if not 1 <= int(B) <= MAX_B:
        raise ValueError(f"{name}: B must be in [1, {MAX_B}], got {B}")
    _build.require_cuda(name, *meshes, *d, dtype=d[0].dtype)
    return d, N


def _check_slab(name, disp, B, sites=(), exts=(), stacks=()):
    """(d, S, N) of a slab call: disp and ``sites`` are (S, N, N), the
    halo-extended ``exts`` (S + 2H, N, N), H = B + 1, and ``stacks`` (C, S,
    N, N) with C >= 1."""
    d = tuple(disp)
    if len(d) != 3:
        raise ValueError(f"{name}: disp must be a (dx, dy, dz) tuple")
    if not 1 <= int(B) <= MAX_B:
        raise ValueError(f"{name}: B must be in [1, {MAX_B}], got {B}")
    S, N = d[0].shape[0], d[0].shape[-1]
    for t in d + tuple(sites):
        if t.shape != (S, N, N):
            raise ValueError(f"{name}: displacements and sites must be "
                             f"(S, N, N) = {(S, N, N)}, got {tuple(t.shape)}")
    for t in exts:
        if t.shape != (S + 2 * (B + 1), N, N):
            raise ValueError(f"{name}: halo-extended meshes must be "
                             f"(S + 2(B + 1), N, N) = "
                             f"{(S + 2 * (B + 1), N, N)}, got "
                             f"{tuple(t.shape)}")
    for t in stacks:
        if t.dim() != 4 or t.shape[0] < 1 or t.shape[1:] != (S, N, N):
            raise ValueError(f"{name}: a weight stack must be (C, S, N, N) "
                             f"with C >= 1 and (S, N, N) = {(S, N, N)}, got "
                             f"{tuple(t.shape)}")
    _build.require_cuda(name, *exts, *d, *sites, *stacks, dtype=d[0].dtype)
    return d, S, N


def _launch(name, stem, dtype, device, *args):
    fn = _build.kernel_fn(stem, dtype)
    with torch.cuda.device(device):
        err = fn(*args, _build.stream_ptr(device))
    _build.check(err, name)
    _build.count_launch(name)


def cic_paint_lattice_cuda(disp, B: int, weights=None, openband: bool = True):
    if int(B) > PAINT_MAX_B:
        raise ValueError(f"{PAINT}: B must be in [1, {PAINT_MAX_B}] for the "
                         f"periodic paint, got {B}")
    d, N = _check(PAINT, () if weights is None else (weights,), disp, B)
    out = torch.empty((N, N, N), dtype=d[0].dtype, device=d[0].device)
    _launch(PAINT, "fbx_cic_paint_lattice", out.dtype, out.device,
            *(t.data_ptr() for t in d), _build.ptr(weights), out.data_ptr(),
            N, int(B), int(bool(openband)))
    timing.count("latpaint.kernel")
    return out


def cic_gather_lattice_cuda(mesh, disp, B: int, openband: bool = True):
    d, N = _check(GATHER, (mesh,), disp, B)
    out = torch.empty_like(mesh)
    _launch(GATHER, "fbx_cic_gather_lattice", out.dtype, out.device,
            mesh.data_ptr(), *(t.data_ptr() for t in d), out.data_ptr(), N,
            int(B), int(bool(openband)))
    return out


def cic_gather3_lattice_cuda(meshes, disp, B: int, openband: bool = True,
                             out=None):
    """``out``: three (N, N, N) tensors to gather into (the rows of the COLA
    engine's force array), else new ones; they must not overlap the
    inputs."""
    meshes = tuple(meshes)
    if len(meshes) != 3:
        raise ValueError(f"{GATHER3}: needs three meshes")
    outs = tuple(torch.empty_like(m) for m in meshes) if out is None \
        else tuple(out)
    if len(outs) != 3:
        raise ValueError(f"{GATHER3}: out must be three tensors")
    d, N = _check(GATHER3, meshes + outs, disp, B)
    ins = {t.untyped_storage().data_ptr() for t in meshes + d}
    if any(o.untyped_storage().data_ptr() in ins for o in outs):
        raise ValueError(f"{GATHER3}: out shares storage with an input")
    _launch(GATHER3, "fbx_cic_gather3_lattice", outs[0].dtype,
            outs[0].device, *(m.data_ptr() for m in meshes),
            *(t.data_ptr() for t in d), *(o.data_ptr() for o in outs), N,
            int(B), int(bool(openband)))
    return outs


def _stacked(weights) -> bool:
    """Whether slab-paint ``weights`` is a (C, S, N, N) channel stack."""
    return weights is not None and weights.dim() != 3


def cic_paint_lattice_slab_cuda(disp, B: int, weights=None):
    """K11a in slab mode: the (S + 2H, N, N) buffer of an (S, N, N) slab,
    or with a (C, S, N, N) weight stack its (C, S + 2H, N, N) buffers, all
    channels in one launch."""
    stack = _stacked(weights)
    d, S, N = _check_slab(
        PAINT_SLAB, disp, B,
        sites=() if weights is None or stack else (weights,),
        stacks=(weights,) if stack else ())
    C = weights.shape[0] if stack else 1
    out = torch.empty(((C,) if stack else ()) + (S + 2 * (B + 1), N, N),
                      dtype=d[0].dtype, device=d[0].device)
    words = _build.load_library().fbx_cic_paint_lattice_slab_scratch(
        S, N, int(B), out.element_size())
    if words < 0:
        raise ValueError(f"{PAINT_SLAB}: a slab of {(S, N, N)} at B = {B} is "
                         "beyond the kernel's int32 bucket starts")
    scratch = torch.empty(words, dtype=torch.int32, device=out.device)
    _launch(PAINT_SLAB, "fbx_cic_paint_lattice_slab", out.dtype, out.device,
            *(t.data_ptr() for t in d), _build.ptr(weights), C,
            out.data_ptr(), S, N, int(B), scratch.data_ptr())
    return out


def cic_gather3_lattice_slab_cuda(exts, disp, B: int, out=None):
    """K11c in slab mode: three (S, N, N) gathers from three halo-extended
    (S + 2H, N, N) meshes; ``out`` as in :func:`cic_gather3_lattice_cuda`."""
    exts = tuple(exts)
    if len(exts) != 3:
        raise ValueError(f"{GATHER3_SLAB}: needs three meshes")
    d0 = tuple(disp)[0]
    outs = tuple(torch.empty_like(d0) for _ in range(3)) if out is None \
        else tuple(out)
    if len(outs) != 3:
        raise ValueError(f"{GATHER3_SLAB}: out must be three tensors")
    d, S, N = _check_slab(GATHER3_SLAB, disp, B, outs, exts)
    ins = {t.untyped_storage().data_ptr() for t in exts + d}
    if any(o.untyped_storage().data_ptr() in ins for o in outs):
        raise ValueError(f"{GATHER3_SLAB}: out shares storage with an input")
    _launch(GATHER3_SLAB, "fbx_cic_gather3_lattice_slab", outs[0].dtype,
            outs[0].device, *(m.data_ptr() for m in exts),
            *(t.data_ptr() for t in d), *(o.data_ptr() for o in outs), S, N,
            int(B))
    return outs


def cic_paint_lattice_slab_plain(disp, B: int, weights=None):
    """The slab twin; a (C, S, N, N) weight stack is C twin paints."""
    if _stacked(weights):
        return torch.stack([twin.cic_paint_lattice_slab(tuple(disp), B, w)
                            for w in weights])
    return twin.cic_paint_lattice_slab(tuple(disp), B, weights)


def cic_gather3_lattice_slab_plain(exts, disp, B: int):
    return twin.cic_gather3_lattice_slab(tuple(exts), tuple(disp), B)


def cic_paint_lattice_plain(disp, B: int, weights=None, openband: bool = True):
    timing.count("latpaint.plain")
    return twin.cic_paint_lattice(tuple(disp), B, weights, openband)


def cic_gather_lattice_plain(mesh, disp, B: int, openband: bool = True):
    return twin.cic_gather_lattice(mesh, tuple(disp), B, openband)


def cic_gather3_lattice_plain(meshes, disp, B: int, openband: bool = True):
    return twin.cic_gather3_lattice(tuple(meshes), tuple(disp), B, openband)


def _on(name, t):
    if t.device.type in ("cuda", "cpu"):
        return t.device.type
    raise ValueError(f"{name}: unsupported device {t.device}")


def cic_paint_lattice(disp, B: int, weights=None, openband: bool = True):
    """K11 paint on CUDA tensors, the plain twin on CPU tensors."""
    if _on(PAINT, disp[0]) == "cuda":
        return cic_paint_lattice_cuda(disp, B, weights, openband)
    return cic_paint_lattice_plain(disp, B, weights, openband)


def cic_gather_lattice(mesh, disp, B: int, openband: bool = True):
    """K11 gather on CUDA tensors, the plain twin on CPU tensors."""
    if _on(GATHER, mesh) == "cuda":
        return cic_gather_lattice_cuda(mesh, disp, B, openband)
    return cic_gather_lattice_plain(mesh, disp, B, openband)


def cic_gather3_lattice(meshes, disp, B: int, openband: bool = True):
    """K11 three-mesh gather on CUDA tensors, three twin gathers on CPU
    tensors."""
    if _on(GATHER3, meshes[0]) == "cuda":
        return cic_gather3_lattice_cuda(meshes, disp, B, openband)
    return cic_gather3_lattice_plain(meshes, disp, B, openband)


def cic_paint_lattice_slab(disp, B: int, weights=None):
    """K11a's slab mode on CUDA tensors, the slab twin on CPU tensors;
    ``weights`` (S, N, N), or a (C, S, N, N) stack painted on one sort."""
    if _on(PAINT_SLAB, disp[0]) == "cuda":
        return cic_paint_lattice_slab_cuda(disp, B, weights)
    return cic_paint_lattice_slab_plain(disp, B, weights)
