"""K11: lattice-ordered CIC paint, gather and three-mesh gather
(csrc/lattice_cic.cu) and their plain twins.

Counterparts of ``fastbox_tpu/ops/pallas/lattice_cic.py``:
``cic_paint_lattice_pallas``, ``cic_gather_lattice_pallas`` and
``cic_gather3_lattice_pallas``.  The plain twins are the roll forms of
``fastbox_tpu_torch/fields/lattice_cic.py``; the kernels compute the same
sums in the same order, so the two agree bit for bit.  The displacements
are a (dx, dy, dz) tuple of contiguous (N, N, N) tensors in cell units,
wrapped to [-N/2, N/2); the COLA band ladder guarantees ``|d| < B`` for
the open band (the default here, as in the engine).
"""
from __future__ import annotations

import torch

from ...fields import lattice_cic as twin
from . import _build

__all__ = ["cic_paint_lattice", "cic_gather_lattice", "cic_gather3_lattice",
           "cic_paint_lattice_cuda", "cic_gather_lattice_cuda",
           "cic_gather3_lattice_cuda", "cic_paint_lattice_plain",
           "cic_gather_lattice_plain", "cic_gather3_lattice_plain"]

PAINT, GATHER, GATHER3 = ("cic_paint_lattice", "cic_gather_lattice",
                          "cic_gather3_lattice")
MAX_B = 16  # csrc/lattice_cic.cu kMaxB


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


def _launch(name, stem, dtype, device, *args):
    fn = _build.kernel_fn(stem, dtype)
    with torch.cuda.device(device):
        err = fn(*args, _build.stream_ptr(device))
    _build.check(err, name)
    _build.count_launch(name)


def cic_paint_lattice_cuda(disp, B: int, weights=None, openband: bool = True):
    d, N = _check(PAINT, () if weights is None else (weights,), disp, B)
    out = torch.empty((N, N, N), dtype=d[0].dtype, device=d[0].device)
    _launch(PAINT, "fbx_cic_paint_lattice", out.dtype, out.device,
            *(t.data_ptr() for t in d), _build.ptr(weights), out.data_ptr(),
            N, int(B), int(bool(openband)))
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


def cic_paint_lattice_plain(disp, B: int, weights=None, openband: bool = True):
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
