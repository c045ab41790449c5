"""Field checkpoint / resume (counterpart of fastbox_tpu/io.py).

The npz helpers save named tensors (complex and CUDA tensors too, through
the host) and load them onto a device.  ``save_box`` / ``load_box`` write
and read fastbox_tpu's box format: the same ``__meta__`` JSON (the grid and
cosmology dataclasses, the dtype as numpy's name) and field names, so a box
saved by either package loads into the other.

For SLAB-SHARDED cubes use :func:`save_sharded` / :func:`load_sharded`, on
``torch.distributed.checkpoint``: every rank writes its own rows and nothing
is gathered, the counterpart of fastbox_tpu's orbax checkpoint.  A plain
tensor is taken for a replicated one by the checkpointer, which then
writes rank 0's copy alone; a slab given as a plain tensor would lose every
other rank's rows, so ``save_sharded`` wraps plain tensors as this rank's
rows over the mesh's 'space' axis, and refuses them without a mesh on more
than one rank.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from .device import resolve

__all__ = ["save_box", "load_box", "save_fields", "load_fields",
           "save_sharded", "load_sharded"]

_FIELDS = ("delta_x", "delta_k", "phi_k")


def _host(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def save_fields(path: str, **fields):
    """Save named tensors to an npz file (complex and CUDA tensors
    supported); None values are skipped."""
    np.savez_compressed(path, **{k: _host(v) for k, v in fields.items()
                                 if v is not None})


def load_fields(path: str, device=None) -> dict:
    """Load an npz of fields back as tensors on ``device`` (None: the
    card)."""
    device = resolve(device)
    with np.load(path) as data:
        return {k: torch.as_tensor(data[k], device=device) for k in data.files}


def _slab_tree(tree, mesh):
    """``tree`` with each plain tensor leaf made this rank's rows of a
    ``DTensor`` sharded over the mesh's 'space' axis (replicated over
    'ens'); ``DTensor`` leaves stay as they are."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if isinstance(tree, dict):
        return {k: _slab_tree(v, mesh) for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor) or isinstance(tree, DTensor):
        return tree
    if mesh is None:
        if dist.is_initialized() and dist.get_world_size() > 1:
            raise ValueError(
                "save_sharded: a plain tensor on more than one rank needs "
                "the mesh (it is saved as this rank's rows over 'space'); "
                "the checkpointer would keep rank 0's copy alone")
        return tree
    return DTensor.from_local(tree.contiguous(), mesh,
                              [Replicate(), Shard(0)], run_check=False)


def save_sharded(path: str, tree: dict, mesh=None):
    """Checkpoint a dict (nested dicts allowed) of slab-sharded tensors.

    Each rank writes its own rows; nothing is gathered.  ``DTensor`` leaves
    are saved as they are.  With ``mesh`` (``parallel.make_mesh``'s
    ('ens', 'space') mesh) a plain tensor leaf is this rank's rows of a
    cube sharded over 'space' along its first axis, replicated over
    'ens'.  Without a mesh, plain tensors are saved whole from a single
    process and refused on more than one rank.  ``path`` is a directory;
    existing checkpoint files in it are overwritten.
    """
    import torch.distributed.checkpoint as dcp

    dcp.save(_slab_tree(tree, mesh), checkpoint_id=str(path))


def load_sharded(path: str, template: dict) -> dict:
    """Restore a :func:`save_sharded` checkpoint into ``template``.

    ``template`` matches the saved structure; its leaves are ``DTensor``s
    on the target mesh and placements (each rank reads its own rows, on any
    number of ranks) or plain tensors (each rank reads the whole).  The
    leaves are filled in place and the template is returned.
    """
    import torch.distributed.checkpoint as dcp

    dcp.load(template, checkpoint_id=str(path))
    return template


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype ("float32")."""
    return str(torch.empty(0, dtype=dtype).numpy().dtype)


def save_box(path: str, box):
    """Checkpoint a CosmoBox: grid metadata, cosmology params, and any
    realised fields, in fastbox_tpu's format."""
    meta = {
        "grid": dataclasses.asdict(box.grid),
        "cosmo": dataclasses.asdict(box.cosmo),
        "dtype": _dtype_name(box.dtype),
    }
    fields = {}
    for name in _FIELDS:
        val = getattr(box, name, None)
        if val is not None:
            fields[name] = _host(val)
    if getattr(box, "velocity_k", None) is not None:
        for i, comp in enumerate("xyz"):
            fields[f"velocity_k_{comp}"] = _host(box.velocity_k[i])
    np.savez_compressed(path, __meta__=json.dumps(meta), **fields)


def load_box(path: str, device=None):
    """Restore a CosmoBox checkpoint saved by :func:`save_box` (of either
    package) onto ``device`` (None: the card)."""
    from .box import CosmoBox

    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        g = meta["grid"]
        box = CosmoBox(
            cosmo=meta["cosmo"],
            box_scale=(g["Lx"], g["Ly"], g["Lz"]),
            nsamp=g["N"],
            redshift=g["redshift"],
            line_freq=g["line_freq"],
            realise_now=False,
            dtype=getattr(torch, meta["dtype"]),
            device=device,
        )
        for name in _FIELDS:
            if name in data.files:
                setattr(box, name, box._tensor(data[name]))
        if "velocity_k_x" in data.files:
            box.velocity_k = tuple(box._tensor(data[f"velocity_k_{c}"])
                                   for c in "xyz")
    return box
