"""The ('ens', 'space') device mesh on ``torch.distributed``.

Counterpart of ``fastbox_tpu/parallel/mesh.py``: 'ens' is data
parallelism over Monte-Carlo realisations, 'space' the slab decomposition
of each cube's leading axis.  One process per rank; the mesh covers every
rank of the default process group.
"""
from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .. import timing
from ..device import resolve

__all__ = ["make_mesh", "largest_pow2_divisor", "init_single_rank",
           "axis_group", "ens_share", "gather_ens", "collective"]


def largest_pow2_divisor(n: int, cap: int) -> int:
    """Largest power of two dividing n, at most cap."""
    p = 1
    while n % (p * 2) == 0 and p * 2 <= cap:
        p *= 2
    return p


def init_single_rank(device, store_dir=None) -> None:
    """Initialise a one-rank default process group for ``device`` (NCCL on
    a CUDA device, gloo on the CPU) on a file store in ``store_dir`` (a new
    temporary directory by default)."""
    device = torch.device(device)
    if store_dir is None:
        store_dir = tempfile.mkdtemp(prefix="fastbox_pg_")
    os.makedirs(store_dir, exist_ok=True)
    store = dist.FileStore(os.path.join(store_dir, "store"), 1)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            store=store, rank=0, world_size=1)


def make_mesh(n_devices: int | None = None, space: int | None = None,
              grid_n: int | None = None, device=None) -> DeviceMesh:
    """An ('ens', 'space') ``DeviceMesh`` over the ranks of the default
    process group.

    Parameters:
        n_devices: number of ranks (default: the world size; must equal it).
        space: size of the spatial axis.  Default: the largest power of two
            dividing both ``n_devices`` and ``grid_n``.
        grid_n: box resolution, used to bound the spatial axis.
        device: the ranks' device type (None: the CUDA card).

    Without an initialised process group a one-rank mesh initialises one
    (``init_single_rank``); more ranks need a group set up by the caller
    (``parallel.local.launch`` runs gloo ranks on the CPU).
    """
    device = resolve(device)
    if not dist.is_initialized():
        if (n_devices or 1) != 1:
            raise ValueError(
                f"make_mesh: {n_devices} ranks need an initialised process "
                "group (torch.distributed.init_process_group)")
        init_single_rank(device)
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"make_mesh: n_devices={n} but the process group "
                         f"has {world} ranks")
    if space is None:
        space = largest_pow2_divisor(n, grid_n if grid_n is not None else n)
    if n % space != 0:
        raise ValueError(f"n_devices={n} not divisible by space={space}")
    return init_device_mesh(device.type, (n // space, space),
                            mesh_dim_names=("ens", "space"))


def axis_group(mesh: DeviceMesh, name: str):
    """(process group, its size, this rank's index in it) of axis ``name``."""
    group = mesh.get_group(name)
    return group, dist.get_world_size(group), dist.get_rank(group)


def ens_share(mesh: DeviceMesh, B: int) -> tuple[int, int]:
    """[lo, hi): the realisations of B that this rank's 'ens' index runs."""
    _, E, e = axis_group(mesh, "ens")
    if B % E != 0:
        raise ValueError(f"B={B} realisations must be a multiple of the "
                         f"'ens' axis ({E})")
    b = B // E
    return e * b, (e + 1) * b


def collective(*sent: torch.Tensor) -> None:
    """Count one collective of the active clock's call
    (``collective.calls``) and the bytes this rank sends in it
    (``collective.bytes``): ``sent``'s."""
    timing.count("collective.calls")
    timing.count("collective.bytes",
                 sum(t.numel() * t.element_size() for t in sent))


def gather_ens(mesh: DeviceMesh, t: torch.Tensor) -> torch.Tensor:
    """All-gather ``t`` over 'ens' along its leading axis, in rank order
    (fastbox_tpu's ``P('ens')`` out-specs give every rank the global
    array)."""
    group, E, _ = axis_group(mesh, "ens")
    parts = [torch.empty_like(t) for _ in range(E)]
    t = t.contiguous()
    collective(t)
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts)
