"""Distributed FFTs by slab decomposition over the mesh's 'space' group.

Counterpart of ``fastbox_tpu/parallel/fft.py``.  Arrays are batched row
slabs (B, N/P, N, ...): each rank holds rows [r N/P, (r+1) N/P) of the
leading spatial axis.  The unsharded axes are transformed locally with
``torch.fft``; the sharded one after an all-to-all transpose
(``dist.all_to_all_single``) that reproduces ``lax.all_to_all(...,
tiled=True)``, and back.  The z (LOS) axis is never sharded.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import collective

__all__ = ["all_to_all", "pfft3_local", "pifft3_local", "pfft2_local",
           "pifft2_local", "prfft3_local", "pirfft3_local"]


def all_to_all(x: torch.Tensor, group, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(x, split_axis, concat_axis, tiled=True)`` over
    ``group`` for (split, concat) = (2, 1) or (1, 2).

    (2, 1): (B, Np, N, ...) -> (B, N, N/P, ...), rank j receiving column
    block j of every rank's rows, concatenated in rank order along axis 1.
    (1, 2): the inverse.  Complex tensors travel as their real view.
    """
    P = dist.get_world_size(group)
    cplx = x.is_complex()
    y = torch.view_as_real(x) if cplx else x
    B, A1, A2 = y.shape[:3]
    rest = y.shape[3:]
    if (split_axis, concat_axis) == (2, 1):
        send = y.reshape(B, A1, P, A2 // P, *rest).movedim(2, 0)
    elif (split_axis, concat_axis) == (1, 2):
        send = y.reshape(B, P, A1 // P, A2, *rest).movedim(1, 0)
    else:
        raise ValueError(f"all_to_all: axes ({split_axis}, {concat_axis})")
    send = send.contiguous()
    recv = torch.empty_like(send)
    collective(send)
    dist.all_to_all_single(recv, send, group=group)
    if (split_axis, concat_axis) == (2, 1):
        out = recv.movedim(0, 1).reshape(B, P * A1, A2 // P, *rest)
    else:
        out = recv.movedim(0, 2).reshape(B, A1 // P, P * A2, *rest)
    return torch.view_as_complex(out.contiguous()) if cplx else out


def pfft3_local(x, group):
    """Forward 3D FFT of a batched row slab (B, N/P, N, N) -> same layout."""
    x = torch.fft.fftn(x, dim=(2, 3))
    x = all_to_all(x, group, 2, 1)
    x = torch.fft.fft(x, dim=1)
    return all_to_all(x, group, 1, 2)


def pifft3_local(x, group):
    """Inverse 3D FFT of a batched row slab (B, N/P, N, N)."""
    x = torch.fft.ifftn(x, dim=(2, 3))
    x = all_to_all(x, group, 2, 1)
    x = torch.fft.ifft(x, dim=1)
    return all_to_all(x, group, 1, 2)


def prfft3_local(x, group):
    """Real-input forward 3D FFT: (B, N/P, N, N) real -> (B, N/P, N, N//2+1)
    complex half spectrum over the local z axis."""
    x = torch.fft.rfft(x, dim=3)
    x = torch.fft.fft(x, dim=2)
    x = all_to_all(x, group, 2, 1)
    x = torch.fft.fft(x, dim=1)
    return all_to_all(x, group, 1, 2)


def pirfft3_local(x, n: int, group):
    """Inverse of :func:`prfft3_local`: (B, N/P, N, N//2+1) -> (B, N/P, N, n)
    real, with ``n`` the full z length."""
    x = all_to_all(x, group, 2, 1)
    x = torch.fft.ifft(x, dim=1)
    x = all_to_all(x, group, 1, 2)
    x = torch.fft.ifft(x, dim=2)
    return torch.fft.irfft(x, n=n, dim=3)


def pfft2_local(x, group):
    """Forward 2D FFT over axes 1, 2 of a sharded (B, N/P, N, ...) map."""
    x = torch.fft.fft(x, dim=2)
    x = all_to_all(x, group, 2, 1)
    x = torch.fft.fft(x, dim=1)
    return all_to_all(x, group, 1, 2)


def pifft2_local(x, group):
    """Inverse 2D FFT over axes 1, 2 of a sharded (B, N/P, N, ...) map."""
    x = torch.fft.ifft(x, dim=2)
    x = all_to_all(x, group, 2, 1)
    x = torch.fft.ifft(x, dim=1)
    return all_to_all(x, group, 1, 2)
