"""K1: fused ``x + scale * N(0,1)`` (csrc/noise.cu) and its plain twin.

Counterpart of ``fastbox_tpu/ops/pallas/noise.py::add_scaled_normal_pallas``.
The kernel draws its normals from an in-kernel Philox keyed by a seed that
the wrapper draws from the caller's ``torch.Generator`` (on the device, so
no host sync), or takes supplied normals.  The plain twin draws with
``torch.randn`` on the same generator: the two streams differ, as the TPU
kernel's and the ``jax.random`` fallback's do (fastbox_tpu/ops/rsd.py:69-71).
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["add_scaled_normal_2d", "add_scaled_normal_cuda",
           "add_scaled_normal_plain", "vector_path"]

NAME = "add_scaled_normal"


def vector_path(C: int, *tensors) -> bool:
    """Whether K1 reads and writes in 16-byte vectors: rows of a multiple of
    4 elements, and every array starting on a 16-byte boundary.  Else it
    takes the direct path, element by element; both draw the same bits."""
    return C % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def add_scaled_normal_plain(x2d, scale_row, generator=None, normals=None,
                            return_max: bool = False):
    """x2d + scale_row[None, :] * n with n = ``normals`` or fresh normals
    from ``generator``; with ``return_max`` also max|result|."""
    if normals is None:
        normals = torch.randn(x2d.shape, generator=generator, dtype=x2d.dtype,
                              device=x2d.device)
    out = x2d + scale_row * normals
    if return_max:
        return out, out.abs().max()
    return out


def add_scaled_normal_cuda(x2d, scale_row, seed=None, normals=None,
                           return_max: bool = False):
    """Launch K1.  ``seed``: (1,) int64 CUDA tensor, required when
    ``normals`` is None; ``normals``: (R, C) like ``x2d``."""
    if x2d.dim() != 2:
        raise ValueError(f"{NAME}: x2d must be 2-D, got {tuple(x2d.shape)}")
    R, C = x2d.shape
    if scale_row.shape != (C,):
        raise ValueError(f"{NAME}: scale_row must have shape ({C},)")
    extra = [normals] if normals is not None else []
    _build.require_cuda(NAME, x2d, scale_row, *extra, dtype=x2d.dtype)
    if normals is not None and normals.shape != x2d.shape:
        raise ValueError(f"{NAME}: normals must match x2d's shape")
    if normals is None:
        if seed is None:
            raise ValueError(f"{NAME}: need a seed or supplied normals")
        _build.require_cuda(NAME, x2d, seed, dtype=None)
        if seed.dtype != torch.int64 or seed.numel() != 1:
            raise TypeError(f"{NAME}: seed must be one int64 element")
    out = torch.empty_like(x2d)
    mx = (torch.zeros(1, dtype=x2d.dtype, device=x2d.device)
          if return_max else None)
    vec = vector_path(C, x2d, scale_row, out, *extra)
    fn = _build.kernel_fn("fbx_add_scaled_normal", x2d.dtype)
    with torch.cuda.device(x2d.device):
        err = fn(x2d.data_ptr(), scale_row.data_ptr(), _build.ptr(normals),
                 _build.ptr(seed if normals is None else None), out.data_ptr(),
                 _build.ptr(mx), R, C, int(vec), _build.stream_ptr(x2d.device))
    _build.check(err, NAME)
    _build.count_launch(NAME)
    if return_max:
        return out, mx[0]
    return out


def draw_seed(generator: torch.Generator, device) -> torch.Tensor:
    """A (1,) int64 seed drawn on ``device`` from ``generator``."""
    return torch.randint(0, 2**62, (1,), generator=generator,
                         dtype=torch.int64, device=device)


def add_scaled_normal_2d(x2d, scale_row, generator=None, normals=None,
                         return_max: bool = False):
    """K1 on a CUDA tensor, the plain twin on a CPU tensor."""
    if normals is None and generator is None:
        raise ValueError(f"{NAME}: pass a torch.Generator or the normals")
    if x2d.device.type == "cuda":
        seed = draw_seed(generator, x2d.device) if normals is None else None
        return add_scaled_normal_cuda(x2d, scale_row, seed, normals,
                                      return_max)
    if x2d.device.type == "cpu":
        return add_scaled_normal_plain(x2d, scale_row, generator, normals,
                                       return_max)
    raise ValueError(f"{NAME}: unsupported device {x2d.device}")
