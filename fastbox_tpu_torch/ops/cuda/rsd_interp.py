"""K3: interpolation of per-row sorted nodes (csrc/rsd_interp.cu) and its
plain twin.

Counterpart of ``fastbox_tpu/ops/pallas/rsd_interp.py::interp_sorted_pallas``.
The plain twin is the row-chunked telescoping form of
``fastbox_tpu/ops/rsd.py:138-167`` plus the hull fill; the kernel
binary-searches the bracket segment, the same function.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["interp_sorted", "interp_sorted_cuda", "interp_sorted_plain"]

NAME = "interp_sorted"


def interp_sorted_plain(ss, vv, ztarget, fill):
    """Telescoping interpolation over all segments, chunked over rows so
    the (rows, C-1, T) temporary stays near 2^27 elements."""
    M, C = ss.shape
    T = ztarget.shape[0]
    rows = max(1, min(M, (2**27) // max(C * T, 1)))
    zt = ztarget[None, None, :]
    out = torch.empty((M, T), dtype=vv.dtype, device=vv.device)
    for r0 in range(0, M, rows):
        s_ = ss[r0:r0 + rows]
        v_ = vv[r0:r0 + rows]
        dv = v_[:, 1:] - v_[:, :-1]
        ds = s_[:, 1:] - s_[:, :-1]
        safe = torch.where(ds > 0.0, ds, torch.ones_like(ds))
        fr = (zt - s_[:, :-1, None]) / safe[:, :, None]
        fr = torch.where(ds[:, :, None] > 0.0, fr,
                         (zt >= s_[:, :-1, None]).to(vv.dtype))
        out[r0:r0 + rows] = v_[:, :1] + torch.sum(
            dv[:, :, None] * torch.clamp(fr, 0.0, 1.0), dim=1)
    inside = (ztarget[None, :] >= ss[:, :1]) & (ztarget[None, :] <= ss[:, -1:])
    return torch.where(inside, out, fill[:, None])


def interp_sorted_cuda(ss, vv, ztarget, fill):
    if ss.dim() != 2:
        raise ValueError(f"{NAME}: ss must be 2-D (M, C)")
    M, C = ss.shape
    T = ztarget.shape[0]
    if vv.shape != ss.shape or ztarget.dim() != 1 or fill.shape != (M,):
        raise ValueError(f"{NAME}: shapes ss/vv (M, C), ztarget (T,), "
                         "fill (M,) required")
    _build.require_cuda(NAME, ss, vv, ztarget, fill, dtype=ss.dtype)
    out = torch.empty((M, T), dtype=ss.dtype, device=ss.device)
    fn = _build.kernel_fn("fbx_interp_sorted", ss.dtype)
    with torch.cuda.device(ss.device):
        err = fn(ss.data_ptr(), vv.data_ptr(), ztarget.data_ptr(),
                 fill.data_ptr(), out.data_ptr(), M, C, T,
                 _build.stream_ptr(ss.device))
    _build.check(err, NAME)
    _build.count_launch(NAME)
    return out


def interp_sorted(ss, vv, ztarget, fill):
    """K3 on CUDA tensors, the plain twin on CPU tensors."""
    if ss.device.type == "cuda":
        return interp_sorted_cuda(ss, vv, ztarget, fill)
    if ss.device.type == "cpu":
        return interp_sorted_plain(ss, vv, ztarget, fill)
    raise ValueError(f"{NAME}: unsupported device {ss.device}")
