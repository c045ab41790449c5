"""K3: interpolation of per-row sorted nodes (csrc/rsd_interp.cu) and its
plain twin.

Counterpart of ``fastbox_tpu/ops/pallas/rsd_interp.py::interp_sorted_pallas``.
The plain twin is the row-chunked telescoping form of
``fastbox_tpu/ops/rsd.py:138-167`` plus the hull fill; the kernel finds the
bracket segment of each target, the same function, and evaluates it in the
order of ``interp_sorted_bracket``, to which it is equal bit for bit.  It
takes the staged path (a warp per row; a merge walk over ascending
targets, 32 at a time) where ``staged_path`` holds, and a block per row
otherwise.
"""
from __future__ import annotations

import re

import torch

from . import _build

__all__ = ["interp_sorted", "interp_sorted_bracket", "interp_sorted_cuda",
           "interp_sorted_plain", "staged_path", "WINDOW_HOPS"]

NAME = "interp_sorted"
# The staged layout (csrc/rsd_interp.cu): one warp per row, the row's s and
# v double-buffered in shared memory and the targets staged per block; rows
# and targets up to STAGED_MAX cells fit one block in float64.
STAGED_MAX = 4096


def _kernel_constant(name: str) -> int:
    """A ``constexpr int`` of csrc/rsd_interp.cu, read from the source the
    kernel is built from."""
    text = (_build.CSRC / "rsd_interp.cu").read_text()
    found = re.search(rf"constexpr int {name} = (\d+);", text)
    if found is None:
        raise RuntimeError(f"{NAME}: {name} not found in rsd_interp.cu")
    return int(found.group(1))


# Moves of the 64-node merge window a batch of targets takes before its
# open lanes bisect instead: the kernel's kWindowHops.
WINDOW_HOPS = _kernel_constant("kWindowHops")


def staged_path(C: int, T: int, *tensors) -> bool:
    """Whether K3 takes the staged path: C a multiple of 4, C and T at most
    STAGED_MAX, and every (M, C) array starting on a 16-byte boundary.
    Else the direct path, one block per row."""
    return (C % 4 == 0 and C <= STAGED_MAX and T <= STAGED_MAX
            and all(t.data_ptr() % 16 == 0 for t in tensors))


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


def interp_sorted_bracket(ss, vv, ztarget, fill):
    """The kernel's form: j = the last node <= z_t by ``searchsorted``, then
    v_j + (v_{j+1} - v_j) * ((z_t - s_j) / (s_{j+1} - s_j)), one rounding
    per operation in that order; v_{C-1} where j = C - 1 and the hull fill
    outside [s_0, s_{C-1}].  Within rounding of the twin."""
    M, C = ss.shape
    T = ztarget.shape[0]
    j = torch.searchsorted(ss.contiguous(),
                           ztarget[None, :].expand(M, T).contiguous(),
                           right=True) - 1
    j0 = j.clamp(0, max(C - 2, 0))
    j1 = (j0 + 1).clamp(max=C - 1)
    s0, s1 = torch.gather(ss, 1, j0), torch.gather(ss, 1, j1)
    v0, v1 = torch.gather(vv, 1, j0), torch.gather(vv, 1, j1)
    frac = (ztarget[None, :] - s0) / (s1 - s0)
    out = torch.where(j >= C - 1, vv[:, -1:], v0 + (v1 - v0) * frac)
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
    staged = staged_path(C, T, ss, vv)
    fn = _build.kernel_fn("fbx_interp_sorted", ss.dtype)
    with torch.cuda.device(ss.device):
        err = fn(ss.data_ptr(), vv.data_ptr(), ztarget.data_ptr(),
                 fill.data_ptr(), out.data_ptr(), M, C, T, int(staged),
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
