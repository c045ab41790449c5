"""K8: banded telescoping interpolation on sorted nodes
(csrc/banded_interp.cu) and its plain twin.

Counterpart of ``fastbox_tpu/ops/pallas/banded_interp.py::
banded_interp_pallas``.  The twin is ``fastbox_tpu/ops/rsd.py::
_interp_sorted_banded`` (:94-135) plus the hull fill.  Exact whenever every
sorted node lies within ``band`` cells of its rank: the caller checks
max|ss - z| <= band*dz.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["banded_interp", "banded_interp_cuda", "banded_interp_plain"]

NAME = "banded_interp"


def _check(ss, vv, ztarget, fill, band: int) -> None:
    if ss.dim() != 2:
        raise ValueError(f"{NAME}: ss must be 2-D (M, C)")
    M, C = ss.shape
    if vv.shape != ss.shape or ztarget.shape != (C,) or fill.shape != (M,):
        raise ValueError(f"{NAME}: shapes ss/vv (M, C), ztarget (C,), "
                         "fill (M,) required")
    if not 0 < band < C:
        raise ValueError(f"{NAME}: band must lie in [1, C - 1], got {band}")


def banded_interp_plain(ss, vv, ztarget, fill, band: int = 4):
    """out(t) = vv[max(t - band, 0)] + the 2*band segment terms around t,
    summed for offsets o = -band .. band-1 with ``torch.roll``; the hull
    fill outside [ss[:, 0], ss[:, -1]]."""
    _check(ss, vv, ztarget, fill, band)
    M, C = ss.shape
    dv = torch.cat([vv[:, 1:] - vv[:, :-1], vv.new_zeros((M, 1))], dim=1)
    ds = torch.cat([ss[:, 1:] - ss[:, :-1], ss.new_ones((M, 1))], dim=1)
    out = torch.cat([vv[:, :1].expand(M, band), vv[:, :C - band]], dim=1)
    z = ztarget[None, :]
    t_idx = torch.arange(C, device=ss.device)
    for o in range(-band, band):
        c_idx = t_idx + o                       # segment index per target
        valid = ((c_idx >= 0) & (c_idx <= C - 2))[None, :]
        dv_o = torch.roll(dv, -o, 1)
        ds_o = torch.roll(ds, -o, 1)
        ss_o = torch.roll(ss, -o, 1)
        safe = torch.where(ds_o > 0.0, ds_o, torch.ones_like(ds_o))
        frac = (z - ss_o) / safe
        frac = torch.where(ds_o > 0.0, frac, (z >= ss_o).to(vv.dtype))
        wgt = torch.clamp(frac, 0.0, 1.0)
        out = out + torch.where(valid, dv_o * wgt, torch.zeros_like(wgt))
    inside = (z >= ss[:, :1]) & (z <= ss[:, -1:])
    return torch.where(inside, out, fill[:, None])


def banded_interp_cuda(ss, vv, ztarget, fill, band: int = 4):
    _check(ss, vv, ztarget, fill, band)
    M, C = ss.shape
    _build.require_cuda(NAME, ss, vv, ztarget, fill, dtype=ss.dtype)
    out = torch.empty_like(ss)
    fn = _build.kernel_fn("fbx_banded_interp", ss.dtype)
    with torch.cuda.device(ss.device):
        err = fn(ss.data_ptr(), vv.data_ptr(), ztarget.data_ptr(),
                 fill.data_ptr(), out.data_ptr(), M, C, int(band),
                 _build.stream_ptr(ss.device))
    _build.check(err, NAME)
    _build.count_launch(NAME)
    return out


def banded_interp(ss, vv, ztarget, fill, band: int = 4):
    """K8 on CUDA tensors, the plain twin on CPU tensors."""
    if ss.device.type == "cuda":
        return banded_interp_cuda(ss, vv, ztarget, fill, band)
    if ss.device.type == "cpu":
        return banded_interp_plain(ss, vv, ztarget, fill, band)
    raise ValueError(f"{NAME}: unsupported device {ss.device}")
