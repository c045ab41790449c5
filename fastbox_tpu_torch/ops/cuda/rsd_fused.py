"""K2: wrap-fused periodic bracket interpolation, and K7: the same scan on
coordinates already wrapped (csrc/rsd_fused.cu), with their plain twins.

Counterparts of ``fastbox_tpu/ops/pallas/rsd_fused.py::rsd_remap_wrap_pallas``
(K2) and ``rsd_bracket_interp_pallas`` (K7); the module docstring there
proves the scan window.  Exact whenever every node moved at most ``band``
cells: the caller checks max|v|/H <= band*dz.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["rsd_remap_wrap", "rsd_remap_wrap_cuda", "rsd_remap_wrap_plain",
           "rsd_bracket_interp", "rsd_bracket_interp_cuda",
           "rsd_bracket_interp_plain", "staged_path", "wrap_params"]

NAME = "rsd_remap_wrap"
NAME_K7 = "rsd_bracket_interp"
# The staged layout (csrc/rsd_fused.cu): one warp per row, 16-byte vectors,
# a register window per band; rows up to STAGED_MAX_C cells fit one warp's
# two row buffers in shared memory in float64 at band 4.
STAGED_BANDS = (2, 4)
STAGED_MAX_C = 4096


def staged_path(C: int, band: int, *tensors) -> bool:
    """Whether K2/K7 take the staged path: C a multiple of 4, band 2 or 4,
    at most STAGED_MAX_C cells, and every (M, C) array starting on a 16-byte
    boundary.  Else the direct path, one block per row."""
    return (C % 4 == 0 and band in STAGED_BANDS and C <= STAGED_MAX_C
            and all(t.data_ptr() % 16 == 0 for t in tensors))


def wrap_params(z0, length_z, inv_hz, dtype, device) -> torch.Tensor:
    """The (3,) tensor (z0, length_z, 1/H) both versions read."""
    return torch.stack([torch.as_tensor(v, dtype=dtype, device=device)
                        for v in (z0, length_z, inv_hz)])


def rsd_remap_wrap_plain(vals, vel, ztarget, fill, wrap, band: int = 4):
    """The wrap, then the bracket scan of ``rsd_bracket_interp_plain``."""
    z0, length, inv_hz = wrap[0], wrap[1], wrap[2]
    u = ztarget[None, :] - vel * inv_hz
    s = torch.remainder(u - z0, length) + z0
    return rsd_bracket_interp_plain(s, vals, ztarget, fill, band)


def rsd_bracket_interp_plain(s, vals, ztarget, fill, band: int = 4):
    """The bracket scan on wrapped coordinates ``s``, with ``torch.roll``
    on the last axis."""
    z = ztarget[None, :]
    big = torch.finfo(vals.dtype).max / 4
    s_lo = torch.full_like(s, -big)
    v_lo = torch.zeros_like(vals)
    s_hi = torch.full_like(s, big)
    v_hi = torch.zeros_like(vals)
    for o in range(-3 * band - 1, 3 * band + 3):
        sc = torch.roll(s, -o, 1)       # node coordinate at lane t + o
        vc = torch.roll(vals, -o, 1)
        below = sc <= z
        if o <= band:
            up = below & (sc >= s_lo)   # later duplicate wins
            s_lo = torch.where(up, sc, s_lo)
            v_lo = torch.where(up, vc, v_lo)
        if o >= -band:
            up = ~below & (sc < s_hi)   # first duplicate wins
            s_hi = torch.where(up, sc, s_hi)
            v_hi = torch.where(up, vc, v_hi)
    frac = (z - s_lo) / (s_hi - s_lo)
    out = v_lo + (v_hi - v_lo) * frac
    inside = (z >= s.amin(1, keepdim=True)) & (z <= s.amax(1, keepdim=True))
    return torch.where(inside, out, fill[:, None])


def rsd_remap_wrap_cuda(vals, vel, ztarget, fill, wrap, band: int = 4):
    if vals.dim() != 2:
        raise ValueError(f"{NAME}: vals must be 2-D (M, C)")
    M, C = vals.shape
    if vel.shape != vals.shape or ztarget.shape != (C,) \
            or fill.shape != (M,) or wrap.shape != (3,):
        raise ValueError(f"{NAME}: shapes vals/vel (M, C), ztarget (C,), "
                         "fill (M,), wrap (3,) required")
    if band < 0:
        raise ValueError(f"{NAME}: band must be >= 0")
    _build.require_cuda(NAME, vals, vel, ztarget, fill, wrap,
                        dtype=vals.dtype)
    out = torch.empty_like(vals)
    staged = staged_path(C, band, vals, vel, out)
    fn = _build.kernel_fn("fbx_rsd_remap_wrap", vals.dtype)
    with torch.cuda.device(vals.device):
        err = fn(vals.data_ptr(), vel.data_ptr(), ztarget.data_ptr(),
                 fill.data_ptr(), wrap.data_ptr(), out.data_ptr(), M, C,
                 int(band), int(staged), _build.stream_ptr(vals.device))
    _build.check(err, NAME)
    _build.count_launch(NAME)
    return out


def rsd_bracket_interp_cuda(s, vals, ztarget, fill, band: int = 4):
    if s.dim() != 2:
        raise ValueError(f"{NAME_K7}: s must be 2-D (M, C)")
    M, C = s.shape
    if vals.shape != s.shape or ztarget.shape != (C,) or fill.shape != (M,):
        raise ValueError(f"{NAME_K7}: shapes s/vals (M, C), ztarget (C,), "
                         "fill (M,) required")
    if band < 0:
        raise ValueError(f"{NAME_K7}: band must be >= 0")
    _build.require_cuda(NAME_K7, s, vals, ztarget, fill, dtype=s.dtype)
    out = torch.empty_like(s)
    staged = staged_path(C, band, s, vals, out)
    fn = _build.kernel_fn("fbx_rsd_bracket_interp", s.dtype)
    with torch.cuda.device(s.device):
        err = fn(s.data_ptr(), vals.data_ptr(), ztarget.data_ptr(),
                 fill.data_ptr(), out.data_ptr(), M, C, int(band),
                 int(staged), _build.stream_ptr(s.device))
    _build.check(err, NAME_K7)
    _build.count_launch(NAME_K7)
    return out


def rsd_bracket_interp(s, vals, ztarget, fill, band: int = 4):
    """K7 on CUDA tensors, the plain twin on CPU tensors."""
    if s.device.type == "cuda":
        return rsd_bracket_interp_cuda(s, vals, ztarget, fill, band)
    if s.device.type == "cpu":
        return rsd_bracket_interp_plain(s, vals, ztarget, fill, band)
    raise ValueError(f"{NAME_K7}: unsupported device {s.device}")


def rsd_remap_wrap(vals, vel, ztarget, fill, wrap, band: int = 4):
    """K2 on CUDA tensors, the plain twin on CPU tensors."""
    if vals.device.type == "cuda":
        return rsd_remap_wrap_cuda(vals, vel, ztarget, fill, wrap, band)
    if vals.device.type == "cpu":
        return rsd_remap_wrap_plain(vals, vel, ztarget, fill, wrap, band)
    raise ValueError(f"{NAME}: unsupported device {vals.device}")
