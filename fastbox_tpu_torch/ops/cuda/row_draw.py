"""R1/R2: jax.random's row-keyed draws (csrc/row_draw.cu) and plain twins.

Counterparts of ``fastbox_tpu/parallel/rng.py::row_normal`` and
``fastbox_tpu/parallel/halos.py::row_poisson``, which draw every field of
the sharded step row by row with ``jax.random`` under ``jax.vmap``.  They
replace no Pallas kernel: on the TPU the draws are one XLA program, and
here they are one launch per field for a batch of keys.

Both reproduce jax's threefry streams (jax 0.9, ``jax_threefry_partitionable``
on): row ``r`` of key ``k`` draws with ``fold_in(fold_in(k, tag), row0 + r)``,
and element ``j`` of a row hashes the counter ``(j >> 32, j & 0xFFFFFFFF)``
(``jax/_src/prng.py``, ``_threefry_random_bits_partitionable``).  A float32
value takes the XOR of the two output words, a float64 value the 64-bit
word ``hi << 32 | lo``; the uniform is jax's mantissa trick, scaled and
clamped as ``jax.random.uniform`` does, and

* ``row_normal`` ('erfinv', ``jax.random.normal``): ``sqrt(2) erfinv(u)``
  with u on [nextafter(-1, 0), 1);
* ``row_normal`` ('box_muller', ``fastbox_tpu.parallel.rng._bm_normal``):
  ``k1, k2 = split(key)``, u1 on [tiny, 1) and u2 on [0, 1) over the half
  row, the cos half then the sin half (an odd last axis: the cos values of
  the whole row);
* ``row_poisson`` (``jax.random.poisson`` on the rate cast to float32):
  Knuth below 10 (or NaN), Hörmann's transformed rejection from 10, 0 at 0.
  Under jax's loop a rejection element keeps the k of its LAST accepted
  iteration, and the loop runs until every element of the row has been
  accepted once (with the rate of a Knuth element replaced by 1e5), so a
  row's elements depend on each other through that count.

Keys are a (B, 2) int64 tensor of 32-bit words on the device of the draw
(``parallel.rng.row_keys`` makes them from seeds).  The twins compute the
same words in int64 tensors masked to 32 bits and the same floating-point
steps with ``torch.erfinv``, ``torch.log`` and ``torch.lgamma``, a block of
rows at a time.  Dispatch follows K1's: the kernel for CUDA tensors, the
twin for CPU tensors, and anything else raises.
"""
from __future__ import annotations

import math

import torch

from . import _build

__all__ = ["METHODS", "threefry2x32", "row_normal_plain", "row_normal_cuda",
           "row_normal_draw", "row_poisson_plain", "row_poisson_cuda",
           "row_poisson_draw", "vector_path"]

NAME_NORMAL = "row_normal"
NAME_POISSON = "row_poisson"
# 'uniform' writes the erfinv path's uniform u itself (for checks)
METHODS = {"erfinv": 0, "box_muller": 1, "uniform": 2}
M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
# elements per block of rows in the twins: int64 temporaries of 32 MiB
_TWIN_BLOCK = 1 << 22
# A cap on the Poisson loops (jax's is the integer dtype's max).  Knuth
# below rate 10 and the rejection (acceptance >= ~0.8 an iteration) end
# long before it.
MAX_ITERS = 1 << 16


def threefry2x32(k0, k1, x0, x1):
    """jax's threefry2x32 on 32-bit words held in Python ints or int64
    tensors (broadcasting); returns the two output words."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) & M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def _check_keys(name: str, keys: torch.Tensor) -> int:
    if keys.dim() != 2 or keys.shape[1] != 2 or keys.dtype != torch.int64:
        raise TypeError(f"{name}: keys must be a (B, 2) int64 tensor, got "
                        f"{tuple(keys.shape)} {keys.dtype}")
    return keys.shape[0]


def _row_keys(keys, tag: int, row0: int, nrows: int):
    """The (B * nrows,) words of fold_in(fold_in(key_b, tag), row0 + r)."""
    k0, k1 = keys[:, 0:1], keys[:, 1:2]
    k0, k1 = threefry2x32(k0, k1, 0, int(tag) & M32)
    rows = (int(row0) + torch.arange(nrows, dtype=torch.int64,
                                     device=keys.device)) & M32
    k0, k1 = threefry2x32(k0, k1, 0, rows[None, :])
    return k0.reshape(-1), k1.reshape(-1)


def _unit(k0, k1, count, dtype):
    """jax's float in [0, 1) of each counter (hi word 0) under each key:
    the mantissa bits of a value in [1, 2), minus 1 (exact)."""
    b0, b1 = threefry2x32(k0, k1, 0, count)
    if dtype == torch.float32:
        bits = ((b0 ^ b1) >> 9) | 0x3F800000
        return bits.to(torch.int32).view(torch.float32) - 1.0
    bits = (b0 << 20) | (b1 >> 12) | 0x3FF0000000000000
    return bits.view(torch.float64) - 1.0


def _uniform(k0, k1, count, dtype, lo, hi):
    """jax.random.uniform(key, ..., lo, hi): max(lo, f (hi - lo) + lo),
    each step rounded in ``dtype``."""
    lo = torch.tensor(lo, dtype=dtype, device=count.device)
    span = torch.tensor(hi, dtype=dtype, device=count.device) - lo
    return torch.maximum(lo, _unit(k0, k1, count, dtype) * span + lo)


def _constants(dtype, device):
    t = lambda v: torch.tensor(v, dtype=dtype, device=device)  # noqa: E731
    lo = torch.nextafter(t(-1.0), t(0.0)).item()
    return lo, t(math.sqrt(2.0)), t(-2.0), t(2.0 * math.pi)


def row_normal_plain(keys, tag: int, row0: int, nrows: int, row_shape,
                     dtype=torch.float32, method: str = "erfinv",
                     out=None) -> torch.Tensor:
    """(B, nrows, *row_shape) draws of ``method`` on ``keys``' device."""
    B = _check_keys(NAME_NORMAL, keys)
    row_shape = tuple(int(n) for n in row_shape)
    code = _method(method)
    out = _out(NAME_NORMAL, out, (B, nrows, *row_shape), dtype, keys.device)
    L = math.prod(row_shape)
    if out.numel() == 0:
        return out
    W = row_shape[-1] if row_shape else 1
    halves = code == METHODS["box_muller"] and W % 2 == 0
    items = L // 2 if halves else L
    K0, K1 = _row_keys(keys, tag, row0, nrows)
    flat = out.view(B * nrows, L)
    lo, sqrt2, m2, twopi = _constants(dtype, keys.device)
    tiny = torch.finfo(dtype).tiny
    if code == METHODS["box_muller"]:
        s0, s1 = threefry2x32(K0, K1, 0, 0)
        t0, t1 = threefry2x32(K0, K1, 0, 1)
    step = max(1, _TWIN_BLOCK // max(items, 1))
    count = torch.arange(items, dtype=torch.int64, device=keys.device)[None]
    for a in range(0, B * nrows, step):
        rows = slice(a, a + step)
        if code != METHODS["box_muller"]:
            u = _uniform(K0[rows, None], K1[rows, None], count, dtype, lo,
                         1.0)
            flat[rows] = u if code == METHODS["uniform"] else \
                sqrt2 * torch.erfinv(u)
            continue
        u1 = _uniform(s0[rows, None], s1[rows, None], count, dtype, tiny, 1.0)
        u2 = _uniform(t0[rows, None], t1[rows, None], count, dtype, 0.0, 1.0)
        r = torch.sqrt(m2 * torch.log(u1))
        th = twopi * u2
        if not halves:
            flat[rows] = r * torch.cos(th)
            continue
        n = flat[rows].view(-1, L // W, W)
        n[..., :W // 2] = (r * torch.cos(th)).view(-1, L // W, W // 2)
        n[..., W // 2:] = (r * torch.sin(th)).view(-1, L // W, W // 2)
    return out


def _method(method: str) -> int:
    if method not in METHODS:
        raise ValueError(f"Unknown row_normal method '{method}'")
    return METHODS[method]


def _out(name, out, shape, dtype, device):
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: unsupported dtype {dtype} (float32 or "
                        "float64)")
    if math.prod(shape[2:]) > M32:
        raise ValueError(f"{name}: a row of {math.prod(shape[2:])} elements "
                         "outgrows the 32-bit counter")
    if out is None:
        return torch.empty(shape, dtype=dtype, device=device)
    if tuple(out.shape) != tuple(shape) or out.dtype != dtype:
        raise ValueError(f"{name}: out must be {tuple(shape)} {dtype}, got "
                         f"{tuple(out.shape)} {out.dtype}")
    if out.device != device or not out.is_contiguous():
        raise ValueError(f"{name}: out must be contiguous on {device}")
    return out


def vector_path(method: str, row_shape, out: torch.Tensor) -> bool:
    """Whether R1 writes 16-byte vectors: 'erfinv'/'uniform' on rows of a
    multiple of 16 bytes, 'box_muller' on half rows of one; ``out``
    16-byte aligned.  Else it writes element by element, the same values."""
    v = 16 // out.element_size()
    L = math.prod(row_shape)
    if _method(method) == METHODS["box_muller"]:
        W = row_shape[-1] if row_shape else 1
        fits = W % 2 == 0 and (W // 2) % v == 0
    else:
        fits = L % v == 0
    return fits and out.data_ptr() % 16 == 0


def row_normal_cuda(keys, tag: int, row0: int, nrows: int, row_shape,
                    dtype=torch.float32, method: str = "erfinv",
                    out=None) -> torch.Tensor:
    """Launch R1: (B, nrows, *row_shape) draws on ``keys``' CUDA device."""
    B = _check_keys(NAME_NORMAL, keys)
    row_shape = tuple(int(n) for n in row_shape)
    code = _method(method)
    out = _out(NAME_NORMAL, out, (B, nrows, *row_shape), dtype, keys.device)
    _build.require_cuda(NAME_NORMAL, keys, out)
    L = math.prod(row_shape)
    if out.numel() == 0:
        return out
    W = row_shape[-1] if row_shape else 1
    fn = _build.kernel_fn("fbx_row_normal", dtype)
    with torch.cuda.device(out.device):
        err = fn(keys.data_ptr(), B, int(tag) & M32, int(row0), nrows, L, W,
                 code, int(vector_path(method, row_shape, out)),
                 out.data_ptr(), _build.stream_ptr(out.device))
    _build.check(err, NAME_NORMAL)
    _build.count_launch(NAME_NORMAL)
    return out


def row_normal_draw(keys, tag: int, row0: int, nrows: int, row_shape,
                    dtype=torch.float32, method: str = "erfinv",
                    out=None) -> torch.Tensor:
    """R1 for keys on a CUDA device, the plain twin for keys on the CPU."""
    if keys.device.type == "cuda":
        return row_normal_cuda(keys, tag, row0, nrows, row_shape, dtype,
                               method, out)
    if keys.device.type == "cpu":
        return row_normal_plain(keys, tag, row0, nrows, row_shape, dtype,
                                method, out)
    raise ValueError(f"{NAME_NORMAL}: unsupported device {keys.device}")


def _lam_shape(keys, lam) -> tuple:
    """(B, nrows, L) of a rate tensor (B, nrows, ...) for B keys."""
    B = _check_keys(NAME_POISSON, keys)
    if lam.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{NAME_POISSON}: unsupported dtype {lam.dtype}")
    if lam.dim() < 2 or lam.shape[0] != B:
        raise ValueError(f"{NAME_POISSON}: lam must be (B={B}, nrows, ...), "
                         f"got {tuple(lam.shape)}")
    if math.prod(lam.shape[2:]) > M32 or not lam.is_contiguous():
        raise ValueError(f"{NAME_POISSON}: lam must be contiguous, its rows "
                         "within the 32-bit counter")
    return B, lam.shape[1], math.prod(lam.shape[2:])


def _knuth(K0, K1, count, lam):
    """jax's Knuth loop on every element: the number of uniforms whose log
    sum stays above -lam, less one (-1 where lam is 0 or NaN)."""
    lp = torch.zeros_like(lam)
    k = torch.zeros(lam.shape, dtype=torch.int64, device=lam.device)
    r0, r1 = K0[:, None], K1[:, None]
    neg = -lam
    for _ in range(MAX_ITERS):
        live = lp > neg
        if not bool(live.any()):
            break
        s0, s1 = threefry2x32(r0, r1, 0, 1)
        r0, r1 = threefry2x32(r0, r1, 0, 0)
        k += live
        lp = lp + torch.log(_unit(s0, s1, count, torch.float32))
    return k - 1


def _rejection(K0, K1, count, lam):
    """jax's transformed rejection (Hörmann) on every element, row by row
    as jax's batched loop runs it: a row iterates until each of its
    elements has been accepted once, and an element keeps the k of its
    last accepted iteration."""
    f = lambda v: torch.tensor(v, dtype=torch.float32,  # noqa: E731
                               device=lam.device)
    log_lam = torch.log(lam)
    b = f(0.931) + f(2.53) * torch.sqrt(lam)
    a = f(-0.059) + f(0.02483) * b
    inv_alpha = f(1.1239) + f(1.1328) / (b - f(3.4))
    v_r = f(0.9277) - f(3.6224) / (b - f(2.0))
    k_out = torch.full_like(lam, -1.0)
    accepted = torch.zeros(lam.shape, dtype=torch.bool, device=lam.device)
    r0, r1 = K0[:, None], K1[:, None]
    for _ in range(MAX_ITERS):
        active = ~accepted.all(dim=1, keepdim=True)
        if not bool(active.any()):
            break
        u0, u1 = threefry2x32(r0, r1, 0, 1)
        v0, v1 = threefry2x32(r0, r1, 0, 2)
        r0, r1 = threefry2x32(r0, r1, 0, 0)
        u = _unit(u0, u1, count, torch.float32) - f(0.5)
        v = _unit(v0, v1, count, torch.float32)
        us = f(0.5) - torch.abs(u)
        k = torch.floor((f(2.0) * a / us + b) * u + lam + f(0.43))
        s = torch.log(v * inv_alpha / (a / (us * us) + b))
        t = -lam + k * log_lam - torch.lgamma(k + f(1.0))
        accept1 = (us >= f(0.07)) & (v <= v_r)
        reject = (k < 0) | ((us < f(0.013)) & (v > us))
        accept = (accept1 | (~reject & (s <= t))) & active
        k_out = torch.where(accept, k, k_out)
        accepted |= accept
    return k_out


def row_poisson_plain(keys, tag: int, row0: int, lam) -> torch.Tensor:
    """Counts of ``lam`` (B, nrows, ...) in its dtype, on its device."""
    B, nrows, L = _lam_shape(keys, lam)
    out = torch.empty_like(lam)
    if out.numel() == 0:
        return out
    K0, K1 = _row_keys(keys.to(lam.device), tag, row0, nrows)
    flat_lam = lam.reshape(B * nrows, L)
    flat = out.view(B * nrows, L)
    step = max(1, _TWIN_BLOCK // L)
    count = torch.arange(L, dtype=torch.int64, device=lam.device)[None]
    for a in range(0, B * nrows, step):
        rows = slice(a, a + step)
        lf = flat_lam[rows].to(torch.float32)
        knuth = torch.isnan(lf) | (lf < 10.0)
        res = _knuth(K0[rows], K1[rows], count,
                     torch.where(knuth, lf, 0.0)).to(torch.float32)
        if not bool(knuth.all()):
            rej = _rejection(K0[rows], K1[rows], count,
                             torch.where(knuth, 1e5, lf))
            res = torch.where(knuth, res, rej)
        flat[rows] = torch.where(lf == 0, 0.0, res).to(lam.dtype)
    return out


def row_poisson_cuda(keys, tag: int, row0: int, lam) -> torch.Tensor:
    """Launch R2: counts of ``lam`` (B, nrows, ...) in its dtype."""
    B, nrows, L = _lam_shape(keys, lam)
    _build.require_cuda(NAME_POISSON, keys, lam)
    out = torch.empty_like(lam)
    if out.numel() == 0:
        return out
    fn = _build.kernel_fn("fbx_row_poisson", lam.dtype)
    with torch.cuda.device(lam.device):
        err = fn(keys.data_ptr(), B, int(tag) & M32, int(row0), nrows, L,
                 lam.data_ptr(), out.data_ptr(), _build.stream_ptr(lam.device))
    _build.check(err, NAME_POISSON)
    _build.count_launch(NAME_POISSON)
    return out


def row_poisson_draw(keys, tag: int, row0: int, lam) -> torch.Tensor:
    """R2 for a rate on a CUDA device, the plain twin for one on the CPU."""
    if lam.device.type == "cuda":
        return row_poisson_cuda(keys, tag, row0, lam)
    if lam.device.type == "cpu":
        return row_poisson_plain(keys, tag, row0, lam)
    raise ValueError(f"{NAME_POISSON}: unsupported device {lam.device}")
