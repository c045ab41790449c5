"""R1/R2: jax.random's row-keyed draws (csrc/row_draw.cu) and plain twins.

Counterparts of ``fastbox_tpu/parallel/rng.py::row_normal`` and
``fastbox_tpu/parallel/halos.py::row_poisson``, which draw every field of
the sharded step row by row with ``jax.random`` under ``jax.vmap``.  They
replace no Pallas kernel: on the TPU the draws are one XLA program, and
here they draw a field for a batch of keys in one launch (R2: four).

Both reproduce jax's threefry streams (jax 0.9, ``jax_threefry_partitionable``
on): row ``r`` of key ``k`` draws with ``fold_in(fold_in(k, tag), row0 + r)``,
and element ``j`` of a row hashes the counter ``(j >> 32, j & 0xFFFFFFFF)``
(``jax/_src/prng.py``, ``_threefry_random_bits_partitionable``).  A float32
value takes the XOR of the two output words, a float64 value the 64-bit
word ``hi << 32 | lo``; the uniform is jax's mantissa trick, scaled and
clamped as ``jax.random.uniform`` does (on the CPU XLA fuses the scale and
the shift into one multiply-add), and

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

R1w/R2w (``key_normal_*``, ``key_poisson_*``) are the whole-array draws
of ``fastbox_tpu``'s single-device paths: ``jax.random.normal``,
``uniform`` and ``poisson`` on a key taken as given (no fold_in), element
``i`` of the field hashing the counter of its flat index, so that one
field is R1's row the size of the field.  ``pair=True`` writes ``(re,
im)`` interleaved, a complex tensor's memory: two draws on ``split(key)``
(``_complex_normal``'s 'erfinv' stream), or Box-Muller's (cos, sin) on
``split(key)`` over the whole shape (its 'box_muller' stream,
``fastbox_tpu.parallel.rng.bm_pair``).  R2w's rejection loop runs over
the whole field, its step count the maximum over the field's elements.

Keys are a (B, 2) int64 tensor of 32-bit words on the device of the draw
(``parallel.rng.row_keys`` and ``keys`` make them from seeds). The twins
compute the same words in int64 tensors masked to 32 bits and the same
floating-point steps with ``torch.erfinv``, ``torch.log`` and
``torch.lgamma``, a block of rows at a time. Dispatch follows K1's: the
kernel for CUDA tensors, the twin for CPU tensors, and anything else
raises.
"""
from __future__ import annotations

import math

import torch

from . import _build

__all__ = ["METHODS", "threefry2x32", "row_normal_plain", "row_normal_cuda",
           "row_normal_draw", "row_poisson_plain", "row_poisson_cuda",
           "row_poisson_draw", "vector_path", "key_normal_plain",
           "key_normal_cuda", "key_normal_draw", "key_vector_path",
           "key_poisson_plain", "key_poisson_cuda", "key_poisson_draw"]

NAME_NORMAL = "row_normal"
NAME_POISSON = "row_poisson"
NAME_KEY_NORMAL = "key_normal"     # R1w
NAME_KEY_POISSON = "key_poisson"   # R2w
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


def _fma(a, b, c):
    """a b + c rounded once, as a fused multiply-add: float32 through
    float64 (the product of two float32 values is exact there); float64 by
    Dekker's exact product and an exact sum, then one rounded add."""
    if a.dtype == torch.float32:
        return (a.double() * b.double() + c.double()).float()
    p = a * b
    split = 134217729.0   # 2^27 + 1
    t = split * a
    ah = t - (t - a)
    al = a - ah
    t = split * b
    bh = t - (t - b)
    bl = b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    v = s - p
    return s + (((p - (s - v)) + (c - v)) + e)


def _uniform(k0, k1, count, dtype, lo, hi):
    """jax.random.uniform(key, ..., lo, hi): max(lo, f (hi - lo) + lo) in
    ``dtype``, the product and the sum fused as XLA's CPU backend fuses
    them."""
    lo = torch.tensor(lo, dtype=dtype, device=count.device)
    span = torch.tensor(hi, dtype=dtype, device=count.device) - lo
    return torch.maximum(lo, _fma(_unit(k0, k1, count, dtype), span, lo))


def _constants(dtype, device):
    t = lambda v: torch.tensor(v, dtype=dtype, device=device)  # noqa: E731
    lo = torch.nextafter(t(-1.0), t(0.0)).item()
    return lo, t(math.sqrt(2.0)), t(-2.0), t(2.0 * math.pi)


def _values(k0, k1, count, code: int, dtype, lo=0.0, hi=1.0):
    """The draws of method ``code`` at counters ``count`` under the keys
    (k0, k1), the body of both normal twins: 'erfinv' ``sqrt(2) erfinv(u)``
    with u on [nextafter(-1, 0), 1); 'uniform' u on [lo, hi); 'box_muller'
    the pair (r cos th, r sin th) of ``bm_pair`` on ``split(key)``, u1 on
    [tiny, 1) and u2 on [0, 1)."""
    lo_e, sqrt2, m2, twopi = _constants(dtype, count.device)
    if code == METHODS["erfinv"]:
        return sqrt2 * torch.erfinv(_uniform(k0, k1, count, dtype, lo_e,
                                             1.0))
    if code == METHODS["uniform"]:
        return _uniform(k0, k1, count, dtype, lo, hi)
    (a0, a1), (b0, b1) = (threefry2x32(k0, k1, 0, d) for d in (0, 1))
    u1 = _uniform(a0, a1, count, dtype, torch.finfo(dtype).tiny, 1.0)
    r = torch.sqrt(m2 * torch.log(u1))
    th = twopi * _uniform(b0, b1, count, dtype, 0.0, 1.0)
    return r * torch.cos(th), r * torch.sin(th)


def row_normal_plain(keys, tag: int, row0: int, nrows: int, row_shape,
                     dtype=torch.float32, method: str = "erfinv",
                     out=None) -> torch.Tensor:
    """(B, nrows, *row_shape) draws of ``method`` on ``keys``' device."""
    B = _check_keys(NAME_NORMAL, keys)
    row_shape = tuple(int(n) for n in row_shape)
    code = _method(method)
    _check_row(row_shape)
    out = _out(NAME_NORMAL, out, (B, nrows, *row_shape), dtype, keys.device)
    L = math.prod(row_shape)
    if out.numel() == 0:
        return out
    W = row_shape[-1] if row_shape else 1
    halves = code == METHODS["box_muller"] and W % 2 == 0
    items = L // 2 if halves else L
    K0, K1 = _row_keys(keys, tag, row0, nrows)
    flat = out.view(B * nrows, L)
    # 'uniform' writes the erfinv path's u
    lo = _constants(dtype, keys.device)[0]
    step = max(1, _TWIN_BLOCK // max(items, 1))
    count = torch.arange(items, dtype=torch.int64, device=keys.device)[None]
    for a in range(0, B * nrows, step):
        rows = slice(a, a + step)
        v = _values(K0[rows, None], K1[rows, None], count, code, dtype, lo)
        if code != METHODS["box_muller"]:
            flat[rows] = v
        elif not halves:
            flat[rows] = v[0]
        else:
            n = flat[rows].view(-1, L // W, W)
            n[..., :W // 2] = v[0].view(-1, L // W, W // 2)
            n[..., W // 2:] = v[1].view(-1, L // W, W // 2)
    return out


def _check_row(row_shape) -> None:
    if math.prod(row_shape) > M32:
        raise ValueError(f"{NAME_NORMAL}: a row of {math.prod(row_shape)} "
                         "elements outgrows the 32-bit counter")


def _method(method: str) -> int:
    if method not in METHODS:
        raise ValueError(f"Unknown row_normal method '{method}'")
    return METHODS[method]


def _out(name, out, shape, dtype, device):
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: unsupported dtype {dtype} (float32 or "
                        "float64)")
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
    _check_row(row_shape)
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


def _rejection_consts(lam):
    """Hörmann's per-rate constants (log lam, b, a, 1/alpha, v_r) in f32."""
    f = lambda v: torch.tensor(v, dtype=torch.float32,  # noqa: E731
                               device=lam.device)
    b = f(0.931) + f(2.53) * torch.sqrt(lam)
    return (torch.log(lam), b, f(-0.059) + f(0.02483) * b,
            f(1.1239) + f(1.1328) / (b - f(3.4)),
            f(0.9277) - f(3.6224) / (b - f(2.0)))


def _rejection_step(u0, u1, v0, v1, count, lam, consts):
    """One step of jax's transformed rejection with the step's keys (u0,
    u1) for u and (v0, v1) for v: (k, accepted)."""
    f = lambda v: torch.tensor(v, dtype=torch.float32,  # noqa: E731
                               device=lam.device)
    log_lam, b, a, inv_alpha, v_r = consts
    u = _unit(u0, u1, count, torch.float32) - f(0.5)
    v = _unit(v0, v1, count, torch.float32)
    us = f(0.5) - torch.abs(u)
    k = torch.floor((f(2.0) * a / us + b) * u + lam + f(0.43))
    s = torch.log(v * inv_alpha / (a / (us * us) + b))
    t = -lam + k * log_lam - torch.lgamma(k + f(1.0))
    accept1 = (us >= f(0.07)) & (v <= v_r)
    reject = (k < 0) | ((us < f(0.013)) & (v > us))
    return k, accept1 | (~reject & (s <= t))


def _knuth(K0, K1, row, count, lam):
    """jax's Knuth loop on every element, walking the live ones: the
    number of uniforms whose log sum stays above -lam, less one (-1 where
    lam is 0 or NaN).  The chain key of each row advances every step."""
    k = torch.zeros(lam.shape, dtype=torch.int64, device=lam.device)
    lp = torch.zeros_like(lam)
    live = torch.nonzero(lp > -lam).reshape(-1)
    r0, r1 = K0, K1
    for _ in range(MAX_ITERS):
        if live.numel() == 0:
            break
        s0, s1 = threefry2x32(r0, r1, 0, 1)
        r0, r1 = threefry2x32(r0, r1, 0, 0)
        rl = row[live]
        k[live] += 1
        lp[live] += torch.log(_unit(s0[rl], s1[rl], count[live],
                                    torch.float32))
        live = live[lp[live] > -lam[live]]
    return k - 1


def _rejection(K0, K1, row, count, lam, rejection):
    """jax's transformed rejection (Hörmann) as its loop runs it over a
    row (R2w's row: a whole field): the row iterates until each of its
    elements has been accepted once, and an element keeps the k of its
    last accepted iteration.  First each element's first acceptance,
    walking the live elements of the rows that hold a ``rejection``
    element, the row's step count their latest; then the ``rejection``
    elements walk their row's steps.  Returns those elements' k (-1 where
    none)."""
    consts = _rejection_consts(lam)
    R = K0.shape[0]
    rows = torch.zeros(R, dtype=torch.bool, device=lam.device)
    rows[row[rejection]] = True
    live = torch.nonzero(rows[row]).reshape(-1)
    steps = torch.zeros(R, dtype=torch.int64, device=lam.device)
    t, r0, r1 = 0, K0, K1
    while live.numel() and t < MAX_ITERS:
        t += 1
        (u0, u1), (v0, v1) = (threefry2x32(r0, r1, 0, d) for d in (1, 2))
        r0, r1 = threefry2x32(r0, r1, 0, 0)
        rl = row[live]
        _, accept = _rejection_step(
            u0[rl], u1[rl], v0[rl], v1[rl], count[live], lam[live],
            [c[live] for c in consts])
        steps[rl[accept]] = t
        live = live[~accept]
    sel = torch.nonzero(rejection).reshape(-1)
    k_out = torch.full(sel.shape, -1.0, device=lam.device)
    on = torch.arange(sel.numel(), device=lam.device)
    r0, r1 = K0, K1
    for t in range(1, int(steps.max()) + 1):
        on = on[steps[row[sel[on]]] >= t]
        (u0, u1), (v0, v1) = (threefry2x32(r0, r1, 0, d) for d in (1, 2))
        r0, r1 = threefry2x32(r0, r1, 0, 0)
        e = sel[on]
        rl = row[e]
        k, accept = _rejection_step(
            u0[rl], u1[rl], v0[rl], v1[rl], count[e], lam[e],
            [c[e] for c in consts])
        k_out[on] = torch.where(accept, k, k_out[on])
    return k_out


def _poisson(K0, K1, lam, out) -> None:
    """The counts of rates ``lam`` (R, L) into ``out`` (R, L), row ``r``
    drawn under the key (K0[r], K1[r]) with a counter per element, as
    jax.random.poisson draws one row (the rate rounded to float32): Knuth
    below 10 (or NaN), the rejection from 10, 0 at 0.  Both Poisson twins
    run it, a block of rows at a time: R2's rows under folded keys, R2w's
    whole fields as one row each under keys as given."""
    R, L = lam.shape
    step = max(1, _TWIN_BLOCK // L)
    for a in range(0, R, step):
        lf = lam[a:a + step].reshape(-1).to(torch.float32)
        n = lf.numel()
        idx = torch.arange(n, dtype=torch.int64, device=lam.device)
        row, count = idx // L, idx % L
        knuth = torch.isnan(lf) | (lf < 10.0)
        K = (K0[a:a + step], K1[a:a + step])
        res = _knuth(*K, row, count,
                     torch.where(knuth, lf, 0.0)).to(torch.float32)
        res = torch.where(lf == 0, 0.0, res)
        if not bool(knuth.all()):
            res[~knuth] = _rejection(*K, row, count,
                                     torch.where(knuth, 1e5, lf), ~knuth)
        out[a:a + step] = res.view(-1, L).to(out.dtype)


def row_poisson_plain(keys, tag: int, row0: int, lam) -> torch.Tensor:
    """Counts of ``lam`` (B, nrows, ...) in its dtype, on its device."""
    B, nrows, L = _lam_shape(keys, lam)
    out = torch.empty_like(lam)
    if out.numel() == 0:
        return out
    K0, K1 = _row_keys(keys.to(lam.device), tag, row0, nrows)
    _poisson(K0, K1, lam.reshape(B * nrows, L), out.view(B * nrows, L))
    return out


def _poisson_scratch(R: int, L: int, lam) -> torch.Tensor:
    """R2/R2w's scratch for R rows of L rates: each row's chain of keys,
    step count and flag, and the list of the rejection elements (sized by
    ``fbx_poisson_scratch``: at most the rate field's bytes for rows of
    134 rates or more)."""
    words = _build.load_library().fbx_poisson_scratch(R, L,
                                                      lam.element_size())
    return torch.empty(words, dtype=torch.int32, device=lam.device)


def row_poisson_cuda(keys, tag: int, row0: int, lam) -> torch.Tensor:
    """Launch R2: counts of ``lam`` (B, nrows, ...) in its dtype, in four
    launches (the rows' chains of keys; Knuth and the list of rejection
    elements; the first acceptances; the walk)."""
    B, nrows, L = _lam_shape(keys, lam)
    _build.require_cuda(NAME_POISSON, keys, lam)
    out = torch.empty_like(lam)
    if out.numel() == 0:
        return out
    scratch = _poisson_scratch(B * nrows, L, lam)
    fn = _build.kernel_fn("fbx_row_poisson", lam.dtype)
    with torch.cuda.device(lam.device):
        err = fn(keys.data_ptr(), B, int(tag) & M32, int(row0), nrows, L,
                 lam.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                 scratch.numel(), _build.stream_ptr(lam.device))
    _build.check(err, NAME_POISSON)
    # one count a call, for R2's launches
    _build.count_launch(NAME_POISSON)
    return out


def row_poisson_draw(keys, tag: int, row0: int, lam) -> torch.Tensor:
    """R2 for a rate on a CUDA device, the plain twin for one on the CPU."""
    if lam.device.type == "cuda":
        return row_poisson_cuda(keys, tag, row0, lam)
    if lam.device.type == "cpu":
        return row_poisson_plain(keys, tag, row0, lam)
    raise ValueError(f"{NAME_POISSON}: unsupported device {lam.device}")


# ----------------------------------------------------------------------
# R1w / R2w: whole-array draws on keys taken as given
# ----------------------------------------------------------------------
def _key_method(method: str, pair: bool) -> int:
    code = _method(method)
    if code == METHODS["box_muller"] and not pair:
        raise ValueError(f"{NAME_KEY_NORMAL}: 'box_muller' draws (cos, sin) "
                         "pairs: pass pair=True")
    return code


def _key_out(keys, n: int, pair: bool, dtype, out):
    B = _check_keys(NAME_KEY_NORMAL, keys)
    if n > M32 + 1:
        raise ValueError(f"{NAME_KEY_NORMAL}: a field of {n} elements "
                         "outgrows the 32-bit counter")
    return _out(NAME_KEY_NORMAL, out, (B, n, 2) if pair else (B, n), dtype,
                keys.device)


def key_vector_path(n: int, pair: bool, out: torch.Tensor) -> bool:
    """Whether R1w writes 16-byte vectors: a field of a multiple of the
    elements in 16 bytes, ``out`` 16-byte aligned.  Else it writes element
    by element, the same values."""
    per = 16 // out.element_size() // (2 if pair else 1)
    return n % per == 0 and out.data_ptr() % 16 == 0


def key_normal_plain(keys, n: int, dtype=torch.float32,
                     method: str = "erfinv", pair: bool = False,
                     minval: float = 0.0, maxval: float = 1.0,
                     out=None) -> torch.Tensor:
    """(B, n) draws of ``method`` ((B, n, 2) with ``pair``) on each key of
    ``keys`` as given, on its device: 'erfinv' ``jax.random.normal``,
    'uniform' ``jax.random.uniform(minval, maxval)``, 'box_muller' (pair
    only) ``bm_pair``."""
    code = _key_method(method, pair)
    out = _key_out(keys, n, pair, dtype, out)
    if out.numel() == 0:
        return out
    k0, k1 = keys[:, 0:1], keys[:, 1:2]
    if pair and code != METHODS["box_muller"]:
        subkeys = [threefry2x32(k0, k1, 0, d) for d in (0, 1)]
    step = max(1, _TWIN_BLOCK // keys.shape[0])
    for a in range(0, n, step):
        sl = slice(a, min(n, a + step))
        count = torch.arange(sl.start, sl.stop, dtype=torch.int64,
                             device=keys.device)[None]
        if code == METHODS["box_muller"]:
            out[:, sl, 0], out[:, sl, 1] = _values(k0, k1, count, code,
                                                   dtype)
        elif pair:
            for d, (c0, c1) in enumerate(subkeys):
                out[:, sl, d] = _values(c0, c1, count, code, dtype, minval,
                                        maxval)
        else:
            out[:, sl] = _values(k0, k1, count, code, dtype, minval, maxval)
    return out


def key_normal_cuda(keys, n: int, dtype=torch.float32,
                    method: str = "erfinv", pair: bool = False,
                    minval: float = 0.0, maxval: float = 1.0,
                    out=None) -> torch.Tensor:
    """Launch R1w: :func:`key_normal_plain`'s draws on ``keys``' CUDA
    device."""
    code = _key_method(method, pair)
    out = _key_out(keys, n, pair, dtype, out)
    _build.require_cuda(NAME_KEY_NORMAL, keys, out)
    if out.numel() == 0:
        return out
    fn = _build.kernel_fn("fbx_key_normal", dtype)
    with torch.cuda.device(out.device):
        err = fn(keys.data_ptr(), keys.shape[0], n, code, int(pair),
                 float(minval), float(maxval),
                 int(key_vector_path(n, pair, out)), out.data_ptr(),
                 _build.stream_ptr(out.device))
    _build.check(err, NAME_KEY_NORMAL)
    _build.count_launch(NAME_KEY_NORMAL)
    return out


def key_normal_draw(keys, n: int, dtype=torch.float32,
                    method: str = "erfinv", pair: bool = False,
                    minval: float = 0.0, maxval: float = 1.0,
                    out=None) -> torch.Tensor:
    """R1w for keys on a CUDA device, the plain twin for keys on the CPU."""
    if keys.device.type == "cuda":
        return key_normal_cuda(keys, n, dtype, method, pair, minval, maxval,
                               out)
    if keys.device.type == "cpu":
        return key_normal_plain(keys, n, dtype, method, pair, minval, maxval,
                                out)
    raise ValueError(f"{NAME_KEY_NORMAL}: unsupported device {keys.device}")


def _key_lam_shape(keys, lam) -> tuple:
    """(B, n) of a rate tensor (B, ...) for B keys."""
    B = _check_keys(NAME_KEY_POISSON, keys)
    if lam.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{NAME_KEY_POISSON}: unsupported dtype {lam.dtype}")
    if lam.dim() < 1 or lam.shape[0] != B or not lam.is_contiguous():
        raise ValueError(f"{NAME_KEY_POISSON}: lam must be a contiguous "
                         f"(B={B}, ...), got {tuple(lam.shape)}")
    n = math.prod(lam.shape[1:])
    if n > M32 + 1:
        raise ValueError(f"{NAME_KEY_POISSON}: a field of {n} elements "
                         "outgrows the 32-bit counter")
    return B, n


def key_poisson_plain(keys, lam) -> torch.Tensor:
    """Counts of ``jax.random.poisson(key_b, lam[b])`` for each key of
    ``keys`` (the rates rounded to float32), in ``lam``'s dtype on its
    device, in R2w's order: Knuth's loop, each element's first acceptance
    of the rejection loop, then the rejection elements' walk."""
    B, n = _key_lam_shape(keys, lam)
    out = torch.empty_like(lam)
    if out.numel() == 0:
        return out
    keys = keys.to(lam.device)
    _poisson(keys[:, 0], keys[:, 1], lam.reshape(B, n), out.view(B, n))
    return out


def key_poisson_cuda(keys, lam) -> torch.Tensor:
    """Launch R2w: counts of ``lam`` (B, ...) in its dtype, one field per
    key, in R2's four launches (each field one row)."""
    B, n = _key_lam_shape(keys, lam)
    _build.require_cuda(NAME_KEY_POISSON, keys, lam)
    out = torch.empty_like(lam)
    if out.numel() == 0:
        return out
    scratch = _poisson_scratch(B, n, lam)
    fn = _build.kernel_fn("fbx_key_poisson", lam.dtype)
    with torch.cuda.device(lam.device):
        err = fn(keys.data_ptr(), B, n, lam.data_ptr(), out.data_ptr(),
                 scratch.data_ptr(), scratch.numel(),
                 _build.stream_ptr(lam.device))
    _build.check(err, NAME_KEY_POISSON)
    # one count a call, for R2w's launches
    _build.count_launch(NAME_KEY_POISSON)
    return out


def key_poisson_draw(keys, lam) -> torch.Tensor:
    """R2w for a rate on a CUDA device, the plain twin for one on the CPU."""
    if lam.device.type == "cuda":
        return key_poisson_cuda(keys, lam)
    if lam.device.type == "cpu":
        return key_poisson_plain(keys, lam)
    raise ValueError(f"{NAME_KEY_POISSON}: unsupported device {lam.device}")
