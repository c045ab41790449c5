"""jax.random's threefry streams in plain torch, frozen for the reference.

The draws the program makes from a seed, worked out again from the seed:
``jax.random.PRNGKey(seed)`` with 64-bit integers on (words ``(s >> 32) &
M, s & M``), ``split`` and ``fold_in`` as threefry2x32 of the counter
``(0, i)``, and jax 0.9's partitionable bits (element ``j`` hashes ``(0,
j)``; a float32 takes the XOR of the two output words; the
configurations draw float32 only).  ``normal`` is ``sqrt(2) erfinv(u)``
with u uniform on [nextafter(-1, 0), 1), the scale and shift of the
uniform fused into one multiply-add as XLA's CPU backend fuses them.

Every function takes plain ints or int64 tensors on any device and
computes in int64 tensors masked to 32 bits, a block of elements at a
time.
"""
from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_BLOCK = 1 << 22


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) on 32-bit words held in Python ints or
    int64 tensors (broadcasting); returns the two output words."""
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


def seed_words(seed: int) -> tuple[int, int]:
    """The key words of ``jax.random.PRNGKey(seed)`` (64-bit mode)."""
    s = int(seed)
    return (s >> 32) & M32, s & M32


def split(key: tuple[int, int], num: int) -> list[tuple[int, int]]:
    """``jax.random.split(key, num)`` as word pairs."""
    return [threefry2x32(key[0], key[1], 0, i) for i in range(num)]


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in(key, data)``."""
    return threefry2x32(key[0], key[1], 0, int(data) & M32)


def _unit(k0, k1, count, dtype):
    """jax's float32 in [0, 1) of each counter under each key."""
    b0, b1 = threefry2x32(k0, k1, 0, count)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def _normal(k0, k1, count, dtype):
    """``jax.random.normal``'s values at ``count`` under the keys."""
    if dtype != torch.float32:
        raise NotImplementedError("the configurations draw in float32")
    one = torch.tensor(1.0, dtype=dtype, device=count.device)
    lo = torch.nextafter(-one, torch.zeros_like(one))
    u = _unit(k0, k1, count, dtype)
    # the multiply-add rounded once: the float32 product is exact in float64
    fused = (u.double() * (one - lo).double() + lo.double()).float()
    return math.sqrt(2.0) * torch.erfinv(torch.maximum(lo, fused))


def key_normal(keys: torch.Tensor, n: int, dtype=torch.float32
               ) -> torch.Tensor:
    """(B, n) ``jax.random.normal(key, (n,))`` for each row of the (B, 2)
    int64 ``keys``, on their device."""
    out = torch.empty((keys.shape[0], n), dtype=dtype, device=keys.device)
    k0, k1 = keys[:, 0:1], keys[:, 1:2]
    step = max(1, _BLOCK // keys.shape[0])
    for a in range(0, n, step):
        count = torch.arange(a, min(n, a + step), dtype=torch.int64,
                             device=keys.device)[None]
        out[:, a:a + count.shape[1]] = _normal(k0, k1, count, dtype)
    return out


def _key_tensor(pairs, device) -> torch.Tensor:
    return torch.tensor([list(p) for p in pairs], dtype=torch.int64,
                        device=device).reshape(-1, 2)


def normal(key: tuple[int, int], shape, dtype=torch.float32,
           device="cpu") -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)``."""
    n = math.prod(shape)
    return key_normal(_key_tensor([key], device), n, dtype)[0].reshape(shape)


def complex_normal(key: tuple[int, int], shape, dtype=torch.float32,
                   device="cpu") -> torch.Tensor:
    """``re + i im`` with ``re, im = normal(k) for k in split(key)``."""
    re, im = (normal(k, shape, dtype, device) for k in split(key, 2))
    return torch.complex(re, im)


def row_normal(seeds, tag: int, nrows: int, row_shape, dtype=torch.float32,
               device="cpu") -> torch.Tensor:
    """(B, nrows, *row_shape): row ``r`` of seed ``s`` is
    ``normal(fold_in(fold_in(PRNGKey(s), tag), r), row_shape)``."""
    L = math.prod(row_shape)
    pairs = []
    for s in seeds:
        kt = fold_in(seed_words(s), tag)
        pairs += [fold_in(kt, r) for r in range(nrows)]
    vals = key_normal(_key_tensor(pairs, device), L, dtype)
    return vals.reshape(len(seeds), nrows, *row_shape)
