"""``jax.random``'s keys and whole-array draws, in torch.

The parts of ``jax.random`` that ``fastbox_tpu`` calls on its
single-device paths (jax 0.9, ``jax_threefry_partitionable`` on, 64-bit
integers on), so that a key gives the port the fields it gives
``fastbox_tpu`` off the TPU:

* a key is an ``int`` seed, read as ``jax.random.PRNGKey(seed)``: the
  words ``((s >> 32) & 0xFFFFFFFF, s & 0xFFFFFFFF)`` in two's complement;
  or a (2,) integer tensor (or array) of raw key words; a (B, 2) one is a
  batch of B keys;
* ``split(key, num)[i]`` and ``fold_in(key, d)`` hash the counter
  ``(0, i)`` / ``(0, d)`` under the key with threefry2x32;
* ``normal``, ``uniform`` and ``complex_normal`` are whole-array draws,
  element ``i`` hashing the counter of its flat index: R1w on the card, its
  plain twin on the CPU (``ops/cuda/row_draw.py``); ``poisson`` is R2w;
  ``randint`` is the host's.

Uniforms and bits equal ``jax.random``'s bit for bit; normals differ by
the libraries' ``erfinv`` (``log``, ``cos``, ``sin``) only; Poisson counts
are equal below rate 10 and differ in a few percent of the elements from
rate 10, where ``lgamma``/``log`` roundings decide acceptances
(tests/test_torch_keyed_draws.py states the bounds).  A draw runs on the
key's device when the key is a CUDA tensor, else on ``device`` (None: the
card); a key held on the host reaches the card through pinned memory,
with no host sync, and ``to_device`` moves the sub-keys of several draws
in one such copy.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .device import resolve
from .ops.cuda import row_draw

__all__ = ["M32", "seed_words", "PRNGKey", "is_key", "key_data",
           "split_words", "split", "fold_in", "to_device", "normal", "uniform", "complex_normal", "poisson",
           "randint"]

M32 = row_draw.M32


def seed_words(seed) -> list:
    """The two 32-bit words of ``jax.random.PRNGKey(seed)`` (64-bit
    integers on)."""
    s = int(seed)
    if not -2 ** 63 <= s < 2 ** 63:
        raise ValueError(f"seed {s} is outside the int64 range")
    return [(s >> 32) & M32, s & M32]


def PRNGKey(seed) -> torch.Tensor:  # noqa: N802 (jax's name)
    """``jax.random.PRNGKey(seed)``: a (2,) int64 tensor on the CPU."""
    return torch.tensor(seed_words(seed), dtype=torch.int64)


def _is_int(x) -> bool:
    return isinstance(x, (int, np.integer)) and not isinstance(x, bool)


def is_key(x) -> bool:
    """Whether ``x`` is a key (or a batch of keys) rather than a
    ``torch.Generator`` or None."""
    if _is_int(x):
        return True
    if torch.is_tensor(x):
        integer = not (x.dtype.is_floating_point or x.dtype.is_complex
                       or x.dtype == torch.bool)
    elif isinstance(x, np.ndarray):
        integer = np.issubdtype(x.dtype, np.integer)
    else:
        return False
    return integer and x.ndim in (1, 2) and x.shape[-1] == 2


def key_data(key) -> torch.Tensor:
    """The int64 words of a key: (2,), or (B, 2) for a batch, on the key's
    device (the CPU for a seed or an array)."""
    if _is_int(key):
        return PRNGKey(key)
    if not is_key(key):
        raise TypeError("a key is an int seed or a (2,) / (B, 2) integer "
                        f"tensor of key words, got {type(key).__name__}")
    t = torch.as_tensor(np.asarray(key).astype(np.int64)
                        if isinstance(key, np.ndarray) else key)
    return t.to(torch.int64) & M32


def _words(key) -> tuple[int, int]:
    """A single key's two words as Python ints (a word pair of
    :func:`split_words` is taken as given)."""
    if _is_int(key):
        a, b = seed_words(key)
        return a, b
    if isinstance(key, tuple):
        a, b = key
        return a, b
    k = key_data(key)
    if k.shape != (2,):
        raise ValueError(f"expected one key, got a batch {tuple(k.shape)}")
    a, b = k.tolist()
    return a, b


def split_words(key, num: int = 2) -> list:
    """``split(key, num)`` as a list of ``num`` word pairs (tuples of
    Python ints), hashed on the host: the cheap way to the few sub-keys
    of a draw, a pair splitting further as a key does."""
    k0, k1 = _words(key)
    return [row_draw.threefry2x32(k0, k1, 0, i) for i in range(num)]


def split(key, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: (num, 2) keys on the key's device."""
    if not (torch.is_tensor(key) and key.device.type != "cpu"):
        return torch.tensor(split_words(key, num),
                            dtype=torch.int64).reshape(num, 2)
    k = key_data(key)
    if k.shape != (2,):
        raise ValueError(f"split takes one key, got {tuple(k.shape)}")
    i = torch.arange(num, dtype=torch.int64, device=k.device)
    return torch.stack(row_draw.threefry2x32(k[0], k[1], 0, i), dim=1)


def fold_in(key, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` (``data`` taken as uint32)."""
    k0, k1 = _words(key)
    return torch.tensor(row_draw.threefry2x32(k0, k1, 0, int(data) & M32),
                        dtype=torch.int64)


def _device_keys(key, device) -> tuple[torch.Tensor, bool, torch.device]:
    """(the (B, 2) words on the draw's device, whether ``key`` was a batch,
    the device): a CUDA key's device, else ``device`` (None: the card)."""
    if torch.is_tensor(key) and key.is_cuda and key.dtype == torch.int64 \
            and key.dim() in (1, 2) and key.shape[-1] == 2:
        # on the card already (``to_device``): taken as given, no launch to
        # mask it, since the kernels read each word modulo 2^32
        return key.reshape(-1, 2).contiguous(), key.dim() == 2, key.device
    k = key_data(key)
    batched = k.dim() == 2
    k = k.reshape(-1, 2)
    dev = k.device if k.device.type == "cuda" else resolve(device)
    if dev.type == "cuda" and k.device.type == "cpu":
        # pinned and asynchronous: no host sync on the draw's path
        k = k.contiguous().pin_memory().to(dev, non_blocking=True)
    else:
        k = k.to(dev).contiguous()
    return k, batched, dev


def to_device(key, device=None) -> torch.Tensor:
    """A key's words (or a batch's, (B, 2)) on the draw's device in one
    copy, as the draws move them: a CUDA key stays where it is, else it
    goes to ``device`` (None: the card) through pinned memory, with no
    host sync.  Draws on the rows of the result copy nothing more."""
    k, batched, _ = _device_keys(key, device)
    return k if batched else k[0]


def _shape(shape) -> tuple:
    return (int(shape),) if _is_int(shape) else tuple(int(n) for n in shape)


def _draw(key, shape, dtype, device, method, pair, minval=0.0, maxval=1.0):
    shape = _shape(shape)
    keys, batched, _ = _device_keys(key, device)
    out = row_draw.key_normal_draw(keys, math.prod(shape), dtype, method,
                                   pair, minval, maxval)
    if pair:
        out = torch.view_as_complex(out)
    out = out.reshape((keys.shape[0], *shape))
    return out if batched else out[0]


def normal(key, shape=(), dtype=torch.float64, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)`` (the dtype defaults to
    jax's float under 64-bit mode); a batch of B keys adds a leading axis."""
    return _draw(key, shape, dtype, device, "erfinv", False)


def uniform(key, shape=(), dtype=torch.float64, minval: float = 0.0,
            maxval: float = 1.0, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)``."""
    return _draw(key, shape, dtype, device, "uniform", False, minval, maxval)


def complex_normal(key, shape, dtype=torch.float32, method: str = "erfinv",
                   device=None) -> torch.Tensor:
    """``re + i im`` of ``fastbox_tpu``'s ``_complex_normal(key, shape,
    dtype, method)`` in one launch: ``k1, k2 = split(key)``, then two
    normals ('erfinv', also ``complex_white_noise`` and ``white_noise``) or
    ``bm_pair(k1, k2)``'s (cos, sin) ('box_muller')."""
    if method not in ("erfinv", "box_muller"):
        raise ValueError(f"Unknown draw method '{method}'")
    return _draw(key, shape, dtype, device, method, True)


def poisson(key, lam: torch.Tensor) -> torch.Tensor:
    """``jax.random.poisson(key, lam)`` on ``lam``'s device (the rates
    rounded to float32, as jax does), the counts in ``lam``'s dtype; a
    batch of B keys takes rates (B, ...)."""
    keys, batched, _ = _device_keys(key, lam.device)
    lam = lam.contiguous()
    out = row_draw.key_poisson_draw(keys, lam if batched else lam[None])
    return out if batched else out[0]


def randint(key, shape=(), minval: int = 0, maxval: int = 2 ** 31 - 1):
    """``jax.random.randint(key, shape, minval, maxval)`` with 64-bit
    integers, on the host: an int64 CPU tensor.  ``k1, k2 = split(key)``;
    the 64-bit bits of each give the high and low halves of a 128-bit
    number reduced modulo the span, as jax does."""
    shape = _shape(shape)
    n = math.prod(shape)
    k = split(key)

    def bits(kw):
        c = torch.arange(n, dtype=torch.int64)
        hi, lo = row_draw.threefry2x32(int(kw[0]), int(kw[1]), 0, c)
        return (hi.numpy().astype(np.uint64) << np.uint64(32)) \
            | lo.numpy().astype(np.uint64)

    higher, lower = bits(k[0]), bits(k[1])
    lo_, hi_ = int(minval), int(maxval)
    span = np.uint64(1 if hi_ <= lo_ else (hi_ - lo_) % 2 ** 64)
    with np.errstate(over="ignore"):
        mult = np.uint64(2 ** 32) % span
        mult = (mult * mult) % span
        off = ((higher % span) * mult + lower % span) % span
    out = (off.astype(np.int64) + np.int64(lo_)).reshape(shape)
    return torch.from_numpy(np.ascontiguousarray(out))
