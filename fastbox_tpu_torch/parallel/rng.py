"""Mesh-independent row-keyed noise draws.

Counterpart of ``fastbox_tpu/parallel/rng.py``.  Every noise field of the
sharded step (and of the single pipeline's ``noise_scheme='rows'``) is
drawn per leading-axis row, from a stream keyed by (seed, tag, global row
index) alone, so a slab draws exactly its rows of the full field whatever
the mesh shape, and the single pipeline draws the same field as any mesh.

``jax.random``'s threefry streams are not reproduced: each row is one
``torch.randn`` on a generator seeded with a fixed 64-bit mix (splitmix64)
of (seed, tag, row).  Streams differ between the CPU and the card, as
``torch.Generator``'s do.  That is one small launch per row, N per field.
``row_poisson`` draws the halo counts the same way, one ``torch.poisson``
per row (fastbox_tpu/parallel/halos.py:29-42).
"""
from __future__ import annotations

import torch

from ..device import resolve

__all__ = ["TAGS", "ROW_NDIM", "row_seed", "row_normal", "row_complex_normal",
           "row_draws", "row_poisson"]

# Stream tags (fastbox_tpu/parallel/rng.py:28-36)
TAGS = {
    "density": 1,
    "sigma_nl": 17,
    "fg_re": 101,
    "fg_im": 102,
    "alpha": 103,
    "noise": 202,
    "halos": 301,
}

# Row shape of each pipeline field: (N,) ** ndim after the row axis
ROW_NDIM = {"density": 2, "sigma_nl": 2, "noise": 2, "fg_re": 1, "fg_im": 1,
            "alpha": 1}

_MASK = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return x ^ (x >> 31)


def row_seed(seed: int, tag: int, row: int) -> int:
    """The 64-bit generator seed of global row ``row`` of stream ``tag``."""
    return _splitmix64(_splitmix64(_splitmix64(int(seed) & _MASK) ^ int(tag))
                       ^ int(row))


def row_normal(seed: int, tag: int, row0: int, nrows: int, row_shape,
               dtype=torch.float32, device=None, out=None) -> torch.Tensor:
    """``nrows`` standard-normal rows of ``row_shape`` starting at global
    row ``row0``: shape ``(nrows, *row_shape)`` on ``device`` (or written
    into ``out``, whose device and dtype then rule)."""
    if out is None:
        out = torch.empty((nrows, *row_shape), dtype=dtype,
                          device=resolve(device))
    dtype, device = out.dtype, out.device
    gen = torch.Generator(device=device)
    for i in range(nrows):
        gen.manual_seed(row_seed(seed, tag, row0 + i))
        torch.randn(tuple(row_shape), generator=gen, dtype=dtype,
                    device=device, out=out[i])
    return out


def row_poisson(seed: int, tag: int, row0: int, lam) -> torch.Tensor:
    """Poisson draws of the rates ``lam`` (nrows, ...), row ``i`` from a
    generator seeded with ``row_seed(seed, tag, row0 + i)`` on ``lam``'s
    device, so that a slab draws exactly its rows of the full field whatever
    the mesh shape.  Returns counts in ``lam``'s dtype."""
    out = torch.empty_like(lam)
    gen = torch.Generator(device=lam.device)
    for i in range(lam.shape[0]):
        gen.manual_seed(row_seed(seed, tag, row0 + i))
        out[i] = torch.poisson(lam[i], generator=gen)
    return out


def row_complex_normal(seed: int, re_tag: int, im_tag: int, row0: int,
                       nrows: int, row_shape, dtype=torch.float32,
                       device=None) -> torch.Tensor:
    """Complex rows ``re + i im`` with independent unit-normal parts."""
    return torch.complex(
        row_normal(seed, re_tag, row0, nrows, row_shape, dtype, device),
        row_normal(seed, im_tag, row0, nrows, row_shape, dtype, device))


def row_draws(seed: int, names, N: int, row0: int = 0,
              nrows: int | None = None, dtype=torch.float32,
              device=None) -> dict:
    """Rows [row0, row0 + nrows) of the named pipeline fields (``TAGS``
    keys in ``ROW_NDIM``) of an N^3 realisation: ``{name: (nrows, N[, N])}``.
    """
    nrows = N - row0 if nrows is None else nrows
    return {n: row_normal(seed, TAGS[n], row0, nrows, (N,) * ROW_NDIM[n],
                          dtype, device) for n in names}
