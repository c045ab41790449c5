"""Mesh-independent row-keyed noise draws, jax.random's own streams.

Counterpart of ``fastbox_tpu/parallel/rng.py``.  Every noise field of the
sharded step (and of the single pipeline's ``noise_scheme='rows'``) is
drawn per leading-axis row, row ``r`` of key ``k`` with
``fold_in(fold_in(k, tag), row0 + r)``, so a slab draws exactly its rows
of the full field whatever the mesh shape, and the single pipeline draws
the same field as any mesh.

The streams are ``fastbox_tpu``'s: a seed ``s`` stands for
``jax.random.PRNGKey(s)`` with 64-bit integers on (``keys.seed_words``); a
(B, 2) integer tensor passes raw ``jax.random`` keys as they are.  The
draws reproduce jax's threefry bits and uniforms exactly on every device
(R1/R2, ``ops/cuda/row_draw.py``: the CUDA kernels on the card, their
plain twins on the CPU), so the card, the CPU and ``fastbox_tpu`` draw the
same rows for the same seed: the uniforms bit for bit, the normals within
a few ulp of the ``erfinv`` (or ``sin``/``cos``/``log``) of each library,
the Poisson counts as long as no ``log``/``lgamma`` rounding decides a
draw (tests/test_torch_row_draws.py states the measured bounds).

Each draw takes a seed (no batch axis), or a sequence of seeds, a 1-D
integer tensor of seeds or a (B, 2) key tensor (a leading batch axis of
length B), and draws the whole field of every key in one launch.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve
from ..keys import M32 as _M32
from ..keys import seed_words as _seed_words
from ..ops.cuda import row_draw

__all__ = ["TAGS", "ROW_NDIM", "row_keys", "row_normal",
           "row_complex_normal", "row_draws", "row_poisson"]

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

def row_keys(seed, device=None) -> tuple[torch.Tensor, bool]:
    """``(keys, batched)``: the (B, 2) int64 key words of ``seed`` on
    ``device``, and whether ``seed`` carries a batch axis.  A seed is
    ``PRNGKey(seed)``'s key; a (B, 2) tensor holds raw keys."""
    device = resolve(device)
    if torch.is_tensor(seed) and seed.dim() == 2:
        if seed.shape[1] != 2 or seed.is_floating_point():
            raise ValueError("a key tensor must be (B, 2) integer words, got "
                             f"{tuple(seed.shape)} {seed.dtype}")
        keys = seed.to(device=device, dtype=torch.int64) & _M32
        return keys.contiguous(), True
    batched = np.ndim(seed) == 1
    seeds = [int(s) for s in seed] if batched else [seed]
    keys = torch.tensor([_seed_words(s) for s in seeds],
                        dtype=torch.int64).reshape(-1, 2)
    if device.type == "cuda":
        # pinned and asynchronous: no host sync on the draw's path
        keys = keys.pin_memory().to(device, non_blocking=True)
    else:
        keys = keys.to(device)
    return keys, batched


def row_normal(seed, tag: int, row0: int, nrows: int, row_shape,
               dtype=torch.float32, device=None, out=None,
               method: str = "erfinv") -> torch.Tensor:
    """``nrows`` standard-normal rows of ``row_shape`` from global row
    ``row0``: ``(nrows, *row_shape)``, with a leading batch axis for a
    batch of seeds or keys; on ``device`` (or written into ``out``, whose
    device and dtype then rule).  ``method``: 'erfinv' (``jax.random.
    normal``) or 'box_muller' (``fastbox_tpu``'s lean stream)."""
    if out is not None:
        dtype, device = out.dtype, out.device
    keys, batched = row_keys(seed, device)
    res = row_draw.row_normal_draw(
        keys, tag, row0, nrows, row_shape, dtype, method,
        out if out is None or batched else out.unsqueeze(0))
    if out is not None:
        return out
    return res if batched else res[0]


def row_poisson(seed, tag: int, row0: int, lam) -> torch.Tensor:
    """Poisson counts of the rates ``lam`` (nrows, ...), or (B, nrows, ...)
    for a batch of B seeds or keys, row ``i`` of key ``k`` drawn with
    ``fold_in(fold_in(k, tag), row0 + i)`` on ``lam``'s device, as
    ``jax.random.poisson`` draws them (the rates rounded to float32), so
    that a slab draws exactly its rows of the full field whatever the mesh
    shape.  Returns counts in ``lam``'s dtype."""
    keys, batched = row_keys(seed, lam.device)
    lam = lam.contiguous()
    res = row_draw.row_poisson_draw(keys, tag, row0,
                                    lam if batched else lam.unsqueeze(0))
    return res if batched else res[0]


def row_complex_normal(seed, re_tag: int, im_tag: int, row0: int,
                       nrows: int, row_shape, dtype=torch.float32,
                       device=None, method: str = "erfinv") -> torch.Tensor:
    """Complex rows ``re + i im`` with independent unit-normal parts."""
    return torch.complex(
        row_normal(seed, re_tag, row0, nrows, row_shape, dtype, device,
                   method=method),
        row_normal(seed, im_tag, row0, nrows, row_shape, dtype, device,
                   method=method))


def row_draws(seed, names, N: int, row0: int = 0,
              nrows: int | None = None, dtype=torch.float32,
              device=None) -> dict:
    """Rows [row0, row0 + nrows) of the named pipeline fields (``TAGS``
    keys in ``ROW_NDIM``) of an N^3 realisation: ``{name: (nrows, N[, N])}``
    (a leading batch axis for a batch of seeds), one launch a field."""
    nrows = N - row0 if nrows is None else nrows
    return {n: row_normal(seed, TAGS[n], row0, nrows, (N,) * ROW_NDIM[n],
                          dtype, device) for n in names}
