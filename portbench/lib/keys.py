"""The seeds a run hands the program.

Realisation ``j`` of call ``i`` of a run with seed ``seed`` gets the seed
``(seed mod 2^42) * 2^21 + 2^20 + (i + 1) * R + j`` (R realisations a
call), which the program reads as ``jax.random.PRNGKey`` of it: different
for every (seed, call, realisation) of a run, the same in every run of one
seed.  Warm-up calls take i < 0.  The program gets only these seeds.
"""
from __future__ import annotations

_SHIFT = 21


def realisation_seeds(seed: int, i: int, R: int) -> list[int]:
    """The R seeds of call ``i``."""
    base = (int(seed) % (1 << 42)) << _SHIFT
    first = (i + 1) * R + (1 << (_SHIFT - 1))
    if first < 0 or first + R > (1 << _SHIFT):
        raise ValueError(f"call {i} is out of the seed space")
    return [base + first + j for j in range(R)]
