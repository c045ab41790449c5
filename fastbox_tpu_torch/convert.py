"""Carry fastbox_tpu's build-time state across to the port.

The pipeline has no trained weights; its "weights" are the build-time
constants: the sqrt(P boxfactor) half-grid table ``amp_half``
(fastbox_tpu/pipeline.py:775) and the ``Cosmology`` tables and scalars.
``from_jax_state`` takes them as numpy arrays and Python floats (never jax
arrays, so this module needs no jax) and returns the port's equivalents,
so that both packages can run on literally the same constants.
"""
from __future__ import annotations

import numpy as np
import torch

from .cosmology.tables import Cosmology, PowerSpectrumTable

__all__ = ["from_jax_state", "TABLES", "SCALARS"]

TABLES = ("pk_lin", "pk_nl", "pk_lin_z0")
SCALARS = ("h", "redshift", "scale_factor", "Ea", "growth", "growth_rate",
           "chi")


def from_jax_state(state: dict, device="cpu", dtype=torch.float64):
    """Build the port's ``(Cosmology, amp_half)`` from fastbox_tpu's state.

    ``state`` holds numpy arrays ``<table>_lnk`` and ``<table>_lnp`` for
    each table in ``TABLES``, the floats in ``SCALARS``, and optionally
    ``amp_half``, the (N, N, N/2+1) array from fastbox_tpu's
    ``_build_pipeline`` consts (None when absent).  Tables come back in
    ``dtype`` on ``device``; ``amp_half`` keeps its dtype until
    ``make_pipeline`` casts it to the working dtype.
    """
    for key in [f"{t}_{a}" for t in TABLES for a in ("lnk", "lnp")] \
            + list(SCALARS):
        if key not in state:
            raise KeyError(f"from_jax_state: state lacks '{key}'")
        if key.endswith(("_lnk", "_lnp")) \
                and not isinstance(state[key], np.ndarray):
            raise TypeError(f"from_jax_state: '{key}' must be a numpy array")
    tables = {t: PowerSpectrumTable.from_log_arrays(
        state[f"{t}_lnk"], state[f"{t}_lnp"], dtype, device) for t in TABLES}
    cosmology = Cosmology(params=None,
                          **{k: float(state[k]) for k in SCALARS}, **tables)
    amp = state.get("amp_half")
    if amp is not None:
        if not isinstance(amp, np.ndarray):
            raise TypeError("from_jax_state: 'amp_half' must be a numpy array")
        amp = torch.tensor(amp, device=device)
    return cosmology, amp
