"""The device an entry point runs on.

Entry points take ``device=None``, which means the CUDA card; a run on the
CPU (the plain twins of every kernel) has to be asked for with
``device="cpu"``.  Without CUDA, None raises rather than falling back.  A
function given tensors runs on their device (``of``) and moves other
arrays there (``on``).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve", "of", "on"]


def resolve(device=None) -> torch.device:
    """``torch.device(device)``, with None meaning ``cuda``; raises
    ValueError for None when CUDA is not available."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise ValueError(
            "no CUDA device: pass device=\"cpu\" to run on the CPU "
            "(the kernels' plain twins)")
    return torch.device("cuda")


def of(*arrays, device=None) -> torch.device:
    """The device of the first tensor among ``arrays``; with none,
    ``resolve(device)``."""
    for a in arrays:
        if isinstance(a, torch.Tensor):
            return a.device
    return resolve(device)


def on(a, device: torch.device) -> torch.Tensor:
    """``a`` (a tensor, numpy array or scalar) as a tensor on ``device``,
    keeping numpy's dtype (a Python float becomes float64)."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.as_tensor(np.asarray(a), device=device)
