"""The device an entry point runs on.

Entry points take ``device=None``, which means the CUDA card; a run on the
CPU (the plain twins of every kernel) has to be asked for with
``device="cpu"``.  Without CUDA, None raises rather than falling back.
"""
from __future__ import annotations

import torch

__all__ = ["resolve"]


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
