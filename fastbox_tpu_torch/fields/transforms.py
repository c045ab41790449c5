"""Stateless field transforms (counterpart of fastbox_tpu/fields/transforms.py)."""
from __future__ import annotations

import torch

__all__ = ["lognormal"]


def lognormal(delta_x: torch.Tensor) -> torch.Tensor:
    """Log-normal transform exp(d)/<exp(d)> - 1 (box.py:441-460).

    nbodykit-style normalisation; see Eq. 3.1 of arXiv:1706.09195.
    """
    d = torch.exp(delta_x)
    return d / torch.mean(d) - 1.0
