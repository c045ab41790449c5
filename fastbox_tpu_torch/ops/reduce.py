"""Binned reductions (counterpart of fastbox_tpu/ops/reduce.py:75-109).

fastbox_tpu accumulates its histograms as one-hot matmuls on the MXU;
here ``index_add_`` into float64 bins does the same job.  This is the
plain twin of the K4 kernel (``ops/cuda/binned_pk_v2.py``).
"""
from __future__ import annotations

import torch

__all__ = ["binned_weighted_dual"]


def binned_weighted_dual(values1, values2, weights, bin_idx, nbins: int):
    """Two fields, one histogram pass: (sum w*v1, sum w*v1^2, sum w*v2,
    sum w*v2^2, sum w) per bin, accumulated in float64 and returned in
    values1's dtype.  Entries with ``bin_idx >= nbins`` are ignored."""
    v1 = values1.reshape(-1).to(torch.float64)
    v2 = values2.reshape(-1).to(torch.float64)
    w = weights.reshape(-1).to(torch.float64)
    idx = torch.clamp(bin_idx.reshape(-1).long(), max=nbins)
    wv1 = w * v1
    wv2 = w * v2
    stats = (wv1, wv1 * v1, wv2, wv2 * v2, w)
    acc = torch.zeros((len(stats), nbins + 1), dtype=torch.float64,
                      device=v1.device)
    for k, s in enumerate(stats):
        acc[k].index_add_(0, idx, s)
    return tuple(acc[k, :nbins].to(values1.dtype) for k in range(len(stats)))
