"""Binned reductions (counterpart of fastbox_tpu/ops/reduce.py).

fastbox_tpu accumulates its histograms as one-hot matmuls on the MXU;
here ``index_add_`` into float64 bins does the same job.
``binned_weighted_dual`` is the plain twin of the K4 and K5 kernels
(``ops/cuda/binned_pk_v2.py``, ``ops/cuda/binned_pk.py``) and the
pipeline's plain reduction (``pallas_pk='off'``); ``binned_sum_sumsq_count``
is K6's twin; ``binned_weighted_sum_sumsq_count`` serves the half-spectrum
core of ``ops/spectra.binned_power_spectrum``; ``binned_sums`` the
estimators' histograms (``power_spectrum`` and the rest).
"""
from __future__ import annotations

import torch

__all__ = ["binned_sum_sumsq_count", "binned_sums",
           "binned_weighted_sum_sumsq_count", "binned_weighted_dual"]


def _binned(stats, bin_idx, nbins: int, out_dtype):
    """Per-bin sums of each flat float64 statistic; entries with
    ``bin_idx >= nbins`` are ignored."""
    idx = torch.clamp(bin_idx.reshape(-1).long(), max=nbins)
    acc = torch.zeros((len(stats), nbins + 1), dtype=torch.float64,
                      device=stats[0].device)
    for k, s in enumerate(stats):
        acc[k].index_add_(0, idx, s)
    return tuple(acc[k, :nbins].to(out_dtype) for k in range(len(stats)))


def binned_sum_sumsq_count(values, bin_idx, nbins: int):
    """Per-bin (sum, sum of squares, count) in one pass."""
    v = values.reshape(-1).to(torch.float64)
    return _binned((v, v * v, torch.ones_like(v)), bin_idx, nbins,
                   values.dtype)


def binned_sums(values, bin_idx, nbins: int):
    """Per-bin sums only, accumulated in float64 and returned in
    ``values``' dtype."""
    return _binned((values.reshape(-1).to(torch.float64),), bin_idx, nbins,
                   values.dtype)[0]


def binned_weighted_sum_sumsq_count(values, weights, bin_idx, nbins: int):
    """Weighted per-bin (sum w*v, sum w*v^2, sum w): half-spectrum mode
    counting, where interior modes carry multiplicity 2."""
    v = values.reshape(-1).to(torch.float64)
    w = weights.reshape(-1).to(torch.float64)
    wv = w * v
    return _binned((wv, wv * v, w), bin_idx, nbins, values.dtype)


def binned_weighted_dual(values1, values2, weights, bin_idx, nbins: int):
    """Two fields, one histogram pass: (sum w*v1, sum w*v1^2, sum w*v2,
    sum w*v2^2, sum w) per bin, accumulated in float64 and returned in
    values1's dtype."""
    v1 = values1.reshape(-1).to(torch.float64)
    v2 = values2.reshape(-1).to(torch.float64)
    w = weights.reshape(-1).to(torch.float64)
    wv1 = w * v1
    wv2 = w * v2
    return _binned((wv1, wv1 * v1, wv2, wv2 * v2, w), bin_idx, nbins,
                   values1.dtype)
