"""Operators: RSD remap, binned reductions, spectra helpers, CUDA kernels."""
from . import reduce, rsd, spectra

__all__ = ["reduce", "rsd", "spectra"]
