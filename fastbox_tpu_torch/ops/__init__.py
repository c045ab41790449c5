"""Operators: RSD remap, binned reductions, spectra helpers, CUDA kernels."""
from . import painting, reduce, rsd, spectra

__all__ = ["painting", "reduce", "rsd", "spectra"]
