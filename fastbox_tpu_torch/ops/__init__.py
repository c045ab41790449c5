"""Operators: RSD remap, binned reductions, spectra and the nbodykit-style
estimators, CUDA kernels."""
from . import nbodykit_compat, painting, reduce, rsd, spectra
from .nbodykit_compat import ArrayCatalog, ArrayMesh, FFTCorr, FFTPower
from .reduce import binned_sums
from .spectra import (binned_power_spectrum, correlation_function,
                      correlation_multipoles, power_multipoles,
                      power_spectrum)

__all__ = ["nbodykit_compat", "painting", "reduce", "rsd", "spectra",
           "ArrayCatalog", "ArrayMesh", "FFTCorr", "FFTPower", "binned_sums",
           "binned_power_spectrum", "correlation_function",
           "correlation_multipoles", "power_multipoles", "power_spectrum"]
