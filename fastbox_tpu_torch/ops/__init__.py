"""Operators: RSD remap, binned reductions, spectra and the nbodykit-style
estimators, CUDA kernels."""
from . import nbodykit_compat, painting, reduce, rsd, spectra
from .nbodykit_compat import ArrayCatalog, ArrayMesh, FFTCorr, FFTPower
from .painting import compensation, overdensity_from_catalogue, paint_catalogue
from .reduce import binned_sum_sumsq_count, binned_sums
from .rsd import redshift_space_density
from .spectra import (binned_power_spectrum, correlation_function,
                      correlation_multipoles, power_multipoles,
                      power_spectrum)

__all__ = ["nbodykit_compat", "painting", "reduce", "rsd", "spectra",
           "ArrayCatalog", "ArrayMesh", "FFTCorr", "FFTPower", "compensation",
           "overdensity_from_catalogue", "paint_catalogue",
           "binned_sum_sumsq_count", "binned_sums", "redshift_space_density",
           "binned_power_spectrum", "correlation_function",
           "correlation_multipoles", "power_multipoles", "power_spectrum"]
