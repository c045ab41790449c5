"""Foreground-cleaning filters (counterpart of fastbox_tpu/filters).

PCA, ICA, NMF, kernel PCA, the angular bandpass filters, least-squares
component fitting and GPR, each on its input's device; a float32 cube is
cleaned in float64 and the result rounded once (``pca._work``).
"""
from .bandpass import angular_bandpass_filter, bandpower_pca_filter
from .gpr import KernelSpec, gpr_filter
from .ica import fastica, ica_filter
from .kpca import kernel_pca_filter, kernel_pca_filter_legacy
from .lsq import LSQfitting, lsq_synchrotron_fit
from .nmf import nmf, nmf_filter
from .pca import mean_spectrum_filter, pca_filter, pca_filter_subspace

__all__ = [
    "angular_bandpass_filter",
    "bandpower_pca_filter",
    "fastica",
    "gpr_filter",
    "KernelSpec",
    "ica_filter",
    "kernel_pca_filter",
    "kernel_pca_filter_legacy",
    "LSQfitting",
    "lsq_synchrotron_fit",
    "nmf",
    "nmf_filter",
    "mean_spectrum_filter",
    "pca_filter",
    "pca_filter_subspace",
]
