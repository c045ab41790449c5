"""Foreground cleaning filters."""
from .pca import pca_filter, pca_filter_subspace

__all__ = ["pca_filter", "pca_filter_subspace"]
