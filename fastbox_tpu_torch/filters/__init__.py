"""Foreground cleaning filters."""
from .pca import pca_filter

__all__ = ["pca_filter"]
