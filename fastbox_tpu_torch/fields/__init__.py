"""Field realisation and transforms."""
from . import gaussian, transforms

__all__ = ["gaussian", "transforms"]
