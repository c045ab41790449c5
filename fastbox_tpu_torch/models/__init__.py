"""Instrument and sky models."""
from . import foregrounds, noise

__all__ = ["foregrounds", "noise"]
