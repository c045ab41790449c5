"""Instrument and sky models: foregrounds, beams, noise, tracers, halos."""
from . import beams, foregrounds, halos, noise, tracers
from .noise import NoiseModel
from .tracers import HITracer, TracerModel

__all__ = ["beams", "foregrounds", "halos", "noise", "tracers", "NoiseModel",
           "HITracer", "TracerModel"]
