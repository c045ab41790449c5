"""Instrument and sky models: foregrounds, beams, noise, tracers, halos."""
from . import beams, foregrounds, halos, noise, tracers
from .foregrounds import ForegroundModel, PointSourceModel
from .noise import NoiseModel
from .tracers import HITracer, TracerModel

__all__ = ["beams", "foregrounds", "halos", "noise", "tracers",
           "ForegroundModel", "PointSourceModel", "NoiseModel", "HITracer",
           "TracerModel"]
