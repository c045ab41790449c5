"""fastbox_tpu_torch: the fastbox_tpu 21cm mock pipeline in PyTorch + CUDA.

A port of ``fastbox_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100.  It
keeps fastbox_tpu's module paths and function names; ``fastbox_tpu`` stays
the reference each part is tested against.  Plain tensor code is PyTorch
(cuFFT and cuSOLVER through ``torch.fft`` and ``torch.linalg``); each
Pallas kernel on the ported path is a hand-written CUDA kernel in
``csrc/`` beside a plain PyTorch twin (``ops/cuda``).  This package never
imports jax.

Main path::

    from fastbox_tpu_torch.cosmology import build_cosmology
    from fastbox_tpu_torch.grid import GridSpec
    from fastbox_tpu_torch.pipeline import PipelineConfig, make_pipeline

    grid = GridSpec.create(box_scale=4e3, nsamp=256, redshift=0.8)
    cosmo = build_cosmology(dict(Omega_c=0.25, Omega_b=0.05, h=0.7,
                                 n_s=0.95, sigma8=0.8), redshift=0.8,
                            device="cuda")
    fn = make_pipeline(grid, cosmo, PipelineConfig(), device="cuda")
    out = fn(torch.Generator(device="cuda").manual_seed(0))

The reference's object API is ``CosmoBox`` (``box.py``) with the models
(``models``), the cleaners (``filters``) and checkpoints (``io``); the
slab-sharded COLA engine is ``parallel.make_sharded_cola``.
"""
from . import cosmology, fields, filters, grid, io, models, ops, pipeline, utils
from .box import CosmoBox, default_cosmo

# Reference-style module aliases (`fastbox.tracers`, `fastbox.noise`, ...)
from .models import foregrounds, noise, tracers

__all__ = ["cosmology", "fields", "filters", "grid", "io", "models", "ops",
           "pipeline", "utils", "CosmoBox", "default_cosmo", "foregrounds",
           "noise", "tracers"]
