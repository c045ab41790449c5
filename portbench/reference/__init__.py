"""The plain reference that decides ``correct``.

Plain PyTorch and NumPy (and SciPy's quadrature for the cosmology).  It
imports neither ``jax`` nor ``fastbox_tpu`` nor ``fastbox_tpu_torch``, and
takes nothing that the program made: it draws the same keyed streams from
the same seeds, builds its own power-spectrum tables and works every field
out again, by default in float64.
"""
