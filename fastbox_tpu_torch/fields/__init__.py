"""Field realisation, transforms, 2LPT, lattice CIC and the COLA engine."""
from . import cola, gaussian, lattice_cic, lpt, transforms
from .cola import realise_density_cola
from .gaussian import gaussian_field_from_whitenoise, realise_density, white_noise
from .lpt import lpt_displacements

__all__ = ["cola", "gaussian", "lattice_cic", "lpt", "transforms",
           "realise_density_cola", "gaussian_field_from_whitenoise",
           "realise_density", "white_noise", "lpt_displacements"]
