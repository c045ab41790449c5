"""Field realisation, transforms, 2LPT, lattice CIC and the COLA engine."""
from . import cola, gaussian, lattice_cic, lpt, transforms
from .cola import realise_density_cola
from .gaussian import (gaussian_field_from_whitenoise, realise_density,
                       realise_potential, realise_velocity, white_noise)
from .lpt import lpt_displacements
from .transforms import (apply_transfer_fn, lognormal, smooth_field, window,
                         window1)

__all__ = ["cola", "gaussian", "lattice_cic", "lpt", "transforms",
           "realise_density_cola", "gaussian_field_from_whitenoise",
           "realise_density", "realise_potential", "realise_velocity",
           "white_noise", "lpt_displacements", "apply_transfer_fn",
           "lognormal", "smooth_field", "window", "window1"]
