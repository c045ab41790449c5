"""Analysis/estimation layer (L5): voids, inpainting, forecasts, datacubes.

Torch counterpart of ``fastbox_tpu/analysis``, with the same names."""
from . import datacube, forecast, inpaint, voids
from .datacube import (
    grid_catalogue,
    interpolate_onto_grid,
    replace_nan_with_channel_mean,
)
from .inpaint import (
    gaussian_cr_1d,
    lssa_decorr_matrix,
    lssa_fit_modes,
    lssa_pspec,
    simple_signal_cov,
    trim_flagged_channels,
)
from .voids import (
    apply_watershed,
    stack_voids,
    trim_by_volume,
    void_centroid,
    void_radii,
    watershed_labels,
)

__all__ = [
    "datacube",
    "forecast",
    "inpaint",
    "voids",
    "grid_catalogue",
    "interpolate_onto_grid",
    "replace_nan_with_channel_mean",
    "gaussian_cr_1d",
    "lssa_decorr_matrix",
    "lssa_fit_modes",
    "lssa_pspec",
    "simple_signal_cov",
    "trim_flagged_channels",
    "apply_watershed",
    "stack_voids",
    "trim_by_volume",
    "void_centroid",
    "void_radii",
    "watershed_labels",
]
