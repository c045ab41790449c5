"""What the entries share to build the program under test from a
configuration file: its grid and its cosmology (``fastbox_tpu_torch``)."""
from __future__ import annotations


def grid_and_cosmology(config: dict, device, redshift=None):
    """(GridSpec, Cosmology) of ``config`` on ``device``; the cosmology's
    tables at ``redshift`` (default: the box's)."""
    from fastbox_tpu_torch.cosmology import build_cosmology
    from fastbox_tpu_torch.grid import GridSpec

    z = float(config["redshift"])
    grid = GridSpec.create(box_scale=float(config["box_mpc"]),
                           nsamp=int(config["nsamp"]), redshift=z)
    cosmo = build_cosmology(config["cosmology"],
                            redshift=z if redshift is None else redshift,
                            device=device)
    return grid, cosmo


def pipeline_config(config: dict):
    """The program's ``PipelineConfig`` of ``config['pipeline']``."""
    from fastbox_tpu_torch.pipeline import PipelineConfig

    return PipelineConfig(**config["pipeline"])
