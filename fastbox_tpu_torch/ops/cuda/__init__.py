"""The port's hand-written Hopper kernels (sources in ``fastbox_tpu_torch/csrc``).

One module per TPU kernel it replaces (and ``row_draw``, the row-keyed
``jax.random`` draws of the sharded paths, and ``cola_kick``):

====================  ===================================================
``noise``             K1 ``ops/pallas/noise.py::add_scaled_normal_pallas``
``rsd_fused``         K2 ``ops/pallas/rsd_fused.py::rsd_remap_wrap_pallas``,
                      K7 ``ops/pallas/rsd_fused.py::rsd_bracket_interp_pallas``
``rsd_interp``        K3 ``ops/pallas/rsd_interp.py::interp_sorted_pallas``
``binned_pk_v2``      K4 ``ops/pallas/binned_pk_v2.py::binned_pk_half_dual_pallas_v2``
``binned_pk``         K5 ``ops/pallas/binned_pk.py::binned_pk_half_dual_pallas``,
                      K6 ``ops/pallas/binned_pk.py::binned_pk_pallas``
``banded_interp``     K8 ``ops/pallas/banded_interp.py::banded_interp_pallas``
``half_draw``         K9 ``ops/pallas/half_draw.py::colored_complex_normal_pallas``,
                      ``colored_complex_normal_vz_pallas``
``mmdft``             K10 ``ops/pallas/mmdft.py::dft_c2c_axis_pallas``
``lattice_cic``       K11 ``ops/pallas/lattice_cic.py::cic_paint_lattice_pallas``,
                      ``cic_gather_lattice_pallas``, ``cic_gather3_lattice_pallas``
``row_draw``          R1 ``parallel/rng.py::row_normal``, R2
                      ``parallel/halos.py::row_poisson`` (no Pallas kernel:
                      jax.random's threefry row streams, one launch a field)
``cola_kick``         K12, the COLA kick-drift in one pass (no Pallas
                      kernel: ``fields/cola.py``'s step is XLA-fused ``jnp``)
====================  ===================================================

Each module holds the CUDA launcher (``*_cuda``), its plain PyTorch twin
(``*_plain``) and a dispatcher that takes the kernel for a CUDA tensor and
the twin for a CPU tensor.  A failed build or launch raises; nothing falls
back.
"""
from ._build import launch_counts, load_library, reset_launch_counts

__all__ = ["launch_counts", "load_library", "reset_launch_counts"]
