"""The port's hand-written Hopper kernels (sources in ``fastbox_tpu_torch/csrc``).

One module per TPU kernel it replaces:

====================  ===================================================
``noise``             K1 ``ops/pallas/noise.py::add_scaled_normal_pallas``
``rsd_fused``         K2 ``ops/pallas/rsd_fused.py::rsd_remap_wrap_pallas``
``rsd_interp``        K3 ``ops/pallas/rsd_interp.py::interp_sorted_pallas``
``binned_pk_v2``      K4 ``ops/pallas/binned_pk_v2.py::binned_pk_half_dual_pallas_v2``
====================  ===================================================

Each module holds the CUDA launcher (``*_cuda``), its plain PyTorch twin
(``*_plain``) and a dispatcher that takes the kernel for a CUDA tensor and
the twin for a CPU tensor.  A failed build or launch raises; nothing falls
back.
"""
from ._build import launch_counts, load_library, reset_launch_counts

__all__ = ["launch_counts", "load_library", "reset_launch_counts"]
