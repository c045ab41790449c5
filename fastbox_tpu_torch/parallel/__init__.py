"""Multi-rank execution on ``torch.distributed``: the ('ens', 'space') mesh,
slab FFTs, the row-keyed draws, the sharded ensemble step, the sharded
spectra, PCA filter and halo counts, and the slab-sharded COLA engine with
its halo-exchange lattice paint and gather.

Counterpart of ``fastbox_tpu/parallel/`` (``mesh``, ``fft``, ``rng``,
``sharded``, ``spectra``, ``filters``, ``halos``, ``lattice``, ``cola``).  One process per rank; ``local.launch`` runs gloo ranks on
the CPU.  ``make_sharded_ensemble_step`` is imported on first use, since
``sharded`` imports the pipeline, which imports ``rng`` from here.
"""
from .fft import (pfft2_local, pfft3_local, pifft2_local, pifft3_local,
                  pirfft3_local, prfft3_local)
from .cola import make_sharded_cola
from .filters import make_sharded_pca_filter
from .halos import make_sharded_halo_counts
from .lattice import (halo_extend, halo_gather, halo_gather_many, halo_paint,
                      halo_paint_many)
from .mesh import largest_pow2_divisor, make_mesh
from .rng import (TAGS, row_complex_normal, row_draws, row_keys, row_normal,
                  row_poisson)
from .spectra import (make_sharded_correlation, make_sharded_power_multipoles,
                      make_sharded_power_spectrum)

__all__ = ["make_mesh", "largest_pow2_divisor", "make_sharded_ensemble_step",
           "pfft3_local", "pifft3_local", "pfft2_local", "pifft2_local",
           "prfft3_local", "pirfft3_local", "TAGS", "row_keys", "row_normal",
           "row_complex_normal", "row_draws", "row_poisson",
           "make_sharded_power_spectrum",
           "make_sharded_power_multipoles", "make_sharded_correlation",
           "make_sharded_pca_filter", "make_sharded_halo_counts",
           "make_sharded_cola", "halo_extend", "halo_paint",
           "halo_paint_many", "halo_gather", "halo_gather_many"]


def __getattr__(name):
    if name == "make_sharded_ensemble_step":
        from .sharded import make_sharded_ensemble_step
        return make_sharded_ensemble_step
    raise AttributeError(name)
