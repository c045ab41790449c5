"""Entry: ``parallel.make_sharded_ensemble_step`` on a one-rank mesh.

A call is one step over B seeds (``realisations_per_call``): the row-keyed
draws of every field (R1), the density, log-normal and velocity
transforms, the RSD remap (K8), foregrounds, noise (K1), the batched PCA
clean and both binned spectra (K4).  It ends when ``pk_cleaned``,
``pk_density``, ``pk_cleaned_err`` and ``sigma_data`` are on the host.
The one-rank NCCL group is initialised on a file store in a new
directory under ``TMPDIR`` and torn down at ``close``.
"""
from __future__ import annotations

import shutil
import tempfile

from portbench.lib.program import grid_and_cosmology, pipeline_config
from portbench.reference.compare import MOCK_OUTPUTS
from portbench.reference.mock import MockReference, sample_gaps

SCHEME = "rows"


class Step:
    def __init__(self, config: dict, traffic: dict, device):
        import torch
        import torch.distributed as dist
        from fastbox_tpu_torch.parallel import make_mesh
        from fastbox_tpu_torch.parallel.mesh import init_single_rank
        from fastbox_tpu_torch.parallel.sharded import (
            make_sharded_ensemble_step)

        self.realisations = int(traffic["realisations_per_call"])
        self.store = tempfile.mkdtemp(prefix="portbench_pg_")
        if not dist.is_initialized():
            init_single_rank(torch.device(device), self.store)
        grid, cosmo = grid_and_cosmology(config, device)
        mesh = make_mesh(device=device)
        self.fn = make_sharded_ensemble_step(mesh, grid, cosmo,
                                             pipeline_config(config), device)

    def call(self, seeds, clock=None) -> dict:
        out = self.fn(seeds=seeds, clock=clock)
        return {k: out[k].cpu().numpy() for k in MOCK_OUTPUTS}

    def close(self) -> None:
        import torch.distributed as dist

        self.fn = None
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(self.store, ignore_errors=True)


def build(config: dict, traffic: dict, device):
    return Step(config, traffic, device)


def reference(config: dict, traffic: dict, device, quant=None):
    """The reference in the program's place: seeds -> outputs."""
    ref = MockReference(config, device, quant)
    return lambda seeds: ref.outputs(seeds, SCHEME)



def gaps(config: dict, traffic: dict, samples, device) -> dict:
    """The widest gaps over the sampled calls ``[(seeds, outputs)]``."""
    return sample_gaps(config, samples, SCHEME, device)
