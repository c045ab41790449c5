"""Entry: ``pipeline.make_chained_pipeline`` over K keys a call.

A call runs the flagship single pipeline once for each of its K seeds
(``realisations_per_call``), one after another: each realisation's
whole-array keyed draws (R1w), the density draw, inverse FFTs, K1 and
the RSD remap (K2), foregrounds, noise (K1), the PCA clean with its
eigh, and both spectra (K4); ``eigh_hoist`` at the configuration's value.
It ends when the stacked ``pk_cleaned``, ``pk_density``,
``pk_cleaned_err`` and ``sigma_data`` are on the host.

The chain takes no stage clock of its own, so the entry builds it over a
single pipeline that passes on the clock of the current call:
``pipeline.make_pipeline`` is swapped for that wrapper only while the
chain is built, and with no clock the wrapper passes None, as before.
"""
from __future__ import annotations

from portbench.lib.program import grid_and_cosmology, pipeline_config
from portbench.reference.compare import MOCK_OUTPUTS
from portbench.reference.mock import MockReference, sample_gaps

SCHEME = "keys"


class Chain:
    def __init__(self, config: dict, traffic: dict, device):
        import fastbox_tpu_torch.pipeline as pipeline

        self.realisations = int(traffic["realisations_per_call"])
        self.clock = None
        grid, cosmo = grid_and_cosmology(config, device)
        make_single = pipeline.make_pipeline

        def clocked_single(*args, **kwargs):
            single = make_single(*args, **kwargs)

            def fn(generator=None, draws=None, clock=None, seed=None):
                return single(generator, draws, clock or self.clock, seed)

            fn.pre, fn.post = single.pre, single.post
            return fn

        pipeline.make_pipeline = clocked_single
        try:
            self.fn = pipeline.make_chained_pipeline(
                grid, cosmo, pipeline_config(config), device)
        finally:
            pipeline.make_pipeline = make_single

    def call(self, seeds, clock=None) -> dict:
        self.clock = clock
        out = self.fn(generators=list(seeds))
        self.clock = None
        return {k: out[k].cpu().numpy() for k in MOCK_OUTPUTS}

    def close(self) -> None:
        self.fn = None


def build(config: dict, traffic: dict, device):
    return Chain(config, traffic, device)


def reference(config: dict, traffic: dict, device, quant=None):
    """The reference in the program's place: seeds -> outputs."""
    ref = MockReference(config, device, quant)
    return lambda seeds: ref.outputs(seeds, SCHEME)


def gaps(config: dict, traffic: dict, samples, device) -> dict:
    """The widest gaps over the sampled calls ``[(seeds, outputs)]``."""
    return sample_gaps(config, samples, SCHEME, device)
