"""Entry: ``fields.cola.realise_density_cola`` from one seed a call.

A call draws the white noise from the key (R1w), sets up the engine (its
host step schedule), runs 2LPT and the configured COLA steps (each a CIC
paint K11a under the band ladder, a Poisson solve, a fused force gather
K11c and the kick-drift passes), and the final paints with velocities.
It ends when the density (N, N, N) and the velocities (3, N, N, N) are on
the host, copied into two page-locked buffers made at set-up: a fresh
pageable array each call would time the host's page faults (~110 ms of a
~290 ms call on an H100's host).
"""
from __future__ import annotations

from portbench.lib.program import grid_and_cosmology
from portbench.reference.cola import ColaReference
from portbench.reference.compare import cola_gaps, worst


def _dtype(config):
    import torch

    return getattr(torch, config["cola"]["dtype"])


class Cola:
    realisations = 1

    def __init__(self, config: dict, traffic: dict, device):
        import torch

        self.device = device
        self.c = config["cola"]
        self.grid, self.cosmo = grid_and_cosmology(
            config, device, redshift=float(self.c["redshift"]))
        self.dtype = _dtype(config)
        N = int(config["nsamp"])
        pin = torch.device(device).type == "cuda"
        self.host = {
            "delta": torch.empty((N, N, N), dtype=self.dtype, pin_memory=pin),
            "vel": torch.empty((3, N, N, N), dtype=self.dtype,
                               pin_memory=pin)}

    def call(self, seeds, clock=None) -> dict:
        from fastbox_tpu_torch.fields.cola import realise_density_cola

        (seed,) = seeds
        delta, vel = realise_density_cola(
            seed, self.grid, self.cosmo, redshift=float(self.c["redshift"]),
            redshift_init=float(self.c["redshift_init"]),
            n_steps=int(self.c["n_steps"]), dtype=self.dtype,
            keep_velocities=True, lattice_B=int(self.c["lattice_B"]),
            clock=clock, device=self.device)
        self.host["delta"].copy_(delta)
        self.host["vel"].copy_(vel)
        return {k: v.numpy() for k, v in self.host.items()}

    def close(self) -> None:
        self.grid = self.cosmo = self.host = None


def build(config: dict, traffic: dict, device):
    return Cola(config, traffic, device)


def reference(config: dict, traffic: dict, device, quant=None):
    """The reference in the program's place: seeds -> outputs."""
    ref = ColaReference(config, device, quant)

    def outputs(seeds) -> dict:
        r = ref.realise(seeds[0])
        return {"delta": r["delta"].cpu().numpy(),
                "vel": r["vel"].cpu().numpy()}

    return outputs


def gaps(config: dict, traffic: dict, samples, device) -> dict:
    """The widest gaps over the sampled calls ``[(seeds, outputs)]``."""
    import torch

    ref = ColaReference(config, device)
    out = []
    for seeds, o in samples:
        r = ref.realise(seeds[0])
        out.append(cola_gaps(torch.from_numpy(o["delta"]).to(device),
                             torch.from_numpy(o["vel"]).to(device), r))
        del r
    return worst(out)
