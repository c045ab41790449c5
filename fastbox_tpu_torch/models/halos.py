"""Poisson halo sampling.

Counterpart of ``fastbox_tpu/models/halos.py:28-166`` (reference
``fastbox/halos.py``).  The count field (halos.py:53-117) is a Poisson draw
of the rate ``halo_rate`` on the field's device.  The catalogue
(halos.py:120-176) is either the reference's ragged host form
(``halo_catalogue_host``) or a fixed-size padded buffer on the device
(``realise_halo_catalogue_padded``).  A key draws fastbox_tpu's fields
(``jax.random.poisson`` by R2w, ``uniform`` by R1w, ``randint`` on the
host); a ``torch.Generator`` torch's.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import keys
from ..cosmology import massfunction as mf

__all__ = ["halo_rate", "halo_count_field", "halo_catalogue_host",
           "realise_halo_catalogue_padded", "HaloDistribution"]


def _per_channel(v, like):
    """A scalar or a per-channel (last axis) vector, broadcastable to
    ``like``."""
    t = torch.atleast_1d(torch.as_tensor(v, dtype=like.dtype,
                                         device=like.device))
    return t[None, None, :] if t.dim() == 1 else t


def halo_rate(delta_x, grid, nbar, bias, lognormal: bool = False):
    """The Poisson mean of the halo count per voxel (halos.py:53-117):
    ``V_vox nbar (1 + bias delta_x)``, clipped at zero only in the
    non-lognormal branch (halos.py:112-113), NaNs set to zero
    (halos.py:116).  ``nbar`` and ``bias`` are scalars or per-channel."""
    nbar = _per_channel(nbar, delta_x)
    bias = _per_channel(bias, delta_x)
    delta_h = bias * delta_x
    if lognormal:
        d = torch.exp(delta_h)
        delta_h = d / torch.mean(d) - 1.0
    rate = grid.voxel_volume * nbar * (1.0 + delta_h)
    if not lognormal:
        rate = torch.clamp(rate, min=0.0)
    return torch.nan_to_num(rate)


def halo_count_field(generator, delta_x, grid, nbar, bias,
                     lognormal: bool = False):
    """Poisson halo counts per voxel (int64) of :func:`halo_rate`, on
    ``delta_x``'s device: ``jax.random.poisson(key, rate)`` for a key
    (fastbox_tpu/models/halos.py:28-52; R2w on the card, the rejection
    loop over the whole field), ``torch.poisson`` for a generator."""
    rate = halo_rate(delta_x, grid, nbar, bias, lognormal)
    if keys.is_key(generator):
        return keys.poisson(generator, rate).to(torch.int64)
    return torch.poisson(rate, generator=generator).to(torch.int64)


def halo_catalogue_host(Nhalo, grid, rng=None, scatter: bool = False):
    """Exact reference catalogue semantics, on the host (halos.py:120-176).

    Voxel indices are repeated by their counts, optionally uniformly
    scattered within the voxel, then scaled to comoving Mpc.
    """
    if isinstance(Nhalo, torch.Tensor):
        Nhalo = Nhalo.cpu().numpy()
    Nhalo = np.asarray(Nhalo)
    idx = np.nonzero(Nhalo > 0)
    counts = Nhalo[idx]
    cat = np.column_stack([np.repeat(i, counts) for i in idx]).astype(
        np.float64)
    if scatter:
        rng = rng or np.random.default_rng()
        cat += rng.uniform(0.0, 1.0 - 1e-8, cat.shape)
    cat[:, 0] *= grid.Lx / grid.N
    cat[:, 1] *= grid.Ly / grid.N
    cat[:, 2] *= grid.Lz / grid.N
    return cat


def realise_halo_catalogue_padded(generator, Nhalo, grid, max_halos: int,
                                  scatter: bool = False, uniforms=None):
    """Fixed-shape device catalogue: positions (max_halos, 3) (float32, or
    the uniforms' dtype with ``scatter``) and a validity mask, on
    ``Nhalo``'s device.

    Each voxel keeps at most ``max_count = 8`` halos, placed in the slots
    of the running count; halos beyond ``max_halos`` are dropped, and
    ``n_valid`` still counts them (check it against ``max_halos``).  With
    ``scatter`` the positions move uniformly within their voxel, by
    ``uniforms`` (max_halos, 3) when given, else by
    ``jax.random.uniform(key, (max_halos, 3), maxval=1 - 1e-8)`` in
    float64 (jax's default float in 64-bit mode;
    fastbox_tpu/models/halos.py:117) for a key, or by draws from a
    ``torch.Generator``.

    Returns:
        (positions, mask, n_valid).
    """
    N = grid.N
    flat = torch.as_tensor(Nhalo).reshape(-1).long()
    dev = flat.device
    starts = torch.cumsum(flat, 0) - flat
    n_valid = starts[-1] + flat[-1]
    max_count = 8  # bound on halos per voxel; the excess is dropped
    vox = torch.arange(flat.numel(), device=dev)
    coords = torch.stack([vox // (N * N), (vox // N) % N, vox % N],
                         dim=-1).to(torch.float32)
    pos = torch.zeros((max_halos, 3), dtype=torch.float32, device=dev)
    mask = torch.zeros(max_halos, dtype=torch.bool, device=dev)
    for j in range(max_count):
        keep = (flat > j) & (starts + j < max_halos)
        slot = (starts + j)[keep]
        pos[slot] = coords[keep]
        mask[slot] = True
    if scatter:
        if uniforms is None and keys.is_key(generator):
            uniforms = keys.uniform(generator, (max_halos, 3), torch.float64,
                                    0.0, 1.0 - 1e-8, device=dev)
        elif uniforms is None:
            uniforms = torch.rand((max_halos, 3), generator=generator,
                                  device=dev) * (1.0 - 1e-8)
        # the positions take the uniforms' dtype, as fastbox_tpu's take
        # jax.random.uniform's
        pos = pos + torch.as_tensor(uniforms, device=dev)
    scale = torch.tensor([grid.Lx / N, grid.Ly / N, grid.Lz / N],
                         dtype=torch.float32, device=dev)
    pos = torch.where(mask[:, None], pos * scale[None, :], 0.0)
    return pos, mask, n_valid


class HaloDistribution:
    """Reference-API shim (halos.py:9-176) over a ``CosmoBox``."""

    def __init__(self, box, mass_range, mass_bins):
        self.box = box
        self.Mmin, self.Mmax = mass_range
        self.mass_bins = mass_bins
        self.dndlog10M = None
        self.bias = None

    def construct_bins(self, z):
        """Binned halo mass function and bias (halos.py:31-50).

        The reference's version is dead code (an undefined ``cosmo`` and a
        legacy CCL API); as fastbox_tpu does, this uses the native
        Sheth-Tormen functions (``cosmology/massfunction.py``) on the box's
        cosmology at ``z``.  Sets ``self.dndlog10M`` and ``self.bias`` at
        the mass-bin centres.
        """
        edges = np.logspace(np.log10(self.Mmin), np.log10(self.Mmax),
                            int(self.mass_bins) + 1)
        centres = 0.5 * (edges[1:] + edges[:-1])
        cosmology = self.box.cosmology_at(z)
        self.dndlog10M = mf.dndlog10m(cosmology, centres, z)
        self.bias = mf.halo_bias(cosmology, centres, z)
        return centres, self.dndlog10M, self.bias

    def halo_count_field(self, delta_x, nbar, bias, lognormal=False):
        delta_x = torch.as_tensor(delta_x, device=self.box.device)
        return halo_count_field(self.box.next_key(), delta_x,
                                self.box.grid, nbar, bias, lognormal)

    def realise_halo_catalogue(self, Nhalo, scatter=False,
                               scatter_type="uniform"):
        if scatter_type != "uniform":
            raise ValueError(f"scatter_type='{scatter_type}' not recognised")
        # fastbox_tpu/models/halos.py:163
        seed = int(keys.randint(self.box.next_key(), (), 0, 2**31 - 1))
        return halo_catalogue_host(Nhalo, self.box.grid,
                                   rng=np.random.default_rng(seed),
                                   scatter=scatter)
