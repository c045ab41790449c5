"""Gaussian random field draws.

Torch counterpart of ``fastbox_tpu/fields/gaussian.py``: the half-spectrum
draw of the pipeline (``_complex_normal`` with both bits-to-normal methods,
``hermitian_half_noise``, ``_herm_plane``, ``:40-102``), the fused colored
draws on K9 (``colored_half_noise``, ``colored_half_noise_vz``, ``:105-180``)
the full-cube realisation the COLA engine starts from (``white_noise``,
``hermitian_symmetrize``, ``gaussian_field_from_whitenoise``,
``realise_density``, ``:183-242``), and the linear velocity and potential
fields of a density spectrum (``realise_velocity``, ``realise_potential``,
``:246-299``).
The threefry draws (all but the colored draws, which stand for the TPU's
hardware stream) take a key or a ``torch.Generator`` in the argument where
fastbox_tpu takes its key.  A key (an int seed, ``jax.random.PRNGKey(seed)``,
or key words; ``keys``) draws fastbox_tpu's own fields: the same splits and
whole-array ``jax.random`` draws (R1w on the card, its twin on the CPU), on
``device`` (None: the card).  A generator draws torch's streams on its own
device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import keys
from ..grid import GridSpec
from ..ops.cuda import half_draw

__all__ = ["complex_dtype", "bm_from_uniforms", "hermitian_half_noise",
           "colored_half_noise", "colored_half_noise_vz", "white_noise",
           "hermitian_symmetrize", "gaussian_field_from_whitenoise",
           "realise_density", "realise_velocity", "realise_potential"]


def complex_dtype(real_dtype: torch.dtype) -> torch.dtype:
    return torch.complex128 if real_dtype == torch.float64 else torch.complex64


def bm_from_uniforms(u1, u2):
    """One Box-Muller transform: two independent N(0, 1) fields from
    uniforms u1 in [tiny, 1) and u2 in [0, 1), as (r cos th, r sin th) with
    r = sqrt(-2 log u1) and th = 2 pi u2 — the transform of
    ``fastbox_tpu/parallel/rng.py::bm_pair``, whose output order and
    endpoint convention define the stream."""
    r = torch.sqrt(-2.0 * torch.log(u1))
    th = (2.0 * math.pi) * u2
    return r * torch.cos(th), r * torch.sin(th)


def _complex_normal(generator, shape, dtype: torch.dtype,
                    method: str = "erfinv", device=None):
    """``re + i im`` with independent unit-normal parts.

    With a key, fastbox_tpu's draw (fastbox_tpu/fields/gaussian.py:40-63):
    ``k1, k2 = split(key)``, then two ``jax.random.normal`` draws
    ('erfinv') or ``bm_pair(k1, k2)``'s (cos, sin) ('box_muller'), one
    launch on ``device``.  With a generator, 'erfinv' is two plain normal
    draws, and ``'box_muller'`` draws u1 (floored at the dtype's tiny, as
    ``jax.random.uniform(minval=tiny)``) and then u2, and emits both
    outputs of :func:`bm_from_uniforms` as (re, im).
    """
    if keys.is_key(generator):
        return keys.complex_normal(generator, shape, dtype, method, device)
    device = generator.device
    kw = dict(generator=generator, dtype=dtype, device=device)
    if method == "box_muller":
        tiny = torch.finfo(dtype).tiny
        u1 = torch.rand(shape, **kw).mul_(1.0 - tiny).add_(tiny) \
            .clamp_(min=tiny)
        u2 = torch.rand(shape, **kw)
        return torch.complex(*bm_from_uniforms(u1, u2))
    if method != "erfinv":
        raise ValueError(f"Unknown draw method '{method}'")
    re = torch.randn(shape, **kw)
    im = torch.randn(shape, **kw)
    return torch.complex(re, im)


def hermitian_half_noise(generator, grid: GridSpec,
                         dtype: torch.dtype = torch.float32,
                         method: str = "erfinv", device=None):
    """Complex white noise drawn directly on the rfft half-spectrum, with
    the statistics of a Hermitian-symmetrised full draw.

    Interior kz modes (0 < l < N/2) get independent CN parts of variance
    1/2; the kz=0 and (even N) kz=N/2 planes are realised as 2D Hermitian
    projections of unit-variance plane noise.  A key is split into three
    (interior, kz=0, Nyquist; fastbox_tpu/fields/gaussian.py:82) and draws
    on ``device``; a generator draws on its device.
    """
    if keys.is_key(generator):
        parts = keys.split(generator, 3)
    else:
        parts = (generator,) * 3
    return _half_noise(parts, grid, dtype, method, device)


def _half_noise(parts, grid: GridSpec, dtype: torch.dtype, method: str,
                device):
    """:func:`hermitian_half_noise` from its three keys (interior, kz=0,
    Nyquist) already split, a (3, 2) tensor, or one generator three
    times.  A key's planes are drawn as one batch of their keys."""
    N = grid.N
    H = N // 2 + 1
    planes = [0, H - 1] if N % 2 == 0 else [0]
    half = _complex_normal(parts[0], (N, N, H), dtype, method, device) \
        * float(np.sqrt(0.5))
    if torch.is_tensor(parts):
        w = hermitian_symmetrize(_complex_normal(
            parts[1:1 + len(planes)], (N, N), dtype, method, device), (1, 2))
    else:
        w = [_herm_plane(gen, N, dtype, method, device)
             for gen in parts[1:1 + len(planes)]]
    # plain slice copies: a list index would copy it to the device first
    for kz, plane in zip(planes, w):
        half[:, :, kz] = plane
    return half


def _herm_plane(generator, N: int, dtype: torch.dtype,
                method: str = "erfinv", device=None):
    """(N, N) complex plane with internal 2D Hermitian pairing — the kz=0
    / kz=N/2 structure of a real cube's half-spectrum."""
    w = _complex_normal(generator, (N, N), dtype, method, device)
    return hermitian_symmetrize(w)


def _fix_planes(half, generator: torch.Generator, amp_half, N: int, dtype):
    """Overwrite the kz=0 and (even N) Nyquist planes of a colored draw with
    Hermitian planes x amp (fastbox_tpu/fields/gaussian.py:141-145): a
    row-local kernel cannot pair those planes' modes."""
    H = N // 2 + 1
    half[:, :, 0] = _herm_plane(generator, N, dtype) * amp_half[:, :, 0]
    if N % 2 == 0:
        half[:, :, H - 1] = _herm_plane(generator, N, dtype) \
            * amp_half[:, :, H - 1]
    return half


def colored_half_noise(generator: torch.Generator, grid: GridSpec, amp_half,
                       dtype: torch.dtype = torch.float32):
    """``hermitian_half_noise(...) * amp_half`` in one pass: K9a on a CUDA
    ``amp_half``, its plain twin on a CPU one, then the Hermitian planes.

    On the card the interior normals come from the kernel's Philox stream
    (seeded from ``generator``), a different stream than ``torch.randn``;
    on the CPU the twin consumes ``generator`` exactly as
    ``hermitian_half_noise`` does, so the result equals its
    ``hermitian_half_noise(generator, grid) * amp_half``.
    """
    N = grid.N
    H = N // 2 + 1
    half = half_draw.colored_half_draw(amp_half.reshape(N, N * H),
                                       generator=generator)
    return _fix_planes(half.reshape(N, N, H), generator, amp_half, N, dtype)


def colored_half_noise_vz(generator: torch.Generator, grid: GridSpec,
                          amp_half, kx2col, kyz2row, kznumrow,
                          dtype: torch.dtype = torch.float32):
    """:func:`colored_half_noise` plus the LOS-velocity half spectrum
    ``vz_k = delta_k * i * kznum / (kx2 + kyz2)`` from the same pass (K9b).
    The kz=0 and Nyquist planes carry zero velocity weight, so only delta
    needs the Hermitian fix-up.  Returns (delta_k, vz_k)."""
    N = grid.N
    H = N // 2 + 1
    half, vz = half_draw.colored_half_draw_vz(
        amp_half.reshape(N, N * H), kx2col, kyz2row, kznumrow,
        generator=generator)
    half = _fix_planes(half.reshape(N, N, H), generator, amp_half, N, dtype)
    return half, vz.reshape(N, N, H)


def white_noise(generator, grid: GridSpec,
                dtype: torch.dtype = torch.float32, device=None):
    """Complex unit white noise (re + i im) on the full (N, N, N) cube, each
    part ~ N(0, 1) (box.py:174-176): a key's ``split`` and two
    ``jax.random.normal`` draws on ``device``
    (fastbox_tpu/fields/gaussian.py:198-210), or a generator's draws on its
    device."""
    return _complex_normal(generator, grid.shape, dtype, device=device)


def hermitian_symmetrize(A, dims=None):
    """Project a Fourier array onto Hermitian symmetry over ``dims`` (all
    axes by default; the others index a batch): (A + conj(A_-k))/2.

    fftn(Re(ifftn(A))) == hermitian_symmetrize(A), so the realisation saves
    the reference's second FFT (box.py:187-193)."""
    dims = tuple(range(A.dim())) if dims is None else tuple(dims)
    rev = torch.roll(torch.flip(A, dims), (1,) * len(dims), dims)
    return 0.5 * (A + torch.conj(rev))


def gaussian_field_from_whitenoise(white, grid: GridSpec, pk_fn):
    """Colour complex white noise by a power spectrum.

    Parameters:
        white: complex (N, N, N) unit white noise.
        grid: geometry.
        pk_fn: callable k -> P(k) in Mpc^3 (a ``PowerSpectrumTable``).

    Returns:
        (delta_x, delta_k): the real-space field and its Hermitian FFT, in
        ``white``'s precision and on its device.
    """
    rdtype = white.real.dtype
    kmag = grid.kmag(rdtype, white.device)
    # in the table's precision, as fastbox_tpu does, then cast
    pk = torch.nan_to_num(pk_fn(kmag) * grid.boxfactor)
    amp = torch.sqrt(pk).to(device=white.device, dtype=rdtype)
    del kmag, pk
    delta_k = hermitian_symmetrize(white * amp).to(complex_dtype(rdtype))
    delta_x = torch.fft.ifftn(delta_k).real.to(rdtype).contiguous()
    return delta_x, delta_k


def realise_density(generator, grid: GridSpec, cosmology,
                    linear: bool = False, dtype: torch.dtype = torch.float32,
                    device=None):
    """Draw a Gaussian density field with the cosmology's P(k)
    (box.py:130-194) from a key (on ``device``) or a generator; returns
    (delta_x, delta_k)."""
    pk_fn = cosmology.pk_lin if linear else cosmology.pk_nl
    return gaussian_field_from_whitenoise(
        white_noise(generator, grid, dtype, device), grid, pk_fn)


def _inv_k2(grid: GridSpec, rdtype, device):
    """1/k^2 on the full grid, 0 at k = 0."""
    k2 = grid.k2(rdtype, device)
    pos = k2 > 0.0
    return torch.where(pos, 1.0 / torch.where(pos, k2, 1.0), 0.0)


def realise_velocity(delta_k, grid: GridSpec, cosmology):
    """Linear velocity field v(k) = i [f H a] delta_k k / k^2 (box.py:197-290).

    Returns a (3, N, N, N) complex tensor of the x, y, z Fourier-space
    velocity components on ``delta_k``'s device; ``ifftn`` of a component
    gives the real-space velocity in km/s.  For even N the
    most-negative-frequency plane of each component is zeroed
    (box.py:268-274).
    """
    cdtype, rdtype, dev = delta_k.dtype, delta_k.real.dtype, delta_k.device
    kx, ky, kz = grid.kvec(rdtype, dev)
    nyq = grid.nyquist_mask(0, dev)   # the same 1-D pattern on each axis
    # the prefactor 100 h E(a) f(a) a in km/s/Mpc (box.py:280-281), as a
    # complex scalar of the field's dtype
    fac = 100.0 * cosmology.h * cosmology.Ea * cosmology.growth_rate \
        * cosmology.scale_factor
    ifac = torch.tensor(1j * fac, dtype=cdtype, device=dev)
    base = ifac * delta_k * _inv_k2(grid, rdtype, dev)
    zero = torch.zeros((), dtype=cdtype, device=dev)
    vx = torch.where(nyq[:, None, None], zero, base * kx[:, None, None])
    vy = torch.where(nyq[None, :, None], zero, base * ky[None, :, None])
    vz = torch.where(nyq[None, None, :], zero, base * kz[None, None, :])
    return torch.stack([vx, vy, vz])


def realise_potential(delta_k, grid: GridSpec, cosmology,
                      apply_prefactor: bool = False):
    """Potential field phi_k = delta_k / k^2, monopole zeroed
    (box.py:293-353).

    The reference computes the physical prefactor
    ``(3/2) Omega_m H0^2 D(a)/a`` but never applies it (box.py:343-347); the
    default matches the reference's output, and ``apply_prefactor=True``
    gives the intended physics.
    """
    phi_k = delta_k * _inv_k2(grid, delta_k.real.dtype, delta_k.device)
    if apply_prefactor:
        params = cosmology.params
        phi_k = phi_k * (1.5 * params.Omega_m * (100.0 * params.h) ** 2
                         * cosmology.growth / cosmology.scale_factor)
    return phi_k
