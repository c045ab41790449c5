"""Lagrangian perturbation theory displacement fields (1LPT + 2LPT).

Torch counterpart of ``fastbox_tpu/fields/lpt.py``, the set-up of the COLA
engine (fields/cola.py).  The displacement potentials solve

    lap(phi1) = -delta          psi1 = grad(phi1)  (Zel'dovich)
    lap(phi2) = -S2,  S2 = sum_{i<j} [phi1_ii phi1_jj - phi1_ij^2]
    psi2 = grad(phi2)

so positions are x = q + D1 psi1 + D2 psi2 with D2(a) ~ -3/7 D1^2
Omega_m(a)^(-1/143) (Bouchet et al. 1995).  Everything runs on the rfft
half spectrum; cuFFT may return permuted strides, so every inverse
transform is made contiguous.
"""
from __future__ import annotations

import torch

from ..grid import GridSpec
from ..ops import fft_safe

__all__ = ["lpt_displacements", "second_order_growth"]


def lpt_displacements(delta_k, grid: GridSpec):
    """1LPT and 2LPT displacement fields from a linear density field.

    Parameters:
        delta_k: Fourier-space linear overdensity, the full (N, N, N)
            Hermitian spectrum or its (N, N, N//2+1) rfft half.

    Returns:
        (psi1, psi2): two (3, N, N, N) real displacement fields (Mpc) on
        the Lagrangian grid.
    """
    rdtype = delta_k.real.dtype
    dev = delta_k.device
    N = grid.N
    H = N // 2 + 1
    kx, ky, kz = grid.kvec(rdtype, dev)
    kzh = kz[:H]
    nyq = grid.nyquist_mask(0, dev)
    nyq_h = nyq[:H]
    k2h = (kx[:, None, None] ** 2 + ky[None, :, None] ** 2
           + kzh[None, None, :] ** 2)
    inv_k2 = torch.where(k2h > 0.0,
                         1.0 / torch.where(k2h > 0.0, k2h,
                                           torch.ones_like(k2h)),
                         torch.zeros_like(k2h))
    del k2h
    delta_h = delta_k if delta_k.shape[-1] == H else delta_k[:, :, :H]

    def irfft(a):
        return fft_safe.irfftn(a, grid.shape).contiguous()

    def grad_half(phi_h):
        # irfftn(i k_i phi_h) per axis; the Nyquist plane of the derivative
        # axis is zeroed for even N: the ik multiply cannot represent a
        # real derivative there (box.py:268-274 convention).
        out = torch.empty((3,) + grid.shape, dtype=rdtype, device=dev)
        for i, (kv, m) in enumerate(((kx[:, None, None], nyq[:, None, None]),
                                     (ky[None, :, None], nyq[None, :, None]),
                                     (kzh[None, None, :],
                                      nyq_h[None, None, :]))):
            g = 1j * kv * phi_h
            out[i] = irfft(torch.where(m, torch.zeros_like(g), g))
        return out

    phi1_h = delta_h * inv_k2  # lap phi1 = -delta  =>  phi1_k = delta_k / k^2
    psi1 = grad_half(phi1_h)

    # Second derivatives phi1_ij = irfftn(-k_i k_j phi1_h), consumed
    # pairwise into S2 so at most three tidal cubes are live at once.
    kxc = kx[:, None, None]
    kyc = ky[None, :, None]
    kzc = kzh[None, None, :]

    def dd(a, b):
        return irfft(-(a * b) * phi1_h)

    dxx = dd(kxc, kxc)
    dyy = dd(kyc, kyc)
    dzz = dd(kzc, kzc)
    S2 = dxx * dyy + dxx * dzz + dyy * dzz
    del dxx, dyy, dzz
    S2 = S2 - dd(kxc, kyc) ** 2
    S2 = S2 - dd(kxc, kzc) ** 2
    S2 = S2 - dd(kyc, kzc) ** 2
    phi2_h = fft_safe.rfftn(S2) * inv_k2
    del S2
    psi2 = grad_half(phi2_h)
    return psi1, psi2


def second_order_growth(D1, omega_m_a):
    """D2(a) ~ -3/7 D1^2 Omega_m(a)^(-1/143) (Bouchet et al. 1995)."""
    return -3.0 / 7.0 * D1**2 * omega_m_a ** (-1.0 / 143.0)
