"""Catalogue -> mesh painting with mass-assignment window compensation.

Torch counterpart of ``fastbox_tpu/ops/painting.py`` (the nbodykit
``to_mesh(window=..., compensated=True)`` analog): NGP/CIC/TSC painting
as ``index_add_`` over each particle's neighbour cells with periodic
wrapping, and the compensation 1/W(k), W = prod_i sinc(k_i dx_i / 2)^p,
p = 1, 2, 3.  The COLA engine deconvolves its final CIC field with
``compensation``.
"""
from __future__ import annotations

import torch

from ..grid import GridSpec

__all__ = ["paint_catalogue", "compensation", "overdensity_from_catalogue"]

_ORDER = {"ngp": 1, "cic": 2, "tsc": 3}


def _kernel_1d(dist, window: str):
    """Mass-assignment weight for a grid point at (signed) distance ``dist``
    (in cell units) from the particle."""
    ad = torch.abs(dist)
    one, zero = torch.ones_like(ad), torch.zeros_like(ad)
    if window == "ngp":
        return torch.where(ad <= 0.5, one, zero)
    if window == "cic":
        return torch.clamp(1.0 - ad, min=0.0)
    if window == "tsc":
        return torch.where(ad < 0.5, 0.75 - ad**2,
                           torch.where(ad < 1.5, 0.5 * (1.5 - ad) ** 2, zero))
    raise ValueError(f"Unknown window '{window}'")


def _cells(grid: GridSpec, dtype, device):
    return torch.tensor([grid.Lx / grid.N, grid.Ly / grid.N,
                         grid.Lz / grid.N], dtype=dtype, device=device)


def paint_catalogue(positions, grid: GridSpec, weights=None,
                    window: str = "cic"):
    """Scatter particles onto the grid with an NGP/CIC/TSC window.

    Parameters:
        positions: (Np, 3) comoving positions in [0, L) per axis.
        grid: geometry.
        weights: optional (Np,) weights (0 entries contribute nothing).
        window: 'ngp', 'cic' or 'tsc'.

    Returns:
        (N, N, N) mesh of summed weights (counts if weights is None).
    """
    window = window.lower()
    p = _ORDER[window]
    N = grid.N
    pos = torch.as_tensor(positions)
    w = (torch.ones(pos.shape[0], dtype=pos.dtype, device=pos.device)
         if weights is None else torch.as_tensor(weights, device=pos.device))
    u = pos / _cells(grid, pos.dtype, pos.device)[None, :]
    # Reference cell per axis: the centre cell for odd-support windows
    # (NGP, TSC), the lower cell for even support (CIC).
    if p % 2 == 1:
        base = torch.floor(u + 0.5).long() - (p - 1) // 2
    else:
        base = torch.floor(u).long() - (p // 2 - 1)
    mesh = torch.zeros(N**3, dtype=w.dtype, device=pos.device)
    for ox in range(p):
        wx = _kernel_1d(base[:, 0] + ox - u[:, 0], window)
        ix = torch.remainder(base[:, 0] + ox, N)
        for oy in range(p):
            wy = _kernel_1d(base[:, 1] + oy - u[:, 1], window)
            iy = torch.remainder(base[:, 1] + oy, N)
            for oz in range(p):
                wz = _kernel_1d(base[:, 2] + oz - u[:, 2], window)
                iz = torch.remainder(base[:, 2] + oz, N)
                mesh.index_add_(0, (ix * N + iy) * N + iz, w * wx * wy * wz)
    return mesh.reshape(N, N, N)


def _window_1d(grid: GridSpec, window: str, dtype, device):
    """The per-axis window factors sinc(k_i dx_i / 2)^p."""
    p = _ORDER[window.lower()]

    def sinc(x):
        safe = torch.where(x != 0.0, x, torch.ones_like(x))
        return torch.where(x != 0.0, torch.sin(safe) / safe,
                           torch.ones_like(x))

    kx, ky, kz = grid.kvec(dtype, device)
    return tuple(sinc(k * (L / grid.N) / 2.0) ** p
                 for k, L in ((kx, grid.Lx), (ky, grid.Ly), (kz, grid.Lz)))


def compensation(grid: GridSpec, window: str = "cic", dtype=torch.float32,
                 device="cpu", half: bool = False):
    """Fourier-space deconvolution factor 1 / W(k) for the painting window.

    W(k) = prod_i sinc(k_i dx_i / 2)^p (nbodykit's ``compensated=True``).
    ``half=True`` gives the rfft half-spectrum (N, N, N//2+1) only, built
    from the 1-D factors without the full cube.
    """
    wx, wy, wz = _window_1d(grid, window, dtype, device)
    if half:
        wz = wz[: grid.N // 2 + 1]
    W = wx[:, None, None] * wy[None, :, None] * wz[None, None, :]
    return 1.0 / W


def overdensity_from_catalogue(positions, grid: GridSpec, weights=None,
                               window: str = "cic", compensated: bool = True,
                               interlaced: bool = False):
    """Catalogue -> overdensity mesh delta = n/<n> - 1, optionally
    window-compensated in Fourier space; ``interlaced`` paints a second
    mesh shifted by half a cell and combines the two with the conjugate
    phase (Hockney & Eastwood interlacing)."""
    pos = torch.as_tensor(positions)
    mesh = paint_catalogue(pos, grid, weights=weights, window=window)
    if interlaced:
        cell = _cells(grid, pos.dtype, pos.device)
        L = torch.tensor([grid.Lx, grid.Ly, grid.Lz], dtype=pos.dtype,
                         device=pos.device)
        shifted = torch.remainder(pos + 0.5 * cell[None, :], L[None, :])
        mesh2 = paint_catalogue(shifted, grid, weights=weights, window=window)
        kx, ky, kz = grid.kvec(mesh.dtype, pos.device)
        # exp(+i k . (cell/2)): un-shift the second mesh's half-cell offset
        phase = torch.exp(1j * (kx[:, None, None] * (grid.Lx / grid.N / 2.0)
                                + ky[None, :, None] * (grid.Ly / grid.N / 2.0)
                                + kz[None, None, :] * (grid.Lz / grid.N / 2.0)))
        ck = 0.5 * (torch.fft.fftn(mesh) + torch.fft.fftn(mesh2) * phase)
        mesh = torch.fft.ifftn(ck).real.to(mesh.dtype)
    delta = mesh / torch.mean(mesh) - 1.0
    if compensated:
        dk = torch.fft.fftn(delta) * compensation(grid, window, mesh.dtype,
                                                  pos.device)
        delta = torch.fft.ifftn(dk).real.to(mesh.dtype)
    return delta.contiguous()
