"""Static grid geometry for the simulation box.

Torch counterpart of ``fastbox_tpu/grid.py``: the host geometry (real-space
coordinates, FFT indices, frequency and pixel arrays) stays numpy; the
Fourier-space vectors come back as torch tensors on a given device.

Conventions matched to the reference:
  * ``x = linspace(-L/2, L/2, N)``; ``Lx = x[-1]-x[0]`` (box.py:76-89)
  * ``boxfactor = N^6/(Lx Ly Lz)`` (box.py:94)
  * integer FFT index grids; ``k = 2 pi sqrt((Kx/Lx)^2 + ...)`` (box.py:116-127)
  * ``kmin = 2 pi / max(L)``, ``kmax = 2 pi sqrt(3) N / min(L)`` (box.py:100-101)
"""
from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np
import torch

from . import timing
from .constants import C_KMS, LINE_FREQ_21CM

__all__ = ["GridSpec", "sqrt_rn"]


def sqrt_rn(t: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of a float tensor, on any device.

    On the CPU ``torch.sqrt``'s vectorised loops are within one ulp but not
    correctly rounded, and the vector/scalar split depends on the tensor's
    length, so two layouts of the same values could round differently.
    numpy's ``sqrt`` is the IEEE operation, as XLA's is; CUDA's
    ``torch.sqrt`` is too.  Binning |k| against edges that lattice modes
    sit on needs the same rounding everywhere.
    """
    if t.device.type == "cpu":
        return torch.from_numpy(np.sqrt(t.numpy()))
    return torch.sqrt(t)


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static description of an N^3 comoving box.

    Parameters:
        N: grid points per dimension (reference ``nsamp``).
        Lx, Ly, Lz: box side lengths in Mpc.
        redshift: redshift of the box centre.
        line_freq: emission-line rest frequency in MHz (box.py:26).
    """

    N: int
    Lx: float
    Ly: float
    Lz: float
    redshift: float = 0.0
    line_freq: float = LINE_FREQ_21CM

    @classmethod
    def create(cls, box_scale=1e3, nsamp=32, redshift=0.0,
               line_freq=LINE_FREQ_21CM):
        """Build from the reference's ``box_scale`` convention (box.py:76-89)."""
        if isinstance(box_scale, tuple):
            if len(box_scale) != 3:
                raise ValueError("Must specify scale of x, y, z dimensions")
            Lx, Ly, Lz = (float(s) for s in box_scale)
        else:
            Lx = Ly = Lz = float(box_scale)
        return cls(N=int(nsamp), Lx=Lx, Ly=Ly, Lz=Lz,
                   redshift=float(redshift), line_freq=float(line_freq))

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.N, self.N, self.N)

    @property
    def is_cubic(self) -> bool:
        return self.Lx == self.Ly == self.Lz

    @property
    def scale_factor(self) -> float:
        return 1.0 / (1.0 + self.redshift)

    @property
    def boxfactor(self) -> float:
        """DFT/volume normalisation N^6/(Lx Ly Lz) (box.py:94)."""
        return float(self.N) ** 6 / (self.Lx * self.Ly * self.Lz)

    @property
    def volume(self) -> float:
        return self.Lx * self.Ly * self.Lz

    @property
    def voxel_volume(self) -> float:
        return self.volume / self.N**3

    @property
    def kmin(self) -> float:
        return 2.0 * np.pi / max(self.Lx, self.Ly, self.Lz)

    @property
    def kmax(self) -> float:
        return 2.0 * np.pi * np.sqrt(3.0) * self.N / min(self.Lx, self.Ly,
                                                         self.Lz)

    # Real-space coordinates (host numpy; tiny 1-D arrays)
    @cached_property
    def x(self) -> np.ndarray:
        return np.linspace(-0.5 * self.Lx, 0.5 * self.Lx, self.N)

    @cached_property
    def y(self) -> np.ndarray:
        return np.linspace(-0.5 * self.Ly, 0.5 * self.Ly, self.N)

    @cached_property
    def z(self) -> np.ndarray:
        return np.linspace(-0.5 * self.Lz, 0.5 * self.Lz, self.N)

    # Fourier-space index vectors and broadcast k-grids
    @cached_property
    def fft_index(self) -> np.ndarray:
        """Integer FFT indices [0, 1, ..., N/2-1, -N/2, ..., -1] (box.py:119)."""
        return (self.N * np.fft.fftfreq(self.N, 1.0)).astype(np.int64)

    def kvec(self, dtype=torch.float32, device="cpu"):
        """Physical 1-D wavenumber vectors (2 pi n / L) for each axis,
        computed in float64 on the host and cast to ``dtype``."""
        n = self.fft_index.astype(np.float64)
        timing.count_copy("h2d_kvec", device, 3)
        return tuple(torch.as_tensor(2.0 * np.pi * n / L, dtype=dtype,
                                     device=device)
                     for L in (self.Lx, self.Ly, self.Lz))

    def kmag(self, dtype=torch.float32, device="cpu"):
        """|k| on the full grid: ``sqrt((kx^2 + ky^2) + kz^2)`` of the 1-D
        vectors, each operation correctly rounded in ``dtype``, as
        fastbox_tpu computes it."""
        return sqrt_rn(self.k2(dtype, device))

    def k2(self, dtype=torch.float32, device="cpu"):
        """|k|^2 on the full grid, ``(kx^2 + ky^2) + kz^2``."""
        kx, ky, kz = self.kvec(dtype, device)
        return kx[:, None, None] ** 2 + ky[None, :, None] ** 2 \
            + kz[None, None, :] ** 2

    def kperp_kpar(self, dtype=torch.float32, device="cpu"):
        """(k_perp, k_par) grids: the transverse magnitude (N, N, 1) and the
        signed LOS component 2 pi Kz / Lz broadcast to the full grid, as in
        apply_transfer_fn (box.py:374-375)."""
        kx, ky, kz = self.kvec(dtype, device)
        k_perp = sqrt_rn(kx[:, None, None] ** 2 + ky[None, :, None] ** 2)
        return k_perp, kz[None, None, :].expand(self.shape)

    def nyquist_mask(self, axis: int, device="cpu"):
        """Boolean 1-D mask selecting the most-negative frequency plane.

        For even N the reference zeroes the velocity component on the plane
        where the integer index equals -N/2 (box.py:268-274).  For odd N no
        plane is masked.  ``axis`` is accepted for parity with
        fastbox_tpu; the pattern is the same on every axis.
        """
        idx = self.fft_index
        if self.N % 2 == 0:
            timing.count_copy("h2d_nyquist", device)
            return torch.as_tensor(idx == idx.min(), device=device)
        return torch.zeros(self.N, dtype=torch.bool, device=device)

    # Observational coordinates (need background cosmology scalars)
    def freq_array(self, cosmology) -> np.ndarray:
        """Frequency channels (MHz) along the z axis, *descending* (box.py:789-828)."""
        a = cosmology.scale_factor
        freq_centre = a * self.line_freq
        dx = self.Lz / self.N
        Hz = 100.0 * cosmology.h * cosmology.Ea  # km/s/Mpc
        df = dx * self.line_freq * (a**2 * Hz) / C_KMS
        freqs = freq_centre + df * (np.arange(self.N) - 0.5 * (self.N - 1.0))
        return freqs[::-1]

    def pixel_array(self, cosmology) -> tuple[np.ndarray, np.ndarray]:
        """Angular pixel-centre coordinates in degrees (box.py:831-864)."""
        r = cosmology.chi
        x_px = self.x[1] - self.x[0]
        y_px = self.y[1] - self.y[0]
        ang_x = (180.0 / np.pi) * (x_px / r)
        ang_y = (180.0 / np.pi) * (y_px / r)
        grid = np.arange(self.N) - 0.5 * (self.N - 1.0)
        return ang_x * grid, ang_y * grid
