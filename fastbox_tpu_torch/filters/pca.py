"""PCA foreground filter (counterpart of fastbox_tpu/filters/pca.py:31-76).

Reshape to (Nfreq, Npix), subtract the mean spectrum, build the
frequency-frequency covariance (``np.cov``, ddof=1), eigendecompose, and
subtract the projection onto the top ``nmodes`` eigenvectors plus the
mean.  The covariance and projection are ``torch.matmul`` GEMMs; on a GPU
they run in full FP32 as long as the caller leaves TF32 off (PyTorch's
default, ``torch.get_float32_matmul_precision() == 'highest'``).  The
cleaned field is invariant to the eigenvector sign.
"""
from __future__ import annotations

import torch

__all__ = ["pca_filter"]


def pca_filter(field: torch.Tensor, nmodes: int, return_filter: bool = False):
    """Subtract the top-``nmodes`` frequency eigenmodes (filters.py:93-183).

    Parameters:
        field: (Nx, Ny, Nfreq) datacube; last axis is frequency.
        nmodes: number of eigenmodes (by descending eigenvalue) to remove.
        return_filter: also return (U_fg (Nfreq, nmodes), fg_amps
            (nmodes, Npix)) like the reference.
    """
    shape = field.shape
    d = field.reshape(-1, shape[-1]).T  # (Nfreq, Npix)
    npix = d.shape[1]
    d_mean = torch.mean(d, dim=-1, keepdim=True)
    x = d - d_mean
    cov = torch.matmul(x, x.T) / (npix - 1)
    _, eigvecs = torch.linalg.eigh(cov)           # ascending
    U_fg = torch.flip(eigvecs, (1,))[:, :nmodes]  # descending eigenvalue
    fg_amps = torch.matmul(U_fg.T, x)
    # (U fg_amps + mean)^T, formed as fg_amps^T U^T so that it comes out
    # (Npix, Nfreq)-contiguous like the field
    fg_field = (torch.matmul(fg_amps.T, U_fg.T) + d_mean.T).reshape(shape)
    cleaned = field - fg_field
    if return_filter:
        return cleaned, U_fg, fg_amps
    return cleaned
