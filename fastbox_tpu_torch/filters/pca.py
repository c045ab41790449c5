"""PCA foreground filter (counterpart of fastbox_tpu/filters/pca.py).

Reshape to (Nfreq, Npix), subtract the mean spectrum, build the
frequency-frequency covariance (``np.cov``, ddof=1), find its top
``nmodes`` eigenvectors, and subtract the projection onto them plus the
mean.  ``pca_filter`` takes the exact ``torch.linalg.eigh``;
``pca_filter_subspace`` the oversampled subspace iteration with a
Rayleigh-Ritz step (``topk_eigvecs_subspace``); ``pca_project`` applies the
clean for eigenvectors found elsewhere (the chained pipeline's batched
eigh).  The covariance and projection are ``torch.matmul`` GEMMs in the
working dtype below.  The cleaned field is invariant to the eigenvector
sign.

For a float32 field the clean runs in float64 on every device (``_work``):
the mean spectrum, the centring, the covariance GEMM, the eigh (as for
every dtype, ``top_eigvecs``) and the two projection GEMMs; only the
cleaned cube is rounded to float32.  This departs on purpose from
``fastbox_tpu``, whose GEMMs run in f32 at HIGHEST precision.  Under a
foreground monopole ~1e4 times the signal, an f32 mean spectrum is off by
up to ~1 ulp of 1e4 per channel, and the cleaned cube keeps that offset
on every pixel of its channel: a coherent error that the FFT sums into the
k_perp = 0 modes of the first retained P(k) bin.  On an H100 80GB HBM3
at 700 W it biased that bin by +6.1e-3 on average over 8 keys at 256^3,
with a worst of 3.8x the CPU f32 floor's; moving only the covariance, or
the covariance and the projection, to f64 left it in place, and the whole
clean in f64 brought the card to the floor (PERF.md §6, ROADMAP C2).
Float64 fields are unchanged.
"""
from __future__ import annotations

import torch

__all__ = ["pca_filter", "pca_filter_subspace", "pca_project",
           "mean_spectrum_filter", "topk_eigvecs_subspace", "top_eigvecs",
           "covariance"]


def _work(field: torch.Tensor) -> torch.Tensor:
    """The field in the dtype the clean computes in: float64 for float32."""
    return field.double() if field.dtype == torch.float32 else field


def mean_spectrum_filter(field: torch.Tensor) -> torch.Tensor:
    """Subtract the pixel-mean spectrum from each channel (filters.py:35-55);
    the mean of a float32 field is taken in float64 (``_work``)."""
    f = _work(field)
    d = f.reshape(-1, f.shape[-1])  # (Npix, Nfreq)
    return (d - torch.mean(d, dim=0, keepdim=True)).reshape(
        field.shape).to(field.dtype)


def _centre(field: torch.Tensor):
    """(mean spectrum (Nfreq, 1), mean-free data (Nfreq, Npix))."""
    d = field.reshape(-1, field.shape[-1]).T
    d_mean = torch.mean(d, dim=-1, keepdim=True)
    return d_mean, d - d_mean


def _cov(x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, x.T) / (x.shape[1] - 1)


def covariance(field: torch.Tensor) -> torch.Tensor:
    """The frequency-frequency covariance ``pca_filter`` decomposes, in the
    dtype the clean computes in (float64 for a float32 field)."""
    return _cov(_centre(_work(field))[1])


def top_eigvecs(cov: torch.Tensor, nmodes: int) -> torch.Tensor:
    """Eigenvectors of the ``nmodes`` largest eigenvalues, descending, in
    ``cov``'s dtype; a leading batch axis is decomposed in one batched
    ``eigh``.

    The decomposition runs in float64 whatever the input dtype.  For a
    float32 matrix of 32-512 rows, PyTorch's CUDA ``eigh`` takes cuSOLVER's
    Jacobi solver.  On an H100 that solver was both slower than the float64
    one (5.1 vs 2.3 ms at 256 x 256) and less accurate.  The clean
    amplifies eigenvector rounding wherever the last kept eigenvalue lies
    close to the next.
    """
    _, eigvecs = torch.linalg.eigh(cov.to(torch.float64))   # ascending
    return torch.flip(eigvecs, (-1,))[..., :nmodes].to(cov.dtype)


def _project_out(field, U, d_mean, x):
    fg_amps = torch.matmul(U.T, x)
    # (U fg_amps + mean)^T, formed as fg_amps^T U^T so that it comes out
    # (Npix, Nfreq)-contiguous like the field
    fg_field = (torch.matmul(fg_amps.T, U.T) + d_mean.T).reshape(field.shape)
    return field - fg_field, fg_amps


def pca_project(field: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """Subtract the projection onto the columns of ``U`` (Nfreq, nmodes)
    plus the mean spectrum: ``pca_filter``'s clean for given modes."""
    f = _work(field)
    d_mean, x = _centre(f)
    return _project_out(f, U.to(f.dtype), d_mean, x)[0].to(field.dtype)


def pca_filter(field: torch.Tensor, nmodes: int, return_filter: bool = False):
    """Subtract the top-``nmodes`` frequency eigenmodes (filters.py:93-183).

    Parameters:
        field: (Nx, Ny, Nfreq) datacube; last axis is frequency.
        nmodes: number of eigenmodes (by descending eigenvalue) to remove.
        return_filter: also return (U_fg (Nfreq, nmodes), fg_amps
            (nmodes, Npix)) like the reference.
    """
    f = _work(field)
    d_mean, x = _centre(f)
    U_fg = top_eigvecs(_cov(x), nmodes)
    cleaned, fg_amps = _project_out(f, U_fg, d_mean, x)
    cleaned = cleaned.to(field.dtype)
    if return_filter:
        return cleaned, U_fg.to(field.dtype), fg_amps.to(field.dtype)
    return cleaned


def topk_eigvecs_subspace(cov: torch.Tensor, nmodes: int, iters: int = 8,
                          oversample: int = 8) -> torch.Tensor:
    """Top-``nmodes`` eigenvectors of a symmetric PSD matrix by oversampled
    block power iteration (QR each step) and a Rayleigh-Ritz step
    (fastbox_tpu/filters/pca.py:79-111).

    The (nmodes + oversample)-column iteration converges at the oversampled
    gap's rate; the (p, p) ``eigh`` of the projected matrix then returns
    eigenvectors of that problem, which match ``eigh(cov)``'s top block to
    the convergence error.
    """
    C = cov.shape[-1]
    p = min(nmodes + oversample, C)
    Q, _ = torch.linalg.qr(cov[:, :p])
    for _ in range(iters):
        Q, _ = torch.linalg.qr(torch.matmul(cov, Q))
    B = torch.matmul(Q.T, torch.matmul(cov, Q))
    return torch.matmul(Q, top_eigvecs(B, nmodes))


def pca_filter_subspace(field: torch.Tensor, nmodes: int, iters: int = 8,
                        oversample: int = 8) -> torch.Tensor:
    """PCA clean with :func:`topk_eigvecs_subspace` in place of the full
    eigh (fastbox_tpu/filters/pca.py:114-141).  The cleaned field depends
    only on the span of the top eigenvectors; where the last kept mode is
    degenerate with the next, that span is ill-conditioned for any method,
    so use ``pca_filter`` where parity with the reference matters."""
    f = _work(field)
    d_mean, x = _centre(f)
    U = topk_eigvecs_subspace(_cov(x), nmodes, iters, oversample)
    return _project_out(f, U, d_mean, x)[0].to(field.dtype)
