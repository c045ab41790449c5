"""Kernel-PCA foreground filters (counterpart of fastbox_tpu/filters/kpca.py).

The reference ships two KPCA cleaners (filters.py:246-370), both wrapping
sklearn's KernelPCA with ``fit_inverse_transform=True``:

* ``kernel_pca_filter_legacy`` (filters.py:309-370): fit the top ``nmodes``
  kernel eigenmodes, inverse-transform them back to the data space (kernel
  ridge regression) and subtract that reconstruction from the data.
* ``kernel_pca_filter`` (filters.py:246-306): the kernel of the projections
  onto the smallest-eigenvalue retained mode, with the ridge added to its
  diagonal, applied to the dual coefficients of the full fit; that
  reconstruction is the returned field (no subtraction).

Both are an (Npix x Npix) kernel ``eigh`` and a ridge solve on the data's
device.  The kernel matrix is quadratic in the pixel count: a 256^2-pixel
map would need a 34 GB float64 kernel, so these filters are meant for
modest maps.  The ridge solve marks a singular system with NaNs, as
``jnp.linalg.solve`` does, where ``torch.linalg.solve`` would raise.  A
float32 cube is cleaned in float64, as ``pca_filter`` does.
"""
from __future__ import annotations

import torch

from .pca import _work

__all__ = ["kernel_pca_filter", "kernel_pca_filter_legacy"]


def _kernel(X, Y, kind: str, gamma):
    if kind == "linear":
        return X @ Y.T
    if kind == "rbf":
        d2 = (torch.sum(X**2, 1)[:, None] + torch.sum(Y**2, 1)[None, :]
              - 2.0 * X @ Y.T)
        return torch.exp(-gamma * torch.clamp(d2, min=0.0))
    if kind == "poly3":
        return (gamma * X @ Y.T + 1.0) ** 3
    raise ValueError(f"Unknown kernel '{kind}'")


def _solve(A, B):
    """A^-1 B, NaN where A is singular."""
    X, info = torch.linalg.solve_ex(A, B)
    return torch.where(info == 0, X, torch.nan)


def _kpca_fit(X, nmodes: int, kernel: str, gamma, alpha_ridge):
    """Fit KPCA on samples X (n, n_features).

    Returns ``(proj, dual)``: the training-point projections onto the top
    ``nmodes`` kernel eigenmodes (n, nmodes), and the inverse-transform
    dual coefficients (n, n_features) learned by kernel ridge regression
    as sklearn's ``fit_inverse_transform`` does.  The kernel is centred by
    its row, column and total means (fastbox_tpu forms the same centring
    with (n, n) GEMMs against ones/n).
    """
    n = X.shape[0]
    K = _kernel(X, X, kernel, gamma)
    Kc = (K - torch.mean(K, dim=0, keepdim=True)
          - torch.mean(K, dim=1, keepdim=True) + torch.mean(K))

    vals, vecs = torch.linalg.eigh(Kc)                  # ascending
    vals = torch.clamp(torch.flip(vals, (0,))[:nmodes], min=1e-12)
    vecs = torch.flip(vecs, (1,))[:, :nmodes]
    proj = vecs * torch.sqrt(vals)[None, :]             # (n, nmodes)

    Kp = _kernel(proj, proj, kernel, gamma)
    Kp = Kp + alpha_ridge * torch.eye(n, dtype=X.dtype, device=X.device)
    return proj, _solve(Kp, X)                          # dual (n, n_features)


def _prepare(field):
    """(shape, mean-free data (Nfreq, Npix), its samples (Npix, Nfreq)) in
    the clean's dtype."""
    shape = field.shape
    d = _work(field).reshape(-1, shape[-1]).T      # (Nfreq, Npix)
    x = d - torch.mean(d, dim=1, keepdim=True)
    return shape, x, x.T                           # samples = pixels


def kernel_pca_filter_legacy(field, nmodes: int, kernel: str = "linear",
                             gamma: float | None = None,
                             alpha_ridge: float = 1.0,
                             return_filter: bool = False):
    """Standard KPCA clean: subtract the top-modes reconstruction
    (reference filters.py:309-370).

    The pixel-mean spectrum is subtracted first; samples are pixels,
    features are frequencies (the reference's ``x.T`` layout).
    """
    shape, x, X = _prepare(field)
    if gamma is None:
        gamma = 1.0 / shape[-1]
    proj, dual = _kpca_fit(X, nmodes, kernel, gamma, alpha_ridge)
    X_fg = _kernel(proj, proj, kernel, gamma) @ dual   # inverse transform
    cleaned = (x - X_fg.T).T.reshape(shape).to(field.dtype)
    if return_filter:
        return cleaned, (proj, dual)
    return cleaned


def kernel_pca_filter(field, nmodes: int, kernel: str = "linear",
                      gamma: float | None = None, alpha_ridge: float = 1.0,
                      return_filter: bool = False):
    """Smallest-retained-mode KPCA clean (reference filters.py:246-306).

    The kernel of the projections onto the *last* (smallest-eigenvalue)
    retained mode, with the ridge term added to its diagonal as the
    reference does at filters.py:299, is applied to the dual coefficients
    of the full ``nmodes`` fit; that reconstruction is returned directly as
    the cleaned field.
    """
    shape, _, X = _prepare(field)
    if gamma is None:
        gamma = 1.0 / shape[-1]
    proj, dual = _kpca_fit(X, nmodes, kernel, gamma, alpha_ridge)
    p_last = proj[:, -1:]                          # (n, 1)
    K1 = _kernel(p_last, p_last, kernel, gamma)
    K1 = K1 + alpha_ridge * torch.eye(K1.shape[0], dtype=K1.dtype,
                                      device=K1.device)
    cleaned = (K1 @ dual).reshape(shape).to(field.dtype)
    if return_filter:
        return cleaned, (proj, dual)
    return cleaned
