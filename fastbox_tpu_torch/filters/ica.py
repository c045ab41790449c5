"""FastICA foreground filter (counterpart of fastbox_tpu/filters/ica.py).

Reference: ``fastbox.filters.ica_filter`` (filters.py:187-243) wraps
``sklearn.decomposition.FastICA``.  Here the parallel (symmetric) FastICA
fixed-point iteration with the logcosh contrast runs on the data's device.
fastbox_tpu's ``lax.while_loop`` is a Python loop with the same test
(``lim > tol`` and fewer than ``max_iter`` iterations), which reads ``lim``
to the host once per iteration; each iteration's symmetric decorrelation is
an ``nc x nc`` ``eigh`` on the device.

The cleaned field does not depend on the rotation W: FastICA's
reconstruction (fit_transform then inverse_transform) spans the top-``nmodes``
principal subspace of the whitened data, so it equals the PCA-cleaned field
whatever the iteration converged to.  A float32 cube is cleaned in float64,
as ``pca_filter`` does.
"""
from __future__ import annotations

import torch

from .. import keys
from .pca import _work

__all__ = ["fastica", "ica_filter"]


def _sym_decorrelation(W):
    """W <- (W W^T)^(-1/2) W."""
    s, u = torch.linalg.eigh(W @ W.T)
    s = torch.clamp(s, min=1e-12)
    return (u * (1.0 / torch.sqrt(s))) @ u.T @ W


def fastica(X, generator=None, n_components: int = 1, max_iter: int = 200,
            tol: float = 1e-4, w0=None):
    """Parallel FastICA with logcosh contrast on X of shape (features,
    samples).

    The starting (n_components, n_components) matrix is ``w0`` or unit
    normals on X's device: ``jax.random.normal(key, (nc, nc))`` in float64
    (jax's default float in 64-bit mode; fastbox_tpu/filters/ica.py:48)
    for a key, or draws of a ``torch.Generator``.  Returns (W, the
    whitening K (n_components, features), the mean (features, 1)).
    """
    nfeat, nsamp = X.shape
    mean = torch.mean(X, dim=1, keepdim=True)
    Xc = X - mean

    # Whitening via SVD of the covariance; keep n_components
    U, S, _ = torch.linalg.svd(Xc @ Xc.T / nsamp)
    K = (U[:, :n_components] / torch.sqrt(S[:n_components])[None, :]).T
    Xw = K @ Xc  # (nc, nsamp), unit covariance

    if w0 is None and keys.is_key(generator):
        w0 = keys.normal(generator, (n_components, n_components),
                         torch.float64, device=X.device)
    elif w0 is None:
        w0 = torch.randn((n_components, n_components), generator=generator,
                         dtype=X.dtype, device=X.device)
    W = _sym_decorrelation(torch.as_tensor(w0, dtype=X.dtype,
                                           device=X.device))
    for _ in range(max_iter):
        g = torch.tanh(W @ Xw)
        g_prime = torch.mean(1.0 - g**2, dim=1)
        W_new = _sym_decorrelation((g @ Xw.T) / nsamp - g_prime[:, None] * W)
        lim = torch.max(torch.abs(torch.abs(torch.diagonal(W_new @ W.T))
                                  - 1.0))
        W = W_new
        if not float(lim) > tol:
            break
    return W, K, mean


def ica_filter(field, nmodes: int, generator=None, return_filter: bool = False,
               max_iter: int = 200, tol: float = 1e-4, w0=None):
    """ICA foreground clean of a (Nx, Ny, Nfreq) datacube (filters.py:187-243).

    The pixel-mean spectrum is subtracted first, as the reference does via
    ``mean_spectrum_filter``.  FastICA starts from ``w0`` or from the
    normals of ``generator``: a key (default ``PRNGKey(0)``, as
    fastbox_tpu's, filters/ica.py:75-76) or a ``torch.Generator``.
    """
    if generator is None and w0 is None:
        generator = 0
    shape = field.shape
    d = _work(field).reshape(-1, shape[-1]).T  # (Nfreq, Npix)
    x = d - torch.mean(d, dim=1, keepdim=True)  # subtract mean spectrum

    W, K, mean = fastica(x, generator, nmodes, max_iter=max_iter, tol=tol,
                         w0=w0)

    # Sources and reconstruction: x_fg = pinv(W K) (W K) (x - mean) + mean
    WK = W @ K                         # (nc, nfeat) unmixing
    sources = WK @ (x - mean)          # (nc, Npix)
    mixing = torch.linalg.pinv(WK)     # (nfeat, nc)
    x_fg = mixing @ sources + mean

    cleaned = (x - x_fg).T.reshape(shape).to(field.dtype)
    if return_filter:
        return cleaned, (WK, mixing, sources)
    return cleaned
