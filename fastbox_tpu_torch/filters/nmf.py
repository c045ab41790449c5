"""Non-negative matrix factorisation foreground filter (counterpart of
fastbox_tpu/filters/nmf.py).

Reference: ``fastbox.filters.nmf_filter`` (filters.py:373-432) wraps
``sklearn.decomposition.NMF``.  Here NMF is solved on the data's device with
the multiplicative-update rules for the Frobenius objective from a
deterministic NNDSVDa initialisation, so no generator is needed.  The input
must be non-negative, as in the reference; a float32 cube is factored in
float64, as ``pca_filter`` cleans.
"""
from __future__ import annotations

import torch

from .pca import _work

__all__ = ["nmf", "nmf_filter"]

_EPS = 1e-12


def _nndsvda_init(X, k):
    """Deterministic NNDSVDa initialisation (Boutsidis & Gallopoulos 2008).

    A joint sign flip of a singular pair (u, v) swaps the positive and
    negative parts, which leaves the chosen factor unchanged, except on a
    tie mp == mn, where ``>=`` takes the positive part.
    """
    U, S, Vt = torch.linalg.svd(X, full_matrices=False)
    W = torch.zeros((X.shape[0], k), dtype=X.dtype, device=X.device)
    H = torch.zeros((k, X.shape[1]), dtype=X.dtype, device=X.device)
    # Leading factor
    W[:, 0] = torch.sqrt(S[0]) * torch.abs(U[:, 0])
    H[0, :] = torch.sqrt(S[0]) * torch.abs(Vt[0, :])
    for j in range(1, k):
        u, v = U[:, j], Vt[j, :]
        up, un = torch.clamp(u, min=0), torch.clamp(-u, min=0)
        vp, vn = torch.clamp(v, min=0), torch.clamp(-v, min=0)
        nup, nun = torch.linalg.norm(up), torch.linalg.norm(un)
        nvp, nvn = torch.linalg.norm(vp), torch.linalg.norm(vn)
        mp, mn = nup * nvp, nun * nvn
        use_p = mp >= mn
        sig = torch.where(use_p, mp, mn)
        uu = torch.where(use_p, up / torch.clamp(nup, min=_EPS),
                         un / torch.clamp(nun, min=_EPS))
        vv = torch.where(use_p, vp / torch.clamp(nvp, min=_EPS),
                         vn / torch.clamp(nvn, min=_EPS))
        W[:, j] = torch.sqrt(S[j] * sig) * uu
        H[j, :] = torch.sqrt(S[j] * sig) * vv
    # 'a' variant: replace zeros with the data mean
    avg = torch.mean(X)
    W = torch.where(W <= 0, avg, W)
    H = torch.where(H <= 0, avg, H)
    return W, H


def nmf(X, n_components: int, max_iter: int = 200):
    """Factor non-negative X ~ W H; returns (W, H)."""
    W, H = _nndsvda_init(X, n_components)
    for _ in range(max_iter):
        H = H * (W.T @ X) / torch.clamp(W.T @ W @ H, min=_EPS)
        W = W * (X @ H.T) / torch.clamp(W @ (H @ H.T), min=_EPS)
    return W, H


def nmf_filter(field, nmodes: int, return_filter: bool = False,
               max_iter: int = 200):
    """NMF foreground clean of a non-negative datacube (filters.py:373-432).

    The reference does *not* mean-subtract before NMF (the data must stay
    non-negative); neither does this.
    """
    shape = field.shape
    x = _work(field).reshape(-1, shape[-1]).T  # (Nfreq, Npix)
    W, H = nmf(x, nmodes, max_iter=max_iter)
    cleaned = (x - W @ H).T.reshape(shape).to(field.dtype)
    if return_filter:
        return cleaned, (W, H)
    return cleaned
