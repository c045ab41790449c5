"""RFI in-painting: Gaussian constrained realisations + LSSA.

Torch counterpart of ``fastbox_tpu/analysis/inpaint.py`` (reference
``fastbox/inpaint.py``), batched on the input's device (a numpy input goes
to ``device``; None means the card).  The per-pixel matrix square roots
come from batched ``torch.linalg.eigh``, and the conjugate-gradient solve
runs over all pixels at once with jax.scipy's ``cg`` rule per pixel (a
pixel that has converged keeps its x).  The LSSA sinusoid fits are
closed-form weighted least-squares solves, batched over modes.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import device as devices
from .. import keys

__all__ = [
    "simple_signal_cov",
    "gaussian_cr_1d",
    "trim_flagged_channels",
    "lssa_fit_modes",
    "lssa_decorr_matrix",
    "lssa_pspec",
]

# CG iterations between two host reads of "is any pixel still iterating"
_CG_CHECK_EVERY = 16


def simple_signal_cov(freqs, amplitude, width, ridge_var=1e-10, device=None):
    """Gaussian-correlation signal covariance (inpaint.py:8-32)."""
    freqs = devices.on(freqs, devices.of(freqs, device=device))
    nu, nup = torch.meshgrid(freqs, freqs, indexing="xy")
    return (amplitude * torch.exp(-0.5 * (nu - nup) ** 2 / width**2)
            + ridge_var * torch.eye(freqs.numel(), dtype=freqs.dtype,
                                    device=freqs.device))


def _psd_sqrt(M):
    """Symmetric PSD matrix square root via eigh (batched over the leading
    axes)."""
    vals, vecs = torch.linalg.eigh(M)
    vals = torch.clamp(vals, min=0.0)
    return (vecs * torch.sqrt(vals)[..., None, :]) @ vecs.mT


def _matvec(A, x):
    """A @ x per row of x (A: (..., n, n) or (n, n); x: (..., n))."""
    return torch.matmul(A, x[..., None])[..., 0]


def _cg(A, b, maxiter: int, tol: float):
    """jax.scipy.sparse.linalg.cg on each row of ``b`` with its matrix in
    ``A``, from x0 = 0: iterate while gamma > max(tol^2 |b|^2, 0) and
    k < maxiter; a converged row keeps its values (vmap of a while_loop).
    The host reads whether any row still iterates once every
    ``_CG_CHECK_EVERY`` iterations: the extra iterations change nothing."""
    atol2 = torch.clamp(tol**2 * (b * b).sum(-1), min=0.0)
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    gamma = (r * r).sum(-1)
    k = torch.zeros(b.shape[:-1], dtype=torch.int64, device=b.device)
    it = 0
    while it < maxiter:
        if it % _CG_CHECK_EVERY == 0 and not bool(
                ((gamma > atol2) & (k < maxiter)).any()):
            break
        active = (gamma > atol2) & (k < maxiter)
        Ap = _matvec(A, p)
        alpha = gamma / (p * Ap).sum(-1)
        x_ = x + alpha[..., None] * p
        r_ = r - alpha[..., None] * Ap
        gamma_ = (r_ * r_).sum(-1)
        beta = gamma_ / gamma
        p_ = r_ + beta[..., None] * p
        a = active[..., None]
        x = torch.where(a, x_, x)
        r = torch.where(a, r_, r)
        p = torch.where(a, p_, p)
        gamma = torch.where(active, gamma_, gamma)
        k = k + active.to(k.dtype)
        it += 1
    return x


def gaussian_cr_1d(d, w, S, N, realisations=1, add_noise=True,
                   generator=None, omegas=None, cg_maxiter=10000,
                   cg_tol=1e-8, verbose=False, device=None):
    """Gaussian constrained realisations for flagged 1D spectra
    (inpaint.py:35-155).

    Solves, per pixel, the rescaled CR equation A x = b with
    A = S^1/2 (w N^-1 w) S^1/2 + I and
    b = S^1/2 N^-1 (w d) + omega_N + S^1/2 (w N^-1 w)^1/2 omega_S,
    returning s = S^1/2 x (+ N^1/2 omega_N if ``add_noise``).

    Parameters:
        d: (Npix, Nfreq) data.
        w: (Npix, Nfreq) flag vector (1 unflagged, 0 flagged).
        S, N: (Nfreq, Nfreq) signal/noise covariances.
        realisations: number of constrained realisations.
        generator: draws omega_N and omega_S (replacing the reference's
            global numpy RNG): a key (default ``PRNGKey(0)``), as
            fastbox_tpu draws them (inpaint.py:88-93: ``split(key, R)``,
            then ``kN, kS = split`` and a ``jax.random.normal`` each, one
            launch a field for all R), or a torch.Generator on the device.
        omegas: optional (omega_N, omega_S), each (realisations, Npix,
            Nfreq) unit normals, used instead of drawing.
        verbose: unused (the reference's argument).

    Returns:
        (realisations, Npix, Nfreq) tensor of solutions.
    """
    dev = devices.of(d, w, S, N, device=device)
    d, w, S, N = (devices.on(a, dev) for a in (d, w, S, N))
    npix, nfreq = d.shape

    sqrtS = _psd_sqrt(S)
    sqrtN = _psd_sqrt(N)
    Ninv = torch.linalg.inv(N)
    eye = torch.eye(nfreq, dtype=d.dtype, device=dev)

    # The per-pixel matrices do not depend on the realisation
    Ninvw = w[:, :, None] * Ninv * w[:, None, :]
    sqrtNinvw = _psd_sqrt(Ninvw)
    A = sqrtS @ Ninvw @ sqrtS + eye
    b = _matvec(sqrtS, _matvec(Ninv, w * d))

    if omegas is None and (generator is None or keys.is_key(generator)):
        key = 0 if generator is None else generator
        sub = torch.stack([keys.split(k)
                           for k in keys.split(key, realisations)])
        omegas = tuple(keys.normal(sub[:, j], (npix, nfreq), d.dtype, dev)
                       for j in (0, 1))
    elif omegas is None:
        shape = (realisations, npix, nfreq)
        omegas = tuple(torch.randn(shape, generator=generator, dtype=d.dtype,
                                   device=dev) for _ in range(2))
    omegaN, omegaS = (devices.on(o, dev).to(d.dtype) for o in omegas)

    out = []
    for i in range(realisations):
        b_cr = b + omegaN[i] + _matvec(sqrtS, _matvec(sqrtNinvw, omegaS[i]))
        x = _cg(A, b_cr, int(cg_maxiter), cg_tol)
        s = _matvec(sqrtS, x)
        if add_noise:
            s = s + _matvec(sqrtN, omegaN[i])
        out.append(s)
    return torch.stack(out)


def trim_flagged_channels(w, x):
    """Drop flagged channels from a 1D or square 2D array
    (inpaint.py:158-183)."""
    w = np.asarray(w)
    x = np.asarray(x)
    if not (x.shape == (w.size,) or x.shape == (w.size, w.size)):
        raise ValueError(
            "Input array must have shape (w.size) or (w.size, w.size)")
    if x.ndim == 1:
        return x[w == 1.0]
    return x[:, w == 1.0][w == 1.0, :]


def _complex(dtype):
    return torch.complex64 if dtype in (torch.float32,
                                        torch.complex64) else torch.complex128


def lssa_fit_modes(d, freqs, invcov=None, fit_amp_phase=True, tau=None,
                   taper=None, device=None):
    """Weighted LSSA fit of complex sinusoids to masked 1D data
    (inpaint.py:192-306).

    The log-likelihood is exactly quadratic in the complex amplitude
    A = A_re + i A_im for each tau, so the minimiser is the closed-form
    generalised-least-squares solution — mathematically the exact optimum
    the reference's bounded L-BFGS-B search approximates.  Fits all modes
    at once (batched).

    Returns (tau [ns], param1, param2): amplitude+phase if
    ``fit_amp_phase`` else (A_re, A_im).
    """
    dev = devices.of(d, freqs, invcov, tau, taper, device=device)
    d, freqs, invcov = (devices.on(a, dev) for a in (d, freqs, invcov))
    if not d.numel() == invcov.shape[0] == invcov.shape[1] == freqs.numel():
        raise ValueError("Data, inv. covariance, and freqs array must have "
                         "same number of channels")

    if tau is None:
        f = freqs.cpu().numpy()
        tau = np.fft.fftfreq(n=f.size, d=float(f[1] - f[0])) * 1e3
    tau = devices.on(tau, dev)

    t = torch.ones_like(freqs) if taper is None else devices.on(taper, dev)
    cdtype = _complex(torch.promote_types(d.dtype, freqs.dtype))

    # model m = A exp(2 pi i tau nu); residual x = taper (d - m), per mode
    theta = (2.0 * np.pi * tau)[:, None] * freqs[None, :]
    phase = torch.polar(torch.ones_like(theta), theta).to(cdtype)
    g = t * phase                       # taper-weighted basis, (modes, F)
    td = (t * d).to(cdtype)
    C = invcov.to(cdtype)
    # minimise (td - A g)^H C^-1 (td - A g) over complex A
    denom = torch.real((g.conj() * (g @ C.mT)).sum(-1))
    num = g.conj() @ (C @ td)
    A = num / torch.where(denom != 0.0, denom, 1.0)
    A_re, A_im = torch.real(A), torch.imag(A)
    if fit_amp_phase:
        amp = torch.sqrt(A_re**2 + A_im**2)
        ph = torch.remainder(torch.atan2(A_im, A_re), 2.0 * np.pi)
        return tau, amp, ph
    return tau, A_re, A_im


def _decorr(w, tau, freqs):
    """``lssa_decorr_matrix`` batched over ``tau``'s leading axes:
    rotations (..., 2, 2) and eigenvalues (..., 2)."""
    ang = 2.0 * np.pi * tau[..., None] * freqs / 1e3
    cos = w * torch.cos(ang)
    sin = w * torch.sin(ang)
    cc, cs, ss = (cos * cos).sum(-1), (cos * sin).sum(-1), (sin * sin).sum(-1)
    cov = torch.stack([torch.stack([cc, cs], -1),
                       torch.stack([cs, ss], -1)], -2)
    theta = 0.5 * torch.atan2(2.0 * cs, cc - ss)
    c, s = torch.cos(theta), torch.sin(theta)
    rot = torch.stack([torch.stack([c, s], -1), torch.stack([-s, c], -1)], -2)
    eigvals = torch.diagonal(rot @ cov @ rot.mT, dim1=-2, dim2=-1)
    return rot, eigvals


def lssa_decorr_matrix(w, tau, freqs, device=None):
    """Rotation decorrelating the real/imag LSSA amplitudes
    (inpaint.py:309-361)."""
    dev = devices.of(w, tau, freqs, device=device)
    w, tau, freqs = (devices.on(a, dev) for a in (w, tau, freqs))
    return _decorr(w, tau, freqs)


def lssa_pspec(A_re, A_im, w, tau, freqs, decorrelate_amps=True,
               device=None):
    """LSSA power spectrum with decorrelation re-weighting
    (inpaint.py:364-399); ``decorrelate_amps`` is unused, as there."""
    dev = devices.of(A_re, A_im, w, tau, freqs, device=device)
    A_re, A_im, w, tau, freqs = (devices.on(a, dev)
                                 for a in (A_re, A_im, w, tau, freqs))
    rot, eig = _decorr(w, tau, freqs)
    A12 = _matvec(rot, torch.stack([A_re, A_im], -1))
    A1, A2 = A12[..., 0], A12[..., 1]
    e0, e1 = eig[..., 0], eig[..., 1]
    return ((A1 * e1) ** 2 + (A2 * e0) ** 2) / (e0**2 + e1**2)
