"""Gaussian-process-regression foreground filter (counterpart of
fastbox_tpu/filters/gpr.py).

Reference: ``fastbox.filters.gpr_filter`` (filters.py:494-595) wraps GPy
with a user-supplied kernel list (default RBF foreground + Exponential
signal), bounded hyperparameters, ``optimize`` + ``optimize_restarts``, and
subtracts the posterior mean of the FIRST kernel (the foreground
component).  Here the same model is a marginal-likelihood fit over the
(Nfreq x Nfreq) kernel matrix on the data's device:

* frequencies normalised to [0, 1] (filters.py:553);
* kernels given as :class:`KernelSpec` entries (kind + hyperparameter
  bounds); the first spec is the foreground component;
* default specs reproduce the reference's bounds: RBF variance in
  [1e-4, 1e2] x var(x), lengthscale in [1e-3, 1e2]; Exponential variance
  in [1e-14, 1e-4] x var(x), lengthscale in [1e-6, 1e-3]
  (filters.py:559-567); Gaussian noise variance in [1e-8, 1e2] x var(x);
* bounds enforced by a sigmoid reparameterisation, hyperparameters fitted
  by ``torch.optim.Adam`` (lr 0.05, betas (0.9, 0.999), eps 1e-8: optax's
  ``adam`` update up to rounding) from ``1 + opt_num_restarts`` starts,
  keeping the best final likelihood.

The starts are fitted together: one (nstarts, nparam) parameter tensor and
one optimiser on the sum of the starts' independent losses, which Adam's
elementwise update makes the same as separate fits.  The data enter the
likelihood only through S = x x^T, formed once, so each step costs
O(Nfreq^3) whatever the pixel count: x . K^-1 x summed over pixels is
trace(K^-1 S).  A start whose kernel matrix is not positive definite gets a
NaN loss from then on, as ``jnp.linalg.cholesky``'s NaNs give it in
fastbox_tpu, where ``torch.linalg.cholesky`` would raise; the best start is
chosen among the finite losses.  A float32 cube is fitted and cleaned in
float64, as ``pca_filter`` cleans.
"""
from __future__ import annotations

import dataclasses

import torch

from .pca import _work

__all__ = ["KernelSpec", "gpr_filter"]

_SQRT3 = 1.7320508075688772
_SQRT5 = 2.23606797749979


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One stationary kernel component with bounded hyperparameters.

    Bounds are absolute (like GPy's ``constrain_bounded``); frequencies are
    on the unit interval, so lengthscales are fractions of the band.
    """

    kind: str                                   # rbf|exponential|matern32|matern52|white|bias
    variance_bounds: tuple[float, float]
    lengthscale_bounds: tuple[float, float] = (1e-3, 1e2)


def _kern_matrix(kind: str, nu, var, ls):
    """The (Nfreq, Nfreq) kernel on ``nu``; ``var``/``ls`` are numbers or
    (nstarts, 1, 1) tensors, giving a batch of kernels."""
    d = torch.abs(nu[:, None] - nu[None, :])
    if kind == "rbf":
        return var * torch.exp(-0.5 * (d / ls) ** 2)
    if kind == "exponential":
        return var * torch.exp(-d / ls)
    if kind == "matern32":
        r = _SQRT3 * d / ls
        return var * (1.0 + r) * torch.exp(-r)
    if kind == "matern52":
        r = _SQRT5 * d / ls
        return var * (1.0 + r + r**2 / 3.0) * torch.exp(-r)
    if kind == "white":
        return var * torch.eye(nu.numel(), dtype=nu.dtype, device=nu.device)
    if kind == "bias":
        return var * torch.ones((nu.numel(), nu.numel()), dtype=nu.dtype,
                                device=nu.device)
    raise ValueError(f"Unknown GPR kernel kind '{kind}'")


def _bounded(theta, lo, hi):
    """Map an unconstrained parameter to (lo, hi) via sigmoid (log-spaced)."""
    return torch.exp(torch.log(lo) + torch.sigmoid(theta)
                     * (torch.log(hi) - torch.log(lo)))


def _cholesky(A):
    """(Cholesky factor of A, NaN where A is not positive definite; True
    where the factorisation succeeded)."""
    L, info = torch.linalg.cholesky_ex(A)
    ok = info == 0
    return torch.where(ok[..., None, None], L, torch.nan), ok


def _nu(nfreq: int, like):
    return torch.linspace(0.0, 1.0, nfreq, dtype=like.dtype,
                          device=like.device)


def _fit_gpr(x, bounds, kinds: tuple[str, ...], nsteps: int = 500,
             lr: float = 0.05, nstarts: int = 1, generator=None, starts=None):
    """x: (Nfreq, Npix); bounds: (2*nk+1, 2) [var_i, ls_i ..., noise].

    Fits ``nstarts`` starts: zeros, then ``starts`` (nstarts - 1, nparam)
    or uniforms in [-3, 3) from ``generator`` (default: seeded with 0 on
    x's device).  Returns the raw parameter vector with the lowest final
    negative log marginal likelihood among the finite ones, and that loss.
    """
    nfreq, npix = x.shape
    nu = _nu(nfreq, x)
    nk = len(kinds)
    nparam = 2 * nk + 1
    S = x @ x.T                                      # (Nfreq, Nfreq)
    eye = torch.eye(nfreq, dtype=x.dtype, device=x.device)

    def neg_log_marginal(theta):
        """(nstarts,) losses and whether each factorisation succeeded."""
        p = [_bounded(theta[:, i], bounds[i, 0], bounds[i, 1])[:, None, None]
             for i in range(nparam)]
        K = p[-1] * eye                              # noise
        for i, kind in enumerate(kinds):
            K = K + _kern_matrix(kind, nu, p[2 * i], p[2 * i + 1])
        L, ok = _cholesky(K)
        quad = torch.diagonal(torch.cholesky_solve(S.expand_as(K), L),
                              dim1=-2, dim2=-1).sum(-1)
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2,
                                                          dim2=-1)), -1)
        return 0.5 * (quad + npix * logdet), ok

    theta0 = torch.zeros((1, nparam), dtype=x.dtype, device=x.device)
    if nstarts > 1:
        if starts is None:
            if generator is None:
                generator = torch.Generator(device=x.device).manual_seed(0)
            starts = 6.0 * torch.rand((nstarts - 1, nparam),
                                      generator=generator, dtype=x.dtype,
                                      device=x.device) - 3.0
        starts = torch.as_tensor(starts, dtype=x.dtype, device=x.device)
        if starts.shape != (nstarts - 1, nparam):
            raise ValueError(f"starts must be ({nstarts - 1}, {nparam}); "
                             f"got {tuple(starts.shape)}")
        theta0 = torch.cat([theta0, starts])
    theta = theta0.clone().requires_grad_(True)
    opt = torch.optim.Adam([theta], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    alive = torch.ones(theta.shape[0], dtype=torch.bool, device=x.device)
    for _ in range(nsteps):
        opt.zero_grad()
        loss, ok = neg_log_marginal(theta)
        alive = alive & ok
        loss.sum().backward()
        opt.step()
    losses = torch.where(alive, loss.detach(), torch.nan)
    best = torch.argmin(torch.where(torch.isfinite(losses), losses,
                                    torch.inf))
    return theta.detach()[best], losses[best]


def gpr_filter(field, kernels=None, return_filter: bool = False,
               opt_messages: bool = False, opt_num_restarts: int = 0,
               nsteps: int = 500, generator=None, fixed_params=None,
               starts=None):
    """GPR foreground clean of a (Nx, Ny, Nfreq) datacube (filters.py:494-595).

    Parameters:
        field: datacube; frequency is the last axis.
        kernels: list of :class:`KernelSpec`.  The FIRST spec is the
            foreground component whose posterior mean is subtracted, like
            the reference's GPy kernel list (filters.py:508-518,584-586).
            None selects the reference's default RBF+Exponential pair with
            its variance bounds scaled by ``var(x)``.
        opt_num_restarts: extra random optimizer starts beyond the default
            deterministic one (GPy ``optimize_restarts`` analog).
        nsteps: Adam steps per start.
        generator: draws the restarts' starting points (seeded default).
        fixed_params: optional flat sequence ``[var_1, ls_1, ...,
            noise_var]`` of ABSOLUTE hyperparameters.  When given, no
            optimisation runs: the posterior mean is evaluated at exactly
            these values (GPy's ``param.fix()`` analog), which is exact
            linear algebra with no optimiser in the loop.
        starts: the restarts' raw starting points (opt_num_restarts,
            2*nkernels+1) in place of ``generator``'s draws.

    Returns the residual ``x - posterior_mean_fg`` reshaped to the cube
    (and optionally the fitted hyperparameters).
    """
    if opt_messages:
        print(f"gpr_filter: {1 + opt_num_restarts} starts x {nsteps} Adam steps")
    shape = field.shape
    d = _work(field).reshape(-1, shape[-1]).T   # (Nfreq, Npix)
    x = d - torch.mean(d, dim=1, keepdim=True)
    var = float(torch.var(x, correction=0))

    if kernels is None:
        kernels = [
            KernelSpec("rbf", (1e-4 * var, 1e2 * var), (1e-3, 1e2)),
            KernelSpec("exponential", (1e-14 * var, 1e-4 * var), (1e-6, 1e-3)),
        ]
    for k in kernels:
        if not isinstance(k, KernelSpec):
            raise TypeError(
                "kernels must be KernelSpec instances (the native analog of "
                "the reference's GPy kernel list); got "
                f"{type(k).__name__}")

    kinds = tuple(k.kind for k in kernels)
    bounds_rows = []
    for k in kernels:
        bounds_rows.append(k.variance_bounds)
        bounds_rows.append(k.lengthscale_bounds)
    bounds_rows.append((1e-8 * var, 1e2 * var))   # noise variance
    bounds = torch.tensor(bounds_rows, dtype=x.dtype, device=x.device)

    if fixed_params is not None:
        params = [float(v) for v in fixed_params]
        if len(params) != 2 * len(kinds) + 1:
            raise ValueError(
                f"fixed_params needs 2*nkernels+1 = {2 * len(kinds) + 1} "
                f"values [var_i, ls_i, ..., noise_var]; got {len(params)}")
    else:
        theta, _ = _fit_gpr(x, bounds, kinds, nsteps=nsteps,
                            nstarts=1 + int(opt_num_restarts),
                            generator=generator, starts=starts)
        params = _bounded(theta, bounds[:, 0], bounds[:, 1]).tolist()

    nu = _nu(shape[-1], x)
    K_fg = _kern_matrix(kinds[0], nu, params[0], params[1])
    K_tot = params[-1] * torch.eye(shape[-1], dtype=x.dtype, device=x.device)
    for i, kind in enumerate(kinds):
        K_tot = K_tot + _kern_matrix(kind, nu, params[2 * i], params[2 * i + 1])
    # Foreground posterior mean: K_fg K_tot^-1 x (include_likelihood=False)
    L, _ = _cholesky(K_tot)
    x_fg = K_fg @ torch.cholesky_solve(x, L)

    cleaned = (x - x_fg).T.reshape(shape).to(field.dtype)
    if return_filter:
        return cleaned, dict(zip(
            [f"{kinds[i//2]}_{'var' if i % 2 == 0 else 'ls'}"
             for i in range(2 * len(kinds))] + ["noise_var"], params))
    return cleaned
