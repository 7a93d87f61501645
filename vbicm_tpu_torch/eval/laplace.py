"""MAP + Laplace posterior approximation (counterpart of
``vbicm_tpu/eval/laplace.py``).

The classical-Bayes baseline for a single observation: maximize the log-
posterior with L-BFGS through the differentiable FEM solve, then take the
Gaussian at the mode with covariance = inverse Hessian. The Hessian is
exact autodiff through the spectral solve's backward pass, differentiated
once more (d^2 solves for a d-dimensional theta). L-BFGS runs on the
device; the optimizer's iterates differ from optax's, the mode and the
covariance it converges to do not.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


class _Converged(Exception):
    """Ends L-BFGS at the first evaluated point that meets the stopping rule."""


@dataclasses.dataclass(frozen=True)
class LaplaceResult:
    theta_map: np.ndarray  # (d,) posterior mode
    cov: np.ndarray  # (d, d) inverse Hessian at the mode
    logpost_map: float
    grad_norm: float  # sup-norm of grad logpost at the returned mode
    converged: bool


def laplace_posterior(
    logpost: Callable,
    theta0,
    *,
    max_iters: int = 200,
    tol: float = 1e-8,
) -> LaplaceResult:
    """Maximize ``logpost`` from ``theta0`` (d,) with L-BFGS (strong-Wolfe
    line search, 10 pairs of history as optax's), then Laplace-expand at
    the mode. ``logpost`` is batched, ``thetas (C, d) -> (C,)``
    (``eval.mcmc.make_fem_logpost``); it is called with C = 1. The device
    and dtype are ``theta0``'s.

    ``tol``: the stopping rule, gradient sup-norm at most ``tol``, tested
    on the iterate that is returned. The covariance is the inverse of the
    symmetrized negative Hessian; a Hessian that is not positive definite
    (a saddle or a flat direction) raises ``ValueError``.
    """
    theta = torch.as_tensor(theta0).detach().clone().requires_grad_(True)

    def nll(t):
        return -logpost(t[None])[0]

    opt = torch.optim.LBFGS([theta], lr=1.0, max_iter=max_iters, max_eval=25 * max_iters,
                            tolerance_grad=tol, tolerance_change=0.0, history_size=10,
                            line_search_fn="strong_wolfe")
    found = []

    def closure():
        opt.zero_grad()
        loss = nll(theta)
        loss.backward()
        if float(theta.grad.abs().max()) <= tol:
            # the stopping rule holds at this evaluated point (an iterate or
            # a line-search trial): it is the mode returned
            found.append(theta.detach().clone())
            raise _Converged
        return loss

    try:
        opt.step(closure)
    except _Converged:
        pass
    theta_map = found[0] if found else theta.detach()
    t = theta_map.clone().requires_grad_(True)
    value = nll(t)
    (g,) = torch.autograd.grad(value, t)
    H = torch.autograd.functional.hessian(nll, theta_map).cpu().numpy()
    H = 0.5 * (H + H.T)
    try:  # positive-definiteness check
        np.linalg.cholesky(H)
    except np.linalg.LinAlgError as e:
        raise ValueError(
            "Hessian at the mode is not positive definite: the Laplace "
            "approximation is meaningless here (saddle or flat direction)"
        ) from e
    gnorm = float(g.abs().max())
    return LaplaceResult(
        theta_map=theta_map.cpu().numpy(),
        cov=np.linalg.inv(H),
        logpost_map=-float(value.detach()),
        grad_norm=gnorm,
        converged=gnorm <= tol,
    )
