"""Semi-amortized VI: per-observation refinement of the amortized posterior
(counterpart of ``vbicm_tpu/vi/refine.py``).

The amortized nets are trained across the whole dataset, so on a given
observation their output carries an amortization gap. Refinement treats
that output as an initialization and runs direct SVI on the single
observation's own ELBO with a full-covariance q = N(mu, L L^T): fresh
reparameterization noise every step, Adam, and a learning rate held for
60 % of the run and then cosine-annealed to 2 % of itself. Cost: ``steps *
ne`` FEM solves forward and adjoint, first derivatives only.
"""
from __future__ import annotations

import math
from typing import Callable, Tuple

import numpy as np
import torch

from ..utils.draws import draw_normal
from .elbo import make_loss_step1_fullcov

ALPHA = 0.02  # the annealed learning rate's floor, a fraction of lr


def refine_lr(lr: float, steps: int, step: int) -> float:
    """The learning rate of step ``step`` (0-based): ``lr`` for the first
    ``hold = int(0.6 * steps)`` steps, then cosine decay over the remaining
    ``max(steps - hold, 1)`` to ``ALPHA * lr`` (optax's
    ``join_schedules([constant_schedule(lr), cosine_decay_schedule(lr,
    steps - hold, alpha=0.02)], [hold])``, step for step)."""
    hold = int(0.6 * steps)
    if step < hold:
        return lr
    decay = max(steps - hold, 1)
    count = min(step - hold, decay)
    return lr * ((1 - ALPHA) * (0.5 * (1 + math.cos(math.pi * count / decay))) + ALPHA)


def refine_posterior(
    batch_f: Callable,
    y,
    sig_e: float,
    mu0,
    L0,
    *,
    generator: torch.Generator,
    steps: int = 300,
    ne: int = 8,
    lr: float = 5e-3,
    chunk_steps: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Refine one observation's full-covariance posterior by direct SVI.

    ``batch_f``: thetas (N, d) -> f (N, d_y), the observation operator's
    first output. ``mu0`` (d,) and ``L0`` (d, d) initialize the variational
    parameters (the amortized head's mean and ``diag(std)``, for example);
    the device and dtype are ``mu0``'s. The parameters are (mu, log of L's
    squared diagonal, L's strict lower triangle), stepped by Adam (optax's
    defaults, eps 1e-8) at :func:`refine_lr`'s rate; each step draws its
    own (ne, d) noise, all drawn from ``generator`` up front.

    The losses stay on the device. ``chunk_steps > 0`` waits for the
    device at the end of every ``chunk_steps`` steps, so that no more than
    a chunk of steps is queued ahead of it; the trajectory is the same bit
    for bit.

    Returns ``(mu, L, loss_history)`` on the device.
    """
    mu0 = torch.as_tensor(mu0)
    device, dtype = mu0.device, mu0.dtype
    y = torch.as_tensor(y, dtype=dtype, device=device)
    L0 = torch.as_tensor(L0, dtype=dtype, device=device)
    d = mu0.shape[-1]
    il, jl = (torch.as_tensor(i, device=device) for i in np.tril_indices(d, -1))
    diag = torch.arange(d, device=device)
    loss_fn = make_loss_step1_fullcov(batch_f, None, sig_e)

    def build_L(log_diag, off):
        L = torch.zeros((d, d), dtype=dtype, device=device)
        L = L.index_put((il, jl), off)
        return L.index_put((diag, diag), torch.exp(0.5 * log_diag))

    params = [mu0.detach().clone(), 2.0 * torch.log(torch.diagonal(L0)), L0[il, jl]]
    params = [p.detach().clone().requires_grad_(True) for p in params]
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    e_all = draw_normal(generator, (steps, ne, d), dtype, device)
    losses = torch.empty(steps, dtype=dtype, device=device)
    for t in range(steps):
        for group in opt.param_groups:
            group["lr"] = refine_lr(lr, steps, t)
        mu, log_diag, off = params
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(y[None, :], (mu[None], build_L(log_diag, off)[None], log_diag[None]),
                       e_all[t])
        loss.backward()
        opt.step()
        losses[t] = loss.detach()
        if chunk_steps and (t + 1) % chunk_steps == 0 and device.type == "cuda":
            torch.cuda.synchronize(device)
    mu, log_diag, off = (p.detach() for p in params)
    return mu, build_L(log_diag, off), losses
