"""Plain step-1 update of the two-step amortized VI scheme: the posterior
pair of MLPs, the ELBO loss with the FEM inside and Adam.

q(theta | y) is N(mean(y), diag(exp(logvar(y)))), each head an MLP of
``layers`` hidden ReLU layers of width ``hidden`` and a linear output on
the raw observation y, or with ``y_norm = (mean, std)`` on (y - mean) /
std (the likelihood keeps the raw y). A batch of b observations and the
fixed base draws e (ne, 2) give the b * ne posterior samples ``theta = e *
exp(logvar / 2) + mean`` (observation-major); the loss is

    term1 = -mean_b sum logvar / 2 - d/2 log(2 pi) - d/2
    term2 = -d_y/2 log(2 pi sig_e) + mean over pairs of -|y - f|^2 / (2 sig_e)
    term3 = -d/2 log(2 pi) - mean_b sum(exp(logvar) + mean^2) / 2
    loss  = term1 - term2 - term3

where the pairs are every observation of the batch against every sample of
the batch ("cross") or against its own ne samples ("per_sample"), and f the
FEM's displacement at the samples. Adam (optionally after clipping the
global gradient norm) then updates both heads.
"""
from __future__ import annotations

import math

import torch

from . import fem


def glorot_params(generator: torch.Generator, in_dim, hidden, layers, out_dim, dtype):
    """The weights of the two heads in the order mean head then variance
    head, each layer's (weight (out, in), bias (out,)): glorot-uniform
    weights, zero biases, drawn on the host from ``generator``."""
    widths = [in_dim] + [hidden] * layers + [out_dim]
    params = []
    for _ in range(2):
        for i, o in zip(widths[:-1], widths[1:]):
            limit = math.sqrt(6.0 / (i + o))
            w = torch.empty((o, i), dtype=torch.float64).uniform_(-limit, limit,
                                                                 generator=generator)
            params += [w.to(dtype), torch.zeros(o, dtype=dtype)]
    return params


def mlp(params, x):
    n = len(params) // 2
    for k in range(n):
        x = x @ params[2 * k].T + params[2 * k + 1]
        if k < n - 1:
            x = torch.relu(x)
    return x


def step1_loss(params, y, e, theta_to_f, sig_e, pairing, y_norm=None):
    """The step-1 loss of a batch y (b, d_y) with base draws e (ne, d)."""
    half = len(params) // 2
    x = y if y_norm is None else (y - y_norm[0]) / y_norm[1]
    mean, logvar = mlp(params[:half], x), mlp(params[half:], x)
    d, d_y, ne = mean.shape[1], y.shape[1], e.shape[0]
    theta = (e[None] * torch.exp(0.5 * logvar)[:, None] + mean[:, None]).reshape(-1, d)
    f = theta_to_f(theta)
    if pairing == "cross":
        diff = y[:, None, :] - f[None, :, :]
    else:
        diff = y[:, None, :] - f.reshape(y.shape[0], ne, d_y)
    t1 = -0.5 * logvar.sum(-1).mean() - 0.5 * d * math.log(2 * math.pi) - 0.5 * d
    t2 = -0.5 * d_y * math.log(2 * math.pi * sig_e) + (-0.5 / sig_e * (diff**2).sum(-1)).mean()
    t3 = -0.5 * d * math.log(2 * math.pi) - 0.5 * (torch.exp(logvar) + mean**2).sum(-1).mean()
    return t1 - t2 - t3


class Adam:
    """Adam with eps outside the square root, and optional clipping of the
    gradients' global norm before it; from a fresh state, or from a given
    one: the moments ``m``, ``v`` by leaf and the step count ``t``."""

    def __init__(self, params, lr, betas, eps, clip=None, state=None):
        self.lr, (self.b1, self.b2), self.eps, self.clip = lr, betas, eps, clip
        if state is None:
            state = ([torch.zeros_like(p) for p in params],
                     [torch.zeros_like(p) for p in params], 0)
        self.m, self.v, self.t = list(state[0]), list(state[1]), int(state[2])
        self.grads = None  # the last step's gradients as Adam took them

    def step(self, params, grads):
        if self.clip is not None:
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            if norm >= self.clip:
                grads = [g / norm * self.clip for g in grads]
        self.grads = list(grads)
        self.t += 1
        c1, c2 = 1 - self.b1**self.t, 1 - self.b2**self.t
        out = []
        for k, (p, g) in enumerate(zip(params, grads)):
            self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g * g
            out.append(p - self.lr * (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + self.eps))
        return out


def follow_steps(problem, solver, params0, batches, e, config, state=None,
                 dtype=torch.float64, observe=fem.observe, y_norm=None):
    """The reference's own steps from ``params0`` and Adam's ``state``
    (``(m, v, t)``; fresh if None) over ``batches`` (a list of y (b, d_y)),
    through the problem's ``observe`` (``fem``'s or ``fem_box``'s), the
    nets' inputs standardised by ``y_norm`` where given: (losses, the first
    step's gradients as Adam took them, by leaf, params after the last
    step)."""
    adam_cfg = config["adam"]
    on = dict(dtype=dtype, device=problem.device)
    params = [p.to(**on) for p in params0]
    if state is not None:
        state = ([m.to(**on) for m in state[0]], [v.to(**on) for v in state[1]], state[2])
    opt = Adam(params, adam_cfg["lr"], tuple(adam_cfg["betas"]), adam_cfg["eps"],
               adam_cfg["clip_grad_norm"], state)
    e = e.to(**on)
    if y_norm is not None:
        y_norm = tuple(t.to(**on) for t in y_norm)
    sig_e = config["noise"]["sig_e"]
    losses, first_grads = [], None
    for y in batches:
        leaves = [p.detach().requires_grad_(True) for p in params]
        loss = step1_loss(leaves, y.to(**on), e,
                          lambda th: observe(problem, solver, th, with_h=False)[0],
                          sig_e, config["pairing"], y_norm)
        grads = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        params = [p.detach() for p in opt.step(leaves, grads)]
        if first_grads is None:
            first_grads = [g.detach() for g in opt.grads]
    return losses, first_grads, params
