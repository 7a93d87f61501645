"""Conditional normalizing-flow posterior q(theta|y) (counterpart of
``vbicm_tpu/models/flow.py``).

Affine coupling layers (RealNVP-style) on top of the mean-field base:

    theta_0 = mu(y) + exp(0.5 * log_sig(y)) * e,      e ~ N(0, I)
    theta_{k+1}[passive] = theta_k[passive] * exp(s_k) + t_k,
        (s_k, t_k) = MLP_k([theta_k * mask_k, y_norm])

with the active dims ``(idx + k) % 2 == 0`` alternating across layers and
the scales bounded, ``s = s_cap * tanh(raw / s_cap)``. The log-density is
exact by the change of variables,

    log q(theta|y) = log N(e) - 0.5 * sum(log_sig) - sum_k sum(s_k).

The coupling heads are zero-initialized: at init every coupling is the
identity and the flow is the mean-field base. Every layer is a small dense
product over the (B, ne) sample block, kept as ``nn.Linear``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..utils.draws import draw_normal
from .mlp import MLP, _YNormNet


class ThetaPosteriorFlowNet(_YNormNet):
    """q(theta|y) as a conditional affine-coupling flow.

    ``forward(y (B, d_y), e (ne, d)) -> (theta (B, ne, d), logq (B, ne))``,
    the exact log-density of each sample under q(.|y_b). ``base(y) -> (mu,
    log_sig)`` are the mean-field base heads. ``couplings[k]`` is flax's
    ``couplings_<k>``.
    """

    def __init__(self, y_dim: int = 2, hidden: int = 20, n_layers: int = 3, theta_dim: int = 2,
                 *, n_couplings: int = 4, s_cap: float = 3.0, dtype=torch.float64, device=None,
                 y_shift=None, y_scale=None):
        super().__init__()
        if theta_dim < 2:
            raise ValueError(
                "the coupling split needs theta_dim >= 2; for a scalar theta the Gaussian "
                "families are already exact up to a monotone 1-D map")
        kw = dict(dtype=dtype, device=device)
        self.theta_dim = theta_dim
        self.s_cap = float(s_cap)
        self.theta_mean_net = MLP(y_dim, hidden, n_layers, theta_dim, **kw)
        self.theta_sig_net = MLP(y_dim, hidden, n_layers, theta_dim, **kw)
        self.couplings = nn.ModuleList(
            MLP(theta_dim + y_dim, hidden, n_layers, 2 * theta_dim, zero_head=True, **kw)
            for _ in range(n_couplings))
        self._register_y_norm(y_shift, y_scale, dtype, device)
        idx = torch.arange(theta_dim)
        masks = torch.stack([((idx + k) % 2 == 0) for k in range(n_couplings)]).to(dtype)
        self.register_buffer("masks", masks.to(device), persistent=False)  # active dims

    def base(self, y):
        y = self.normalize(y)
        return self.theta_mean_net(y), self.theta_sig_net(y)

    def forward(self, y, e):
        mu, log_sig = self.base(y)
        d = self.theta_dim
        B, ne = mu.shape[0], e.shape[0]
        theta = mu[:, None, :] + torch.exp(0.5 * log_sig)[:, None, :] * e[None, :, :]
        logq = (
            -0.5 * d * math.log(2.0 * math.pi)
            - 0.5 * torch.sum(e**2, dim=-1)[None, :]
            - 0.5 * torch.sum(log_sig, dim=-1)[:, None]
        )
        yn = self.normalize(y)
        yb = yn[:, None, :].expand(B, ne, yn.shape[-1])
        for mask, net in zip(self.masks, self.couplings):
            st = net(torch.cat([theta * mask, yb], dim=-1))
            s = self.s_cap * torch.tanh(st[..., :d] / self.s_cap) * (1.0 - mask)
            t = st[..., d:] * (1.0 - mask)
            theta = theta * torch.exp(s) + t
            logq = logq - torch.sum(s, dim=-1)
        return theta, logq


def flow_moments(net: ThetaPosteriorFlowNet, y, generator: torch.Generator, n_mc: int = 256):
    """Monte-Carlo posterior moments of the flow, (mean (B, d), var (B, d)),
    from ``n_mc`` base draws of ``generator``: the flow has no closed-form
    moments."""
    p = net.theta_mean_net.layers[0].weight
    y = torch.as_tensor(y, dtype=p.dtype, device=p.device)
    e = draw_normal(generator, (n_mc, net.theta_dim), p.dtype, p.device)
    with torch.no_grad():
        theta, _ = net(y, e)
    return theta.mean(dim=1), theta.var(dim=1, correction=0)
