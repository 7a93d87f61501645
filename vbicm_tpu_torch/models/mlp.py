"""Inference / predictive networks (counterpart of ``vbicm_tpu/models/mlp.py``).

Four MLPs of ``n_layers`` hidden ReLU layers of width ``hidden``, grouped as
the posterior pair q(theta|y) -> (theta_mean, theta_sig, log_theta_sig) and
the lognormal predictive pair p(z|y) -> (z_mean, z_sig, log_z_sig); the
``*_sig`` outputs are variances, exp of the log head. The full-covariance
posterior adds a third MLP for the strictly-lower Cholesky entries
(``ThetaPosteriorFullCovNet``); the flow posterior is ``models.flow``.
Initialization is Keras's Dense default (glorot-uniform weights, zero
biases), drawn from an explicit ``torch.Generator``. ``y_shift``/``y_scale``
bake a frozen input standardization ``(y - shift) / scale`` into a net as
constants (buffers, not parameters); ``None`` leaves the input as it is.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn


class MLP(nn.Module):
    """Dense ReLU stack with a linear head. ``layers[i]`` is flax's
    ``Dense_i``. ``zero_head=True`` initializes the head's weight to zero
    (the trunk keeps its glorot init): the full-covariance off-diagonal head
    and the flow's couplings start as zero maps."""

    def __init__(self, in_dim: int, hidden: int = 20, n_layers: int = 3, out_dim: int = 2,
                 *, dtype=torch.float64, device=None, zero_head: bool = False):
        super().__init__()
        self.zero_head = zero_head
        widths = [in_dim] + [hidden] * n_layers + [out_dim]
        self.layers = nn.ModuleList(
            nn.Linear(i, o, dtype=dtype, device=device) for i, o in zip(widths[:-1], widths[1:])
        )

    def reset_parameters(self, generator: torch.Generator):
        """Glorot-uniform weights and zero biases, drawn from ``generator``
        (a CPU generator, so a seed gives the same weights on every device)."""
        with torch.no_grad():
            for layer in self.layers:
                layer.bias.zero_()
                if self.zero_head and layer is self.layers[-1]:
                    layer.weight.zero_()
                    continue
                fan_out, fan_in = layer.weight.shape
                limit = math.sqrt(6.0 / (fan_in + fan_out))
                w = torch.empty(layer.weight.shape, dtype=layer.weight.dtype)
                w.uniform_(-limit, limit, generator=generator)
                layer.weight.copy_(w)

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return self.layers[-1](x)


class _YNormNet(nn.Module):
    """A net of MLP children on a frozen-standardized input y."""

    def _register_y_norm(self, y_shift, y_scale, dtype, device):
        for name, v in (("y_shift", y_shift), ("y_scale", y_scale)):
            v = None if v is None else torch.tensor(v, dtype=dtype, device=device)
            self.register_buffer(name, v)

    def normalize(self, y):
        if self.y_shift is None:
            return y
        return (y - self.y_shift) / self.y_scale

    def reset_parameters(self, generator: torch.Generator):
        """Every MLP, in registration order, from ``generator``."""
        for mlp in self.modules():
            if isinstance(mlp, MLP):
                mlp.reset_parameters(generator)


class _PairNet(_YNormNet):
    """Two MLPs on the same input: a mean head and a log-variance head."""

    _names: tuple = ()

    def __init__(self, y_dim, hidden, n_layers, out_dim, *, dtype, device, y_shift, y_scale):
        super().__init__()
        for name in self._names:
            self.add_module(name, MLP(y_dim, hidden, n_layers, out_dim, dtype=dtype, device=device))
        self._register_y_norm(y_shift, y_scale, dtype, device)

    def forward(self, y):
        y = self.normalize(y)
        mean_net, sig_net = (getattr(self, name) for name in self._names)
        log_sig = sig_net(y)
        return mean_net(y), torch.exp(log_sig), log_sig


class ThetaPosteriorNet(_PairNet):
    """q(theta|y): returns (theta_mean, theta_sig, log_theta_sig)."""

    _names = ("theta_mean_net", "theta_sig_net")

    def __init__(self, y_dim: int = 2, hidden: int = 20, n_layers: int = 3, theta_dim: int = 2,
                 *, dtype=torch.float64, device=None, y_shift=None, y_scale=None):
        super().__init__(y_dim, hidden, n_layers, theta_dim, dtype=dtype, device=device,
                         y_shift=y_shift, y_scale=y_scale)


class ThetaPosteriorFullCovNet(_YNormNet):
    """q(theta|y) = N(mu(y), L(y) L(y)^T): returns (theta_mean, L, log_diag).

    L's diagonal is exp(0.5 * log_diag), the mean-field head's squared-scale
    parameterization; the strictly-lower entries come from a zero-head MLP,
    so the net starts as the mean-field posterior and learns correlations
    only as the data demand them."""

    def __init__(self, y_dim: int = 2, hidden: int = 20, n_layers: int = 3, theta_dim: int = 2,
                 *, dtype=torch.float64, device=None, y_shift=None, y_scale=None):
        super().__init__()
        self.theta_dim = d = theta_dim
        kw = dict(dtype=dtype, device=device)
        self.theta_mean_net = MLP(y_dim, hidden, n_layers, d, **kw)
        self.theta_sig_net = MLP(y_dim, hidden, n_layers, d, **kw)
        self.theta_offdiag_net = MLP(y_dim, hidden, n_layers, d * (d - 1) // 2, zero_head=True,
                                     **kw)
        self._register_y_norm(y_shift, y_scale, dtype, device)
        il, jl = torch.tril_indices(d, d, -1)
        self.register_buffer("offdiag_index", (il * d + jl).to(device), persistent=False)

    def forward(self, y):
        y = self.normalize(y)
        d = self.theta_dim
        theta_mean = self.theta_mean_net(y)
        log_diag = self.theta_sig_net(y)
        off = self.theta_offdiag_net(y)
        L_off = off.new_zeros((*off.shape[:-1], d * d))
        L_off[..., self.offdiag_index] = off
        L = L_off.reshape(*off.shape[:-1], d, d) + torch.diag_embed(torch.exp(0.5 * log_diag))
        return theta_mean, L, log_diag


def marginal_variance(L):
    """Per-dim marginal variances diag(L L^T) of the full-covariance q."""
    return torch.sum(L**2, dim=-1)


class ZPredictiveNet(_PairNet):
    """p(z|y) lognormal: returns (z_mean, z_sig, log_z_sig)."""

    _names = ("z_mean_net", "z_sig_net")

    def __init__(self, y_dim: int = 2, hidden: int = 20, n_layers: int = 3, z_dim: int = 2,
                 *, dtype=torch.float64, device=None, y_shift=None, y_scale=None):
        super().__init__(y_dim, hidden, n_layers, z_dim, dtype=dtype, device=device,
                         y_shift=y_shift, y_scale=y_scale)


def init_vi_networks(generator: torch.Generator, y_dim=2, theta_dim=2, z_dim=2, hidden=20,
                     n_layers1=3, n_layers2=3, *, dtype=torch.float64, device):
    """Build and initialize both nets on ``device``; returns (theta_net, z_net)."""
    theta_net = ThetaPosteriorNet(y_dim, hidden, n_layers1, theta_dim, dtype=dtype, device=device)
    z_net = ZPredictiveNet(y_dim, hidden, n_layers2, z_dim, dtype=dtype, device=device)
    theta_net.reset_parameters(generator)
    z_net.reset_parameters(generator)
    return theta_net, z_net


def _flax_named_mlps(module: nn.Module):
    """(flax name, MLP) of each MLP child: its attribute name, or
    ``<name>_<i>`` for the i-th MLP of a ``ModuleList`` (flax's name for a
    list of submodules assigned in ``setup``)."""
    for name, child in module.named_children():
        if isinstance(child, nn.ModuleList):
            for i, sub in enumerate(child):
                yield f"{name}_{i}", sub
        else:
            yield name, child


def load_flax_params(module: nn.Module, params) -> nn.Module:
    """Copy a flax parameter tree onto ``module`` in place and return it.

    ``params`` is the tree flax's ``init`` returns, as nested dicts of numpy
    arrays: ``params["params"][net_name]["Dense_<i>"]["kernel" | "bias"]``,
    with the flow's couplings under ``couplings_<k>``. Flax keeps a Dense
    kernel as (in, out); ``nn.Linear`` keeps (out, in).
    """
    tree = params["params"] if "params" in params else params
    with torch.no_grad():
        for net_name, net in _flax_named_mlps(module):
            dense = tree[net_name]
            if len(dense) != len(net.layers):
                raise ValueError(f"{net_name}: {len(dense)} flax layers, {len(net.layers)} here")
            for i, layer in enumerate(net.layers):
                kernel = np.asarray(dense[f"Dense_{i}"]["kernel"])
                bias = np.asarray(dense[f"Dense_{i}"]["bias"])
                if kernel.T.shape != tuple(layer.weight.shape):
                    raise ValueError(f"{net_name}/Dense_{i}: kernel {kernel.shape} does not fit "
                                     f"weight {tuple(layer.weight.shape)}")
                layer.weight.copy_(torch.tensor(kernel.T))
                layer.bias.copy_(torch.tensor(bias))
    return module
