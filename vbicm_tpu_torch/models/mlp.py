"""Inference / predictive networks (counterpart of ``vbicm_tpu/models/mlp.py``).

Four MLPs of ``n_layers`` hidden ReLU layers of width ``hidden``, grouped as
the posterior pair q(theta|y) -> (theta_mean, theta_sig, log_theta_sig) and
the lognormal predictive pair p(z|y) -> (z_mean, z_sig, log_z_sig); the
``*_sig`` outputs are variances, exp of the log head. Initialization is
Keras's Dense default (glorot-uniform weights, zero biases), drawn from an
explicit ``torch.Generator``. ``y_shift``/``y_scale`` bake a frozen input
standardization ``(y - shift) / scale`` into a pair net as constants (buffers,
not parameters); ``None`` leaves the input as it is.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn


class MLP(nn.Module):
    """Dense ReLU stack with a linear head. ``layers[i]`` is flax's
    ``Dense_i``."""

    def __init__(self, in_dim: int, hidden: int = 20, n_layers: int = 3, out_dim: int = 2,
                 *, dtype=torch.float64, device=None):
        super().__init__()
        widths = [in_dim] + [hidden] * n_layers + [out_dim]
        self.layers = nn.ModuleList(
            nn.Linear(i, o, dtype=dtype, device=device) for i, o in zip(widths[:-1], widths[1:])
        )

    def reset_parameters(self, generator: torch.Generator):
        """Glorot-uniform weights and zero biases, drawn from ``generator``
        (a CPU generator, so a seed gives the same weights on every device)."""
        with torch.no_grad():
            for layer in self.layers:
                fan_out, fan_in = layer.weight.shape
                limit = math.sqrt(6.0 / (fan_in + fan_out))
                w = torch.empty(layer.weight.shape, dtype=layer.weight.dtype)
                w.uniform_(-limit, limit, generator=generator)
                layer.weight.copy_(w)
                layer.bias.zero_()

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return self.layers[-1](x)


class _PairNet(nn.Module):
    """Two MLPs on the same input: a mean head and a log-variance head."""

    _names: tuple = ()

    def __init__(self, y_dim, hidden, n_layers, out_dim, *, dtype, device, y_shift, y_scale):
        super().__init__()
        for name in self._names:
            self.add_module(name, MLP(y_dim, hidden, n_layers, out_dim, dtype=dtype, device=device))
        for name, v in (("y_shift", y_shift), ("y_scale", y_scale)):
            v = None if v is None else torch.tensor(v, dtype=dtype, device=device)
            self.register_buffer(name, v)

    def reset_parameters(self, generator: torch.Generator):
        for name in self._names:
            getattr(self, name).reset_parameters(generator)

    def forward(self, y):
        if self.y_shift is not None:
            y = (y - self.y_shift) / self.y_scale
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


def load_flax_params(module: nn.Module, params) -> nn.Module:
    """Copy a flax parameter tree onto ``module`` in place and return it.

    ``params`` is the tree flax's ``init`` returns, as nested dicts of numpy
    arrays: ``params["params"][net_name]["Dense_<i>"]["kernel" | "bias"]``.
    Flax keeps a Dense kernel as (in, out); ``nn.Linear`` keeps (out, in).
    """
    tree = params["params"] if "params" in params else params
    with torch.no_grad():
        for net_name, net in module.named_children():
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
