"""Closed-form toy forward maps for 1-D and 2-D validation cases
(counterpart of ``vbicm_tpu/prob/analytic.py``).

The reference's cheap fixtures: case 1 (linear), case 2 (quadratic
observation, exponential prediction), case 3 (2-D). They exercise the VI
machinery without a FEM solve. The maps take and return torch tensors; the
datasets draw from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .datagen import MeasurementDataset


def h_fun_1d_case1(theta):
    return 3.0 * theta


def f_fun_1d_case1(theta):
    return 2.0 * theta


def h_fun_1d_case2(theta):
    return torch.exp(theta) + 0.2


def f_fun_1d_case2(theta):
    return 2.0 * theta**2 + 2.0


def f_fun_2d_case3(x):
    f1 = 2.0 * x[..., 0] ** 2 + 2.0
    f2 = x[..., 1] ** 4 + x[..., 1] + 1.0
    return torch.stack([f1, f2], dim=-1)


def h_fun_2d_case3(x):
    h1 = torch.exp(x[..., 0]) + 0.2
    h2 = torch.exp(x[..., 1]) + 0.1
    return torch.stack([h1, h2], dim=-1)


def generate_data_1d(generator: torch.Generator, n_sam: int, sig_e: float, sig_eta: float,
                     dtype=torch.float64):
    """1-D linear case: (y, z, theta), each (n_sam, 1) on the CPU."""
    theta = torch.randn((n_sam, 1), generator=generator, dtype=dtype)
    y = 2.0 * theta + math.sqrt(sig_e) * torch.randn((n_sam, 1), generator=generator, dtype=dtype)
    z = 3.0 * theta + math.sqrt(sig_eta) * torch.randn((n_sam, 1), generator=generator,
                                                       dtype=dtype)
    return y, z, theta


def _analytic_dataset(generator, f_fun, h_fun, n_sam, d_theta, sig_e, sig_eta, ne_sam,
                      dtype=torch.float64):
    """theta ~ N(0, I), y = f + e, z = h + eta, and the fixed
    reparameterization seeds e_data, drawn in that order from
    ``generator``; nonpositive z is clamped to the least positive one."""
    theta = torch.randn((n_sam, d_theta), generator=generator, dtype=dtype)
    f, h = f_fun(theta), h_fun(theta)
    y = (f + math.sqrt(sig_e) * torch.randn(f.shape, generator=generator, dtype=dtype)).numpy()
    z = (h + math.sqrt(sig_eta) * torch.randn(h.shape, generator=generator, dtype=dtype)).numpy()
    if (z <= 0.0).any():
        floor = float(z[z > 0.0].min()) if (z > 0.0).any() else 1e-12
        z = np.where(z > 0.0, z, floor)
    e_data = torch.randn((ne_sam, d_theta), generator=generator, dtype=dtype).numpy()
    return MeasurementDataset(
        y_data=y,
        z_data=z,
        log_z_data=np.log(z),
        e_data=e_data,
        y_mean=y.mean(axis=0, keepdims=True),
        y_std=y.std(axis=0, keepdims=True),
        z_mean=z.mean(axis=0, keepdims=True),
        z_std=z.std(axis=0, keepdims=True),
        theta_data=theta.numpy(),
    )


def generate_data_1d_case2(generator: torch.Generator, n_sam: int, *, sig_e: float = 0.1,
                           sig_eta: float = 3e-3, ne_sam: int = 4):
    """1-D case-2 dataset: quadratic observation, exponential prediction."""
    return _analytic_dataset(generator, f_fun_1d_case2, h_fun_1d_case2, n_sam, 1, sig_e,
                             sig_eta, ne_sam)


def generate_data_2d_case3(generator: torch.Generator, n_sam: int, *, sig_e: float = 0.1,
                           sig_eta: float = 3e-3, ne_sam: int = 4):
    """2-D case-3 dataset: f = (2 x1^2 + 2, x2^4 + x2 + 1),
    h = (e^x1 + 0.2, e^x2 + 0.1)."""
    return _analytic_dataset(generator, f_fun_2d_case3, h_fun_2d_case3, n_sam, 2, sig_e,
                             sig_eta, ne_sam)
