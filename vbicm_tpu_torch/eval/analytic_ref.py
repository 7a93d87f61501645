"""Exact (quadrature) reference conditionals for the analytic cases 1-3
(counterpart of ``vbicm_tpu/eval/analytic_ref.py``).

The reference validates its analytic cases against curves that are partly
broken: its case-1 closed-form predictive variance drops the h'(theta)^2
factor (``src/postprocess_lib.py:118-119``: ``z_sig_ref = sig_eta +
1/(1 + 4/sig_e)`` for z = 3*theta, missing the factor 9), and its case-1
classical KLD pushes samples through the CASE-2 h_fun
(``src/postprocess_lib.py:225``). This module computes the real thing:
the 1-D forward maps admit deterministic dense-quadrature conditionals

    p(theta | y) propto N(y; f(theta), sig_e) N(theta; 0, 1)
    p(z | y)     = int N(z; h(theta), sig_eta) p(theta | y) dtheta

on a trapezoid theta-grid — exact to grid resolution, no MCMC/KDE noise.
Case 3 factorizes (f_i and h_i each depend on one coordinate), so its 2-D
conditionals are products of two 1-D quadratures. The forward maps are
``prob.analytic``'s torch functions (or any function of an array); the
quadrature runs in numpy on the host.
"""
from __future__ import annotations

import numpy as np
import torch


def _values(fun, t) -> np.ndarray:
    """``fun`` on the grid ``t`` as a numpy array: called with a CPU tensor,
    so torch and numpy maps both work."""
    out = fun(torch.as_tensor(t))
    return out.detach().cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)


def _norm_pdf(x, mean, var):
    return np.exp(-0.5 * (x - mean) ** 2 / var) / np.sqrt(2.0 * np.pi * var)


def posterior_weights_1d(y: float, f_fun, sig_e: float, theta_grid):
    """Normalized posterior density values on theta_grid (trapezoid)."""
    t = np.asarray(theta_grid)
    log_w = -0.5 * (y - _values(f_fun, t)) ** 2 / sig_e - 0.5 * t**2
    w = np.exp(log_w - log_w.max())
    w /= np.trapezoid(w, t)
    return w


def predictive_pdf_1d(y: float, f_fun, h_fun, sig_e: float, sig_eta: float,
                      theta_grid, z_grid):
    """p(z | y) on z_grid via dense theta quadrature."""
    t = np.asarray(theta_grid)
    w = posterior_weights_1d(y, f_fun, sig_e, t)
    h = _values(h_fun, t)
    pz = _norm_pdf(np.asarray(z_grid)[:, None], h[None, :], sig_eta)
    return np.trapezoid(pz * w[None, :], t, axis=1)


def predictive_moments_1d(y: float, f_fun, h_fun, sig_e: float, sig_eta: float,
                          theta_grid):
    """(mean, var) of z | y: E[h] and Var[h] + sig_eta by quadrature."""
    t = np.asarray(theta_grid)
    w = posterior_weights_1d(y, f_fun, sig_e, t)
    h = _values(h_fun, t)
    m = np.trapezoid(h * w, t)
    v = np.trapezoid((h - m) ** 2 * w, t) + sig_eta
    return float(m), float(v)


def posterior_moments_1d(y: float, f_fun, sig_e: float, theta_grid):
    """(mean, var) of theta | y by quadrature."""
    t = np.asarray(theta_grid)
    w = posterior_weights_1d(y, f_fun, sig_e, t)
    m = np.trapezoid(t * w, t)
    v = np.trapezoid((t - m) ** 2 * w, t)
    return float(m), float(v)


def kld_grid(p, q, x, floor: float = 1e-300):
    """KL(p || q) for densities sampled on grid x (trapezoid)."""
    p = np.maximum(np.asarray(p), floor)
    q = np.maximum(np.asarray(q), floor)
    return float(np.trapezoid(p * (np.log(p) - np.log(q)), np.asarray(x)))


def gaussian_pdf_grid(z_grid, mean: float, var: float):
    return _norm_pdf(np.asarray(z_grid), mean, var)


def lognormal_pdf_grid(z_grid, mu: float, sig2: float):
    """Lognormal density in z for log-z moments (mu, sig2)."""
    z = np.maximum(np.asarray(z_grid), 1e-300)
    return _norm_pdf(np.log(z), mu, sig2) / z


def kld_gaussian_exact(m0, v0, m1, v1):
    """KL(N(m0,v0) || N(m1,v1)) closed form."""
    return float(0.5 * (np.log(v1 / v0) + (v0 + (m0 - m1) ** 2) / v1 - 1.0))
