"""Proposed-vs-classical-vs-reference comparison (counterpart of
``vbicm_tpu/eval/comparison.py``).

Three predictive models of p(z|y) are compared:

  * **proposed**: the amortized lognormal net p(z|y) of the two-step
    training (closed-form density);
  * **classical**: a one-step q(theta|y) whose z-prediction is Monte
    Carlo: theta ~ q, pushed through the FEM, plus eta, then a KDE;
  * **reference**: the Monte-Carlo predictive through the proposed
    posterior, theta ~ q_proposed(theta|y), z = h(theta) + eta, computed
    for real (the reference codebase scales the proposed output by 1.015
    instead).

The FEM pushes run batched on the observation operator's device, in
chunks; the KDE and density bookkeeping stays on the host in numpy and
scipy, as in the JAX package. Random draws come from the caller's
``torch.Generator``, in a fixed order a function documents.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch
from scipy import stats

from ..utils.draws import draw_normal

# ----------------------------------------------------------------------
# sample generation (the FEM pushes, batched on the device)
# ----------------------------------------------------------------------


def _on(x, device):
    """``x`` as a float64 tensor: a tensor stays where it is, an array goes
    to ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64)
    return torch.as_tensor(np.asarray(x), dtype=torch.float64, device=device)


def _host(x) -> np.ndarray:
    """``x`` (a tensor on any device, or an array) as a numpy array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def mc_z_samples(generator, batch_h: Callable, theta_mean, theta_sig, sig_eta: float,
                 num_sam: int, *, chunk: int = 8192, device=None) -> np.ndarray:
    """z-samples of the MC predictive: theta ~ N(mean, sig) per y, z = h + eta.

    theta_mean/theta_sig: (n_y, d_theta), tensors or arrays placed on
    ``device``. Returns (n_y, num_sam, d_z). One (num_sam, d_z) eta matrix
    is shared by every y (the reference's convention). Draws, in order: the
    theta noise (n_y, num_sam, d_theta), then eta; ``generator=None`` is a
    CPU generator seeded 0.
    """
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    tm, ts = _on(theta_mean, device), _on(theta_sig, device)
    n_y, d_th = tm.shape
    eps = draw_normal(generator, (n_y, num_sam, d_th), torch.float64, tm.device)
    theta = tm[:, None, :] + eps * torch.sqrt(ts[:, None, :])
    return mc_z_samples_theta(generator, batch_h, theta, sig_eta, chunk=chunk)


def mc_z_samples_theta(generator, batch_h: Callable, theta_sam, sig_eta: float, *,
                       chunk: int = 8192, device=None) -> np.ndarray:
    """Push pre-drawn posterior samples ``theta_sam (n_y, num_sam, d_theta)``
    through the FEM (``batch_h``, in chunks of ``chunk`` thetas, without
    autograd) and add the shared-eta observation noise: the route by which
    any posterior family (``TwoStepTrainer.sample_theta``) enters the
    comparison. Returns (n_y, num_sam, d_z)."""
    theta = _on(theta_sam, device).detach()
    n_y, num_sam, d_th = theta.shape
    flat = theta.reshape(-1, d_th)
    with torch.no_grad():
        h = torch.cat([batch_h(flat[i:i + chunk]) for i in range(0, flat.shape[0], chunk)])
    h = h.to(torch.float64).reshape(n_y, num_sam, -1)
    eta = math.sqrt(sig_eta) * draw_normal(generator, (num_sam, h.shape[-1]), torch.float64,
                                           h.device)
    return (h + eta[None, :, :]).cpu().numpy()


# ----------------------------------------------------------------------
# densities on a z-grid (pdf overlays)
# ----------------------------------------------------------------------


class GridDensity(NamedTuple):
    z_grid: np.ndarray  # (npts*npts, 2) evaluation points
    xg: np.ndarray  # (npts, npts)
    yg: np.ndarray
    pdf: np.ndarray  # (npts, npts)


def classical_grid_density(z_sam: np.ndarray, mf: float, num_points: int) -> GridDensity:
    """KDE of MC z-samples on a mean +/- mf*std grid."""
    z_mu, z_std = z_sam.mean(axis=0), z_sam.std(axis=0)
    xv = np.linspace(z_mu[0] - mf * z_std[0], z_mu[0] + mf * z_std[0], num_points)
    yv = np.linspace(z_mu[1] - mf * z_std[1], z_mu[1] + mf * z_std[1], num_points)
    xg, yg = np.meshgrid(xv, yv)
    pts = np.stack([xg.ravel(), yg.ravel()], axis=1)
    pdf = stats.gaussian_kde(z_sam.T)(pts.T).reshape(num_points, num_points)
    return GridDensity(pts, xg, yg, pdf)


def proposed_grid_density(z_mean, z_sig, mf: float, num_points: int) -> GridDensity:
    """Closed-form lognormal predictive on a moment-matched grid."""
    z_mean = np.asarray(z_mean).ravel()
    z_sig = np.asarray(z_sig).ravel()
    mean_ln = np.exp(0.5 * z_sig + z_mean)
    std_ln = mean_ln * np.sqrt(np.exp(z_sig) - 1.0)
    xv = np.linspace(mean_ln[0] - mf * std_ln[0], mean_ln[0] + mf * std_ln[0], num_points)
    yv = np.linspace(mean_ln[1] - mf * std_ln[1], mean_ln[1] + mf * std_ln[1], num_points)
    xg, yg = np.meshgrid(xv, yv)
    pts = np.stack([xg.ravel(), yg.ravel()], axis=1)
    pdf = (
        stats.lognorm.pdf(pts[:, 0], s=np.sqrt(z_sig[0]), scale=np.exp(z_mean[0]))
        * stats.lognorm.pdf(pts[:, 1], s=np.sqrt(z_sig[1]), scale=np.exp(z_mean[1]))
    ).reshape(num_points, num_points)
    return GridDensity(pts, xg, yg, pdf)


def kde_on_grid(z_sam: np.ndarray, grid: GridDensity) -> np.ndarray:
    """Evaluate a sample KDE on another GridDensity's points."""
    return stats.gaussian_kde(z_sam.T)(grid.z_grid.T).reshape(grid.pdf.shape)


# ----------------------------------------------------------------------
# conditional-KLD maps over a y-grid
# ----------------------------------------------------------------------


def y_grid(y_mean, y_sig, mf: float, num_points: int):
    """The floor'd mean +/- mf*std y-grid: (points (n*n, 2), g1, g2)."""
    y_mean = np.asarray(y_mean).ravel()
    y_sig = np.asarray(y_sig).ravel()
    y1 = np.linspace(
        np.floor(y_mean[0] - mf * np.sqrt(y_sig[0])),
        np.floor(y_mean[0] + mf * np.sqrt(y_sig[0])),
        num_points,
    )
    y2 = np.linspace(
        np.floor(y_mean[1] - mf * np.sqrt(y_sig[1])),
        np.floor(y_mean[1] + mf * np.sqrt(y_sig[1])),
        num_points,
    )
    g1, g2 = np.meshgrid(y1, y2)
    return np.stack([g1.ravel(), g2.ravel()], axis=1), g1, g2


def kld_from_samples(y_data: np.ndarray, z_mean, z_sig, eps: np.ndarray, z_ref: np.ndarray,
                     z_cla: np.ndarray):
    """The KDE bookkeeping of :func:`kld_maps` on given draws: ``eps``
    (n_y, num_sam, 2) the proposed lognormal's standard-normal noise,
    ``z_ref`` and ``z_cla`` (n_y, num_sam, 2) the reference and classical
    z-samples. Returns (kld_proposed (n_y,), kld_classical (n_y,)).

    The reference conditional is a joint (y, z) KDE over all (y_i, sample)
    pairs divided by the y-marginal KDE, bw_method=1; the proposed
    conditional is the closed-form lognormal; the classical conditional is
    its own joint/marginal KDE; the KLD at a y is the mean over that y's
    samples of (log q - log ref), the classical one taken in absolute
    value, as the reference does."""
    zm_p, zs_p = np.asarray(z_mean), np.asarray(z_sig)
    n_y, num_sam = eps.shape[:2]
    zs_e, zm_e = zs_p[:, None, :], zm_p[:, None, :]
    log_z_vi = np.sqrt(zs_e) * eps + zm_e
    z_vi = np.exp(log_z_vi)
    log_cond_vi = (
        -0.5 * np.log(4.0 * np.pi**2 * np.prod(zs_e, axis=2))
        - np.sum(log_z_vi, axis=2)
        - 0.5 * np.sum((log_z_vi - zm_e) ** 2 / zs_e, axis=2)
    )
    y_rep = np.repeat(y_data, num_sam, axis=0)  # (n_y*num_sam, 2)
    yz_ref = np.concatenate([y_rep, z_ref.reshape(-1, 2)], axis=1)
    kde_joint_ref = stats.gaussian_kde(yz_ref.T, bw_method=1.0)
    kde_marg_ref = stats.gaussian_kde(y_rep.T, bw_method=1.0)
    log_marg_ref = kde_marg_ref.logpdf(y_rep.T)

    # proposed: E_q[log q - log ref]
    yz_vi = np.concatenate([y_rep, z_vi.reshape(-1, 2)], axis=1)
    log_cond_ref_at_vi = (kde_joint_ref.logpdf(yz_vi.T) - log_marg_ref).reshape(n_y, num_sam)
    kld_proposed = np.mean(log_cond_vi - log_cond_ref_at_vi, axis=1)

    # classical: its own joint/marginal KDE conditional against the reference
    yz_cla = np.concatenate([y_rep, z_cla.reshape(-1, 2)], axis=1)
    log_cond_q = (
        stats.gaussian_kde(yz_cla.T, bw_method=1.0).logpdf(yz_cla.T)
        - stats.gaussian_kde(y_rep.T, bw_method=1.0).logpdf(y_rep.T)
    ).reshape(n_y, num_sam)
    log_cond_ref_at_cla = (kde_joint_ref.logpdf(yz_cla.T) - log_marg_ref).reshape(n_y, num_sam)
    kld_classical = np.abs(np.mean(log_cond_q - log_cond_ref_at_cla, axis=1))
    return kld_proposed, kld_classical


def _reference_z(generator, batch_h, tm_p, tsg_p, sig_eta, num_sam, proposed_sampler, device):
    """z-samples through the proposed posterior: the Gaussian draws of
    (tm_p, tsg_p), or ``proposed_sampler(generator, num_sam)``'s."""
    if proposed_sampler is not None:
        return mc_z_samples_theta(generator, batch_h, proposed_sampler(generator, num_sam),
                                  sig_eta, device=device)
    return mc_z_samples(generator, batch_h, tm_p, tsg_p, sig_eta, num_sam, device=device)


def kld_maps(generator, batch_h: Callable, y_data: np.ndarray, proposed: tuple,
             classical: tuple, sig_eta: float, num_sam: int,
             proposed_sampler: Callable = None, *, device=None):
    """Both KLD maps against one shared reference KDE.

    proposed: (theta_mean, theta_sig, z_mean, z_sig) of the proposed model
    at y_data; classical: (theta_mean, theta_sig) of the one-step model;
    theta moments that are arrays go to ``device``, the FEM's. Returns
    (kld_proposed (n_y,), kld_classical (n_y,)), from
    :func:`kld_from_samples`.

    ``proposed_sampler(generator, num_sam) -> theta (n_y, num_sam, d)``
    replaces the Gaussian theta draws of the shared reference
    (``TwoStepTrainer.theta_sampler``). Draws, in order: the proposed
    lognormal's noise, the reference's, the classical's.
    """
    tm_p, tsg_p, zm_p, zs_p = proposed
    tm_c, tsg_c = classical
    zm_p, zs_p = _host(zm_p), _host(zs_p)
    eps = draw_normal(generator, (y_data.shape[0], num_sam, 2), torch.float64, "cpu").numpy()
    z_ref = _reference_z(generator, batch_h, tm_p, tsg_p, sig_eta, num_sam, proposed_sampler,
                         device)
    z_cla = mc_z_samples(generator, batch_h, tm_c, tsg_c, sig_eta, num_sam, device=device)
    return kld_from_samples(y_data, zm_p, zs_p, eps, z_ref, z_cla)


# ----------------------------------------------------------------------
# mean / variance fields
# ----------------------------------------------------------------------


def mean_sig_fields(generator, batch_h: Callable, proposed: tuple, classical: tuple,
                    sig_eta: float, num_sam: int, proposed_sampler: Callable = None, *,
                    device=None):
    """z mean/variance fields of the three models over a y-grid.

    Returns a dict with keys proposed/classical/reference, each a
    (z_mean (n_y, 2), z_sig (n_y, 2)) pair of arrays: the proposed model's
    closed-form lognormal moments, the classical model's Monte-Carlo
    moments through the FEM, and the reference's, Monte Carlo through the
    proposed posterior (``proposed_sampler`` as in :func:`kld_maps`).
    Draws, in order: the classical's, then the reference's.
    """
    tm_p, tsg_p, zm_p, zs_p = proposed
    tm_c, tsg_c = classical
    zm_p, zs_p = _host(zm_p), _host(zs_p)
    z_mean_prop = np.exp(0.5 * zs_p + zm_p)
    z_sig_prop = (np.exp(zs_p) - 1.0) * z_mean_prop**2

    z_cla = mc_z_samples(generator, batch_h, tm_c, tsg_c, sig_eta, num_sam, device=device)
    z_ref = _reference_z(generator, batch_h, tm_p, tsg_p, sig_eta, num_sam, proposed_sampler,
                         device)
    return {
        "proposed": (z_mean_prop, z_sig_prop),
        "classical": (z_cla.mean(axis=1), z_cla.var(axis=1)),
        "reference": (z_ref.mean(axis=1), z_ref.var(axis=1)),
    }


def relative_error_fields(fields: dict, tol: float = 1e-6):
    """|model - ref| / |ref| for mean and variance, zeroed where |ref| < tol."""
    zm_ref, zs_ref = fields["reference"]
    out = {}
    for name in ("proposed", "classical"):
        zm, zs = fields[name]
        em = np.abs((zm - zm_ref) / zm_ref)
        es = np.abs((zs - zs_ref) / zs_ref)
        em[np.abs(zm_ref) < tol] = 0.0
        es[np.abs(zs_ref) < tol] = 0.0
        out[name] = (em, es)
    return out
