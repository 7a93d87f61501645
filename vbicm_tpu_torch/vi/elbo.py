"""ELBO terms for the two-step amortized VI scheme (counterpart of
``vbicm_tpu/vi/elbo.py``) for the three posterior families: mean-field,
full-covariance (q = N(mu, L L^T)) and the normalizing flow
(``models.flow``).

  step 1, q(theta|y):        loss = term1 - term2 - term3
  step 2, p(z|y) lognormal:  loss = alpha*(term4 - term5) + moment_match_loss

``sig_e`` / ``sig_eta`` are noise variances; ``e_data`` are the fixed
reparameterization seeds shared between data generation and training.
``pairing="cross"`` scores every y of the batch against every FEM sample of
the batch, a (B, B*ne) pair matrix (the reference's broadcast);
``pairing="per_sample"`` scores each y against its own ne samples.
"""
from __future__ import annotations

import math

import torch


def term1(log_theta_sig):
    """Entropy-like term of q(theta|y)."""
    d = log_theta_sig.shape[-1]
    return (
        -0.5 * torch.mean(torch.sum(log_theta_sig, dim=-1), dim=0)
        - 0.5 * d * math.log(2.0 * math.pi)
        - 0.5 * d
    )


def reparameterize(theta_mean, theta_sig, e_data, log_theta_sig=None):
    """theta samples via fixed seeds: (B, d), (B, d), (ne, d) -> (B*ne, d),
    observation-major. With ``log_theta_sig`` the std is
    ``exp(0.5 * log_sig)``, the same value as ``sqrt(exp(log_sig))`` with a
    chain rule that stays finite when ``exp(log_sig)`` underflows to 0."""
    if log_theta_sig is not None:
        theta_std = torch.exp(0.5 * log_theta_sig)[:, None, :]
    else:
        theta_std = torch.sqrt(theta_sig)[:, None, :]
    theta = e_data[None, :, :] * theta_std + theta_mean[:, None, :]
    return theta.reshape(-1, theta.shape[-1])


def _pair(obs, samples, ne, pairing):
    """(B, 1, d) observations against (1, B*ne, d) or (B, ne, d) samples."""
    if pairing == "cross":
        return obs[:, None, :], samples[None, :, :]
    if pairing == "per_sample":
        return obs[:, None, :], samples.reshape(obs.shape[0], ne, samples.shape[-1])
    raise ValueError(f"unknown pairing {pairing!r}")


def term2(y, theta_mean, theta_sig, e_data, batch_f, sig_e, pairing="cross",
          log_theta_sig=None):
    """MC estimate of E_q[log p(y|theta)] with the FEM inside.

    batch_f: thetas (N, d_theta) -> f (N, d_y) (first output of fh).
    """
    d_y = y.shape[-1]
    theta_data = reparameterize(theta_mean, theta_sig, e_data, log_theta_sig)
    f_data = batch_f(theta_data)  # (B*ne, d_y)
    l1 = -0.5 * d_y * math.log(2.0 * math.pi * sig_e)
    yy, ff = _pair(y, f_data, e_data.shape[0], pairing)
    l2 = -0.5 / sig_e * torch.sum((yy - ff) ** 2, dim=-1)
    return l1 + torch.mean(l2)


def term3(theta_mean, theta_sig):
    """Cross-entropy to the N(0, I) prior."""
    d = theta_mean.shape[-1]
    return -0.5 * d * math.log(2.0 * math.pi) - 0.5 * torch.mean(
        torch.sum(theta_sig + theta_mean**2, dim=-1), dim=0
    )


def make_loss_step1(batch_f, e_data, sig_e, pairing="cross"):
    """``loss(y, (theta_mean, theta_sig, log_theta_sig)[, e])`` for step 1.
    ``e`` (same (ne, d) shape) overrides the closed-over fixed seeds for
    one evaluation: fresh reparameterization noise."""

    def loss(y, outputs, e=None):
        e = e_data if e is None else e
        theta_mean, theta_sig, log_theta_sig = outputs
        t1 = term1(log_theta_sig)
        t2 = term2(y, theta_mean, theta_sig, e, batch_f, sig_e, pairing,
                   log_theta_sig=log_theta_sig)
        t3 = term3(theta_mean, theta_sig)
        return t1 - t2 - t3

    return loss


# ---------------------------------------------------------------------------
# Full-covariance posterior, q = N(mu, L L^T)
# ---------------------------------------------------------------------------


def reparameterize_fullcov(theta_mean, L, e_data):
    """theta = mu + L e with a per-observation Cholesky factor:
    (B, d), (B, d, d), (ne, d) -> (B*ne, d), observation-major."""
    theta = theta_mean[:, None, :] + torch.einsum("bij,nj->bni", L, e_data)
    return theta.reshape(-1, theta.shape[-1])


def term1_fullcov(log_diag):
    """-entropy of q = N(mu, L L^T), with log L_ii = 0.5 * log_diag (the
    squared diagonal is parameterized, as the mean-field head's variance)."""
    d = log_diag.shape[-1]
    return (
        -0.5 * torch.mean(torch.sum(log_diag, dim=-1), dim=0)
        - 0.5 * d * math.log(2.0 * math.pi)
        - 0.5 * d
    )


def term3_fullcov(theta_mean, L):
    """Cross-entropy to the N(0, I) prior: E[theta^T theta] =
    tr(L L^T) + |mu|^2 = sum L^2 + |mu|^2."""
    d = theta_mean.shape[-1]
    return -0.5 * d * math.log(2.0 * math.pi) - 0.5 * torch.mean(
        torch.sum(L**2, dim=(-2, -1)) + torch.sum(theta_mean**2, dim=-1), dim=0
    )


def make_loss_step1_fullcov(batch_f, e_data, sig_e):
    """``loss(y, (theta_mean, L, log_diag)[, e])``, the step-1 loss of the
    full-covariance posterior. Per-observation pairing only."""

    def loss(y, outputs, e=None):
        e = e_data if e is None else e
        theta_mean, L, log_diag = outputs
        d_y = y.shape[-1]
        ne = e.shape[0]
        f_data = batch_f(reparameterize_fullcov(theta_mean, L, e))
        f_r = f_data.reshape(y.shape[0], ne, d_y)
        l2 = -0.5 / sig_e * torch.sum((y[:, None, :] - f_r) ** 2, dim=-1)
        t2 = -0.5 * d_y * math.log(2.0 * math.pi * sig_e) + torch.mean(l2)
        return term1_fullcov(log_diag) - t2 - term3_fullcov(theta_mean, L)

    return loss


# ---------------------------------------------------------------------------
# Normalizing-flow posterior (models.flow.ThetaPosteriorFlowNet)
# ---------------------------------------------------------------------------


def make_loss_step1_flow(batch_f, sig_e):
    """``loss(y, (theta, logq)[, e])``, the step-1 loss of the flow
    posterior: theta (B, ne, d) and logq (B, ne) from the flow net, which
    takes the base draws itself (``e`` is accepted and unused).

    loss = E_q[log q(theta|y) - log p(y|theta) - log p(theta)], the objective
    of term1 - term2 - term3 with every term a per-sample Monte-Carlo
    average. Per-observation pairing only.
    """

    def loss(y, outputs, e=None):
        theta, logq = outputs
        B, ne, d = theta.shape
        d_y = y.shape[-1]
        f = batch_f(theta.reshape(-1, d)).reshape(B, ne, d_y)
        loglik = -0.5 * d_y * math.log(2.0 * math.pi * sig_e) - 0.5 / sig_e * torch.sum(
            (y[:, None, :] - f) ** 2, dim=-1)
        logprior = -0.5 * d * math.log(2.0 * math.pi) - 0.5 * torch.sum(theta**2, dim=-1)
        return torch.mean(logq - loglik - logprior)

    return loss


def term4(z_mean, log_z_sig):
    """Lognormal-entropy term."""
    d = z_mean.shape[-1]
    loss = -0.5 * torch.sum(log_z_sig, dim=-1) - torch.sum(z_mean, dim=-1)
    return torch.mean(loss) - 0.5 * d * math.log(2.0 * math.pi) - 0.5 * d


def term5(theta_mean, theta_sig, z_mean, z_sig, e_data, batch_h, sig_eta, pairing="cross",
          fullcov=False, theta_data=None):
    """E[log p(z|theta)] via lognormal moment identities.

    batch_h: thetas (N, d_theta) -> h (N, d_z) (second output of fh).
    ``fullcov=True``: ``theta_sig`` is the (B, d, d) Cholesky factor.
    ``theta_data`` (B*ne, d), already drawn, replaces the draws (the flow).
    """
    d_z = z_mean.shape[-1]
    if theta_data is None:
        if fullcov:
            theta_data = reparameterize_fullcov(theta_mean, theta_sig, e_data)
        else:
            theta_data = reparameterize(theta_mean, theta_sig, e_data)
    h_data = batch_h(theta_data)  # (B*ne, d_z)
    zm = z_mean[:, None, :]
    zs = z_sig[:, None, :]
    l1 = -0.5 / sig_eta * torch.sum(torch.exp(2.0 * zm + 2.0 * zs), dim=-1)  # (B, 1)
    _, h = _pair(z_mean, h_data, e_data.shape[0], pairing)
    l2 = -0.5 / sig_eta * torch.sum(-2.0 * h * torch.exp(zm + 0.5 * zs) + h**2, dim=-1)
    l3 = -0.5 * d_z * math.log(2.0 * math.pi * sig_eta)
    return torch.mean(l1 + l2) + l3


def moment_match_loss(z_mean, z_sig, logz_mean_post, logz_sig_post):
    """MSE anchoring to the cached posterior log-z moments."""
    return torch.mean((z_mean - logz_mean_post) ** 2) + torch.mean(
        (z_sig - logz_sig_post) ** 2
    )


def make_loss_step2(batch_h, e_data, sig_eta, alpha, pairing="cross", fullcov=False,
                    flow=False):
    """``loss((y, logz_mean_post, logz_sig_post), outputs[, e])`` for step 2,
    outputs = (theta_mean, theta_sig, z_mean, z_sig, log_z_sig); ``e``
    overrides the fixed seeds for one evaluation. ``fullcov=True``: the
    ``theta_sig`` slot is the posterior's (B, d, d) Cholesky factor.
    ``flow=True``: outputs = (theta_data, z_mean, z_sig, log_z_sig) with the
    flow's (B*ne, d) samples, drawn in the net; per-observation pairing
    only."""
    if flow and pairing != "per_sample":
        raise ValueError('flow step-2 loss requires pairing="per_sample"')

    def loss(batch, outputs, e=None):
        e = e_data if e is None else e
        _, logz_mean_post, logz_sig_post = batch
        if flow:
            theta_data, z_mean, z_sig, log_z_sig = outputs
            theta_mean = theta_sig = None
        else:
            theta_mean, theta_sig, z_mean, z_sig, log_z_sig = outputs
            theta_data = None
        mm = moment_match_loss(z_mean, z_sig, logz_mean_post, logz_sig_post)
        if alpha == 0.0:
            # terms 4/5 can overflow where h spans decades; 0 * inf would
            # poison the pure moment-matching loss
            return mm
        t4 = term4(z_mean, log_z_sig)
        t5 = term5(theta_mean, theta_sig, z_mean, z_sig, e, batch_h, sig_eta, pairing,
                   fullcov=fullcov, theta_data=theta_data)
        return (t4 - t5) * alpha + mm

    return loss
