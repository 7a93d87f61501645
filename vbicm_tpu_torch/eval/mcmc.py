"""MCMC reference posterior (counterpart of ``vbicm_tpu/eval/mcmc.py``).

The reference validates VI against a random-walk Metropolis chain over
theta, with log-posterior = Gaussian likelihood of y given the FEM f(theta)
plus an N(0, I) prior. Here many independent chains advance in lockstep:
every step is one batched FEM solve across the chains, through the port's
batched observation operator ``fh(thetas (C, d)) -> (y, h)``. Proposal
adaptation is per-chain Robbins-Monro on the log step size during burn-in
only (frozen after, so the kept samples are exact Metropolis); chain
quality is split-R-hat and bulk ESS.

Every random number of a run is drawn up front from the caller's
``torch.Generator`` (on the generator's device) and moved to the chains'
device in one copy, and the accepts are summed on the device: nothing in
the step loop reads back to the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from ..utils.draws import draw_normal, draw_uniform


@dataclasses.dataclass
class MetropolisResult:
    samples: np.ndarray  # (n_chains, n_kept, d)
    accept_rate: float
    step_size: Optional[np.ndarray] = None  # (n_chains,) final adapted scales
    ess: Optional[np.ndarray] = None  # (d,) bulk effective sample size
    rhat: Optional[np.ndarray] = None  # (d,) split-R-hat

    def mean_mcse(self) -> np.ndarray:
        """Monte-Carlo standard error of the posterior-mean estimate per
        dimension: sd / sqrt(ESS)."""
        flat = self.samples.reshape(-1, self.samples.shape[-1])
        return flat.std(axis=0, ddof=1) / np.sqrt(np.maximum(self.ess, 1.0))


def make_fem_logpost(fh: Callable, y_obs, sig_e: float) -> Callable:
    """Batched log p(theta | y) up to a constant: ``logpost(thetas (C, d))
    -> (C,)``, a Gaussian likelihood on f(theta) with variance ``sig_e``
    plus the standard-normal prior. ``fh`` is the batched observation
    operator; ``y_obs`` follows f's device and dtype. The chains are
    independent, so ``grad(logpost(q).sum(), q)`` is each chain's gradient."""
    y_obs = torch.as_tensor(y_obs).reshape(-1)
    cache = {}

    def logpost(theta):
        f, _ = fh(theta)
        key = (f.device, f.dtype)
        if key not in cache:
            cache[key] = y_obs.to(device=f.device, dtype=f.dtype)
        ll = -0.5 / sig_e * torch.sum((cache[key] - f) ** 2, dim=-1)
        lp = -0.5 * torch.sum(theta**2, dim=-1)
        return ll + lp

    return logpost


def _start(init, n_chains, d, device):
    """The chains' start, and so their device and dtype: ``init`` (C, d)
    where given (moved to ``device`` if that is given too), else float64
    zeros on ``device``."""
    if init is None:
        if device is None:
            raise ValueError("pass device= (or init=) to place the chains")
        return torch.zeros((n_chains, d), dtype=torch.float64, device=device)
    init = torch.as_tensor(init)
    return init.to(device=init.device if device is None else device,
                   dtype=init.dtype if init.is_floating_point() else torch.float64)


def _result(samples, accepts, n_counted, log_s):
    """MetropolisResult from the kept samples (n_kept, C, d) on the device
    and the device-side accept count: the one read-back of a run."""
    out = np.ascontiguousarray(samples.transpose(0, 1).cpu().numpy())
    ess, rhat = ess_rhat(out)
    return MetropolisResult(
        samples=out,
        accept_rate=float(accepts) / n_counted,
        step_size=torch.exp(log_s).cpu().numpy(),
        ess=ess,
        rhat=rhat,
    )


def metropolis(
    generator: torch.Generator,
    logpost: Callable,
    *,
    d: int = 2,
    n_samples: int = 5000,
    burn: int = 500,
    thin: int = 1,
    n_chains: int = 8,
    step_size: float = 0.5,
    init=None,
    adapt: bool = True,
    target_accept: float = 0.3,
    device=None,
) -> MetropolisResult:
    """Random-walk Metropolis, the chains batched, the steps a host loop.

    ``logpost(thetas (C, d)) -> (C,)``. ``adapt=True`` tunes a per-chain
    log step size toward ``target_accept`` during burn-in only
    (Robbins-Monro, gamma_t = (t+1)^-0.6); sampling steps use the frozen
    scales. Chains start at ``init`` (C, d) or at zeros on ``device``.
    Returns chains-major samples (C, n_samples, d) with split-R-hat and
    bulk ESS."""
    theta = _start(init, n_chains, d, device)
    device, dtype, C = theta.device, theta.dtype, theta.shape[0]
    n_steps = burn + n_samples * thin
    # the steps' draws, in one copy: proposals, then the accept uniforms
    z = draw_normal(generator, (n_steps, C, d), dtype, device)
    log_u = torch.log(draw_uniform(generator, (n_steps, C), dtype, device))
    samples = torch.empty((n_samples, C, d), dtype=dtype, device=device)
    accepts = torch.zeros((), dtype=torch.int64, device=device)
    log_s = torch.full((C,), math.log(step_size), dtype=dtype, device=device)
    with torch.no_grad():
        logp = logpost(theta)
        for t in range(n_steps):
            prop = theta + torch.exp(log_s)[:, None] * z[t]
            logp_prop = logpost(prop)
            log_ratio = logp_prop - logp
            accept = log_u[t] < log_ratio
            theta = torch.where(accept[:, None], prop, theta)
            logp = torch.where(accept, logp_prop, logp)
            if adapt and t < burn:
                alpha = torch.clamp(torch.exp(log_ratio), max=1.0)  # expected acceptance
                log_s = log_s + (t + 1.0) ** (-0.6) * (alpha - target_accept)
            if t >= burn:
                accepts += accept.sum()
                if (t - burn) % thin == 0:
                    samples[(t - burn) // thin] = theta
    return _result(samples, accepts, (n_steps - burn) * C, log_s)


def hmc(
    generator: torch.Generator,
    logpost: Callable,
    *,
    d: int = 2,
    n_samples: int = 2000,
    burn: int = 500,
    thin: int = 1,
    n_chains: int = 8,
    step_size: float = 0.2,
    n_leapfrog: int = 8,
    init=None,
    adapt: bool = True,
    target_accept: float = 0.75,
    device=None,
) -> MetropolisResult:
    """Hamiltonian Monte Carlo, the chains batched, the steps a host loop.

    The gradient of ``logpost`` runs through the FEM adjoint solve (one
    forward and one adjoint solve an evaluation), so each proposal follows
    the exact posterior gradient. Identity mass matrix; each step's size is
    the chain's adapted one jittered by U(2/3, 4/3), so eps * L never locks
    onto a period of the target. The leapfrog is merged: the first half
    kick reuses the cached gradient at the current state, so a trajectory
    costs ``n_leapfrog`` gradient evaluations, and the last one's value is
    the proposal's log-density. A non-finite energy change (a divergent
    trajectory) is rejected. Adaptation as in :func:`metropolis`, toward
    ``target_accept``, during burn-in only."""
    if n_leapfrog < 1:
        raise ValueError("n_leapfrog must be at least 1")
    theta = _start(init, n_chains, d, device)
    device, dtype, C = theta.device, theta.dtype, theta.shape[0]
    n_steps = burn + n_samples * thin

    def value_and_grad(q):
        with torch.enable_grad():
            q = q.detach().requires_grad_(True)
            lp = logpost(q)
            (g,) = torch.autograd.grad(lp.sum(), q)
        return lp.detach(), g

    # the steps' draws, in one copy: momenta, accept uniforms, jitters
    p_all = draw_normal(generator, (n_steps, C, d), dtype, device)
    log_u = torch.log(draw_uniform(generator, (n_steps, C), dtype, device))
    jitter = 2.0 / 3.0 + (2.0 / 3.0) * draw_uniform(generator, (n_steps, C, 1), dtype, device)
    samples = torch.empty((n_samples, C, d), dtype=dtype, device=device)
    accepts = torch.zeros((), dtype=torch.int64, device=device)
    log_s = torch.full((C,), math.log(step_size), dtype=dtype, device=device)
    logp, g_theta = value_and_grad(theta)
    for t in range(n_steps):
        eps = torch.exp(log_s)[:, None] * jitter[t]
        p0 = p_all[t]
        q, p = theta, p0 + 0.5 * eps * g_theta
        for leap in range(n_leapfrog):
            q = q + eps * p
            logp1, g1 = value_and_grad(q)
            p = p + (0.5 if leap == n_leapfrog - 1 else 1.0) * eps * g1
        h0 = logp - 0.5 * torch.sum(p0**2, dim=1)
        h1 = logp1 - 0.5 * torch.sum(p**2, dim=1)
        log_ratio = h1 - h0
        log_ratio = torch.where(torch.isfinite(log_ratio), log_ratio, -math.inf)
        accept = log_u[t] < log_ratio
        theta = torch.where(accept[:, None], q, theta)
        logp = torch.where(accept, logp1, logp)
        g_theta = torch.where(accept[:, None], g1, g_theta)
        if adapt and t < burn:
            alpha = torch.clamp(torch.exp(log_ratio), max=1.0)
            log_s = log_s + (t + 1.0) ** (-0.6) * (alpha - target_accept)
        if t >= burn:
            accepts += accept.sum()
            if (t - burn) % thin == 0:
                samples[(t - burn) // thin] = theta
    return _result(samples, accepts, (n_steps - burn) * C, log_s)


def ess_rhat(samples: np.ndarray):
    """(bulk ESS (d,), split-R-hat (d,)) for samples (n_chains, n_kept, d).

    Split-R-hat: each chain halved -> 2M sequences; R-hat = sqrt(var+ / W).
    ESS: M*N / (1 + 2 sum rho_t) with chain-averaged autocorrelations from
    FFT and Geyer's initial-monotone-positive-sequence truncation.
    """
    samples = np.asarray(samples, np.float64)
    m, n, d = samples.shape
    half = n // 2
    # ---- split R-hat ----
    split = samples[:, : 2 * half].reshape(m * 2, half, d)
    cm = split.mean(axis=1)  # (2m, d)
    W = split.var(axis=1, ddof=1).mean(axis=0)  # (d,)
    B = half * cm.var(axis=0, ddof=1)  # (d,)
    var_plus = (half - 1) / half * W + B / half
    rhat = np.sqrt(var_plus / np.maximum(W, 1e-300))

    # ---- bulk ESS on the split sequences ----
    seqs = split - split.mean(axis=1, keepdims=True)  # center per sequence
    nfft = int(2 ** np.ceil(np.log2(2 * half)))
    f = np.fft.rfft(seqs, n=nfft, axis=1)
    acov = np.fft.irfft(f * np.conj(f), n=nfft, axis=1)[:, :half].real
    acov /= half  # biased autocovariance per sequence
    mean_acov = acov.mean(axis=0)  # (half, d)
    # Vehtari: rho_t = 1 - (W - mean within-seq acov_t) / var_plus
    rho = 1.0 - (W[None, :] - mean_acov) / np.maximum(var_plus[None, :], 1e-300)
    ess = np.empty(d)
    for j in range(d):
        # Geyer: sum consecutive pairs while positive, enforce monotone
        p = rho[:, j]
        tmax = (len(p) // 2) * 2
        pair = p[:tmax].reshape(-1, 2).sum(axis=1)  # Gamma_k
        k_pos = np.argmax(pair <= 0) if np.any(pair <= 0) else len(pair)
        g = pair[:k_pos]
        g = np.minimum.accumulate(g) if len(g) else g
        tau = -1.0 + 2.0 * g.sum()  # rho_0 = 1 included via -1 + 2*sum(pairs)
        tau = max(tau, 1.0 / np.log10(max(m * n, 10)))
        ess[j] = min(m * n / tau, float(m * n))
    return ess, rhat


def posterior_predictive_z(generator: torch.Generator, fh_batch: Callable, theta_samples,
                           sig_eta: float, *, device=None) -> np.ndarray:
    """z = h(theta) + eta over posterior draws ``theta_samples (N, d)``
    (a tensor, or an array placed on ``device``); ``fh_batch`` is the
    batched observation operator. Returns (N, d_z)."""
    theta = torch.as_tensor(theta_samples, device=device)
    with torch.no_grad():
        _, h = fh_batch(theta)
    eta = math.sqrt(sig_eta) * draw_normal(generator, h.shape, h.dtype, h.device)
    return (h + eta).cpu().numpy()
