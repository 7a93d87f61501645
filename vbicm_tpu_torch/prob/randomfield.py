"""Random-field material inversion: a truncated KL expansion of a spatially
varying log-Young's-modulus field, inferred by the same two-step VI
(counterpart of ``vbicm_tpu/prob/randomfield.py``).

theta in R^d are the coefficients of a Karhunen-Loeve expansion of a
stationary Gaussian field evaluated at element centroids (a piecewise
constant modulus),

    log E(x) = log E0 + sum_k theta_k sqrt(lambda_k) phi_k(x),
    theta_k ~ N(0, 1)  (the VI prior, as in the scalar pipeline).

The forward solve is the per-element-coefficient operator of
:func:`ops.solve.make_field_solver`, batched over fields; observations are
displacement probes at several nodes. Everything downstream (ELBO terms,
the two-step trainer, MCMC, Laplace, refinement) is dimension-generic in
theta, so the batched ``fh`` of :func:`make_fh_fun_field` plugs into
``TwoStepTrainer(fh_batch=...)`` with ``ProblemConfig(theta_dim=d,
y_dim=...)``. The KL basis is built on the host with NumPy, the same code
as the JAX package's, so the two packages' bases are bitwise equal.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from ..config import ProblemConfig
from ..model import FemModel
from ..ops.element import lame_from_Ev
from ..ops.multigrid import make_grid_transfer_nd, make_two_level_preconditioner
from ..ops.solve import make_field_solver
from ..ops.vonmises import von_mises_reference
from ..solver import _stress6, make_coarse_spectral_apply


@dataclasses.dataclass(frozen=True)
class KLExpansion:
    """Truncated KL basis of the log-modulus field at element centroids."""

    modes: np.ndarray  # (n_modes, nele): sqrt(lambda_k) * phi_k
    eigvals: np.ndarray  # (n_modes,) covariance eigenvalues
    mean_log: float  # log E0
    corr_len: float
    sigma: float

    @property
    def n_modes(self) -> int:
        return int(self.modes.shape[0])


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def element_centroids(model: FemModel) -> np.ndarray:
    """(nele, ndm) element centroids (mean of corner coordinates)."""
    return _host(model.coords)[_host(model.conn)].mean(axis=1)


def build_kl_expansion(
    model: FemModel,
    *,
    n_modes: int = 8,
    corr_len: float = 15.0,
    sigma: float = 0.3,
    mean_log: float = float(np.log(20.0)),
    dense_eigh_threshold: int = 2000,
) -> KLExpansion:
    """Host-side KL of a squared-exponential covariance at element centroids.

    C(x, x') = sigma^2 exp(-|x - x'|^2 / (2 l^2)), discretized on the
    centroid cloud with uniform element weights. A dense eigh up to
    ``dense_eigh_threshold`` elements; above it a randomized subspace
    iteration (Halko et al.) with a fixed seed, exact to working precision
    for the kernel's exponentially decaying spectrum.
    """
    x = element_centroids(model)
    # |x-x'|^2 = |x|^2 + |x'|^2 - 2 x.x': one gram matrix
    sq = (x**2).sum(axis=1)
    d2 = np.maximum(sq[:, None] + sq[None, :] - 2.0 * (x @ x.T), 0.0)
    C = sigma**2 * np.exp(-d2 / (2.0 * corr_len**2))
    # uniform quadrature weight w = 1/nele keeps phi_k O(1) and orthonormal
    # in the weighted inner product; lambda_k then carry the field variance
    w = 1.0 / C.shape[0]
    if C.shape[0] <= dense_eigh_threshold:
        evals, evecs = np.linalg.eigh(C * w)
        idx = np.argsort(evals)[::-1][:n_modes]
    else:
        # randomized subspace iteration: a few BLAS-3 passes over C
        # (deterministic seed -> reproducible basis)
        rng = np.random.default_rng(0)
        Cw = C * w
        q = min(n_modes + 8, Cw.shape[0])
        Y = Cw @ rng.standard_normal((Cw.shape[0], q))
        for _ in range(2):  # power iterations sharpen the subspace
            Y, _ = np.linalg.qr(Y)
            Y = Cw @ Y
        Q, _ = np.linalg.qr(Y)
        T = Q.T @ (Cw @ Q)
        T = 0.5 * (T + T.T)
        tvals, tvecs = np.linalg.eigh(T)
        evals = tvals
        evecs = Q @ tvecs
        idx = np.argsort(evals)[::-1][:n_modes]
    lam = np.clip(evals[idx], 0.0, None)
    phi = evecs[:, idx].T / np.sqrt(w)  # orthonormal under w-weighted dot
    modes = np.sqrt(lam)[:, None] * phi
    return KLExpansion(
        modes=modes, eigvals=lam, mean_log=float(mean_log),
        corr_len=float(corr_len), sigma=float(sigma),
    )


def field_from_theta(kl: KLExpansion, theta, dtype=torch.float64):
    """E(theta): theta (B, n_modes) -> (B, nele) positive modulus fields, or
    (n_modes,) -> (nele,), on theta's device."""
    theta = torch.as_tensor(theta)
    modes = torch.as_tensor(kl.modes, dtype=dtype, device=theta.device)
    return torch.exp(kl.mean_log + theta.to(dtype) @ modes)


def posterior_field_moments(kl: KLExpansion, theta_mean, theta_var=None, *, L=None):
    """Closed-form per-element moments of the log-modulus field under a
    Gaussian posterior on the KL coefficients:

        mean[log E] = mean_log + modes^T theta_mean
        var[log E](x_e) = m_e^T Sigma m_e,   m_e = modes[:, e]

    Pass EITHER ``theta_var`` (mean-field: Sigma = diag(theta_var)) or ``L``
    (full-covariance Cholesky factor, Sigma = L L^T: std_e = |L^T m_e|).
    Returns ``(log_mean, log_std)`` as (nele,) NumPy arrays.
    """
    if (theta_var is None) == (L is None):
        raise ValueError("pass exactly one of theta_var (mean-field) or L (fullcov)")
    tm = _host(theta_mean).reshape(-1)
    log_mean = kl.mean_log + tm @ kl.modes
    if L is not None:
        log_std = np.linalg.norm(_host(L).T @ kl.modes, axis=0)
    else:
        tv = _host(theta_var).reshape(-1)
        log_std = np.sqrt(tv @ (kl.modes**2))
    return log_mean, log_std


def _mean_field_prec(coarse_model: FemModel, transfer, free_mask, nu, E0, omega) -> Callable:
    """``prec(E, diag_inv, r) -> z``: the additive two-level cycle with the
    coarse spectral solve at the homogeneous coefficients (lam, mu)(E0, nu)
    for every field of the batch, and Jacobi on each field's own diagonal."""
    prec2 = make_two_level_preconditioner(make_coarse_spectral_apply(coarse_model), free_mask,
                                          transfer, omega=omega)
    lam0, mu0 = lame_from_Ev(E0, nu)
    coeffs0 = {dt: torch.tensor([lam0, mu0], dtype=torch.float64,
                                device=coarse_model.device).to(dt)
               for dt in (torch.float32, torch.float64)}

    def prec(E, diag_inv, r):
        return prec2(coeffs0[r.dtype].expand(r.shape[0], 2), diag_inv, r)

    return prec


def make_mean_field_preconditioner(
    coarse_model: FemModel,
    nx_coarse: int,
    ny_coarse: int,
    ratio: int,
    free_mask,
    *,
    nu: float = 0.3,
    E0: float = 20.0,
    omega: float = 0.6,
) -> Callable:
    """Two-level preconditioner for the FIELD operator, built at the mean
    field E = E0 (homogeneous coefficients).

    K(E) is spectrally equivalent to K(E0) within min and max of E/E0, so
    the fixed-coefficient coarse solve (the spectral kernel, ``solver.
    make_coarse_spectral_apply``) with the bilinear transfers of
    ``ops.multigrid.make_grid_transfer_nd`` on the (ny, nx) grid
    preconditions every field of a batch with no per-field coarse set-up;
    the Jacobi half sees each field's own diagonal. Signature of
    ``make_field_solver(preconditioner=...)``: ``prec(E, diag_inv, r) ->
    z``.
    """
    transfer = make_grid_transfer_nd((ny_coarse, nx_coarse), ratio, 2,
                                     device=coarse_model.device)
    return _mean_field_prec(coarse_model, transfer, free_mask, nu, E0, omega)


def make_mean_field_preconditioner_box3d(
    coarse_model: FemModel,
    cells_coarse,
    ratio: int,
    free_mask,
    *,
    nu: float = 0.3,
    E0: float = 20.0,
    omega: float = 0.6,
) -> Callable:
    """3-D sibling of :func:`make_mean_field_preconditioner` for structured
    hex8 boxes (``mesh/solid3d.py`` numbering): the coarse spectral solve at
    E0 and the trilinear tensor-product transfers. ``cells_coarse`` = coarse
    (nx, ny, nz) cell counts; the fine grid is ``cells_coarse * ratio``.
    Pass as ``make_field_solver(..., preconditioner=..., grid=(nx, ny,
    nz))``.
    """
    ncx, ncy, ncz = cells_coarse
    transfer = make_grid_transfer_nd((ncz, ncy, ncx), ratio, 3, device=coarse_model.device)
    return _mean_field_prec(coarse_model, transfer, free_mask, nu, E0, omega)


def make_fh_fun_field(
    model: FemModel,
    kl: KLExpansion,
    cfg: ProblemConfig,
    *,
    probe_nodes: Sequence[int],
    nu: float = 0.3,
    tol: float = 1e-12,
    maxiter: int = 4000,
    cg_dtype=None,
    refine_iters: int = 0,
    preconditioner=None,
    grid=None,
) -> Callable:
    """Batched observation operator ``fh(thetas (B, n_modes)) -> (y (B,
    ndm * len(probe_nodes)), h (B, nq))`` for the random-field model.

    y: the displacements at ``probe_nodes`` (1-based node ids); set
    ``cfg.y_dim`` and ``cfg.theta_dim`` accordingly for the trainer. h: the
    reference-convention von Mises at ``cfg.ele_id`` / ``cfg.nipt_id``,
    computed with the LOCAL element modulus. The solver options go to
    :func:`ops.solve.make_field_solver`. The port builds only the plain
    force-controlled operator (no constraints, springs or prescribed
    displacements), which the field solver assumes.
    """
    if model.stype not in (2, 4):
        # lame_from_Ev(1, nu) * E is the true Lame pair only for plane strain
        # and 3-D solids
        raise NotImplementedError(
            "random-field fh supports plane strain (stype=2) and 3-D (stype=4)"
        )
    lam1, mu1 = lame_from_Ev(1.0, nu)
    ke_unit = lam1 * model.ke_lam + mu1 * model.ke_mu
    solve = make_field_solver(
        ke_unit, model.lm, model.free_mask, model.ndof,
        tol=tol, maxiter=maxiter, cg_dtype=cg_dtype, refine_iters=refine_iters,
        preconditioner=preconditioner, grid=grid,
    )
    probe_nodes = np.asarray(probe_nodes, dtype=np.int64)
    if probe_nodes.min() < 1 or probe_nodes.max() > model.nnodes:
        raise ValueError("probe_nodes outside [1, nnodes]")
    obs = (model.ndm * (probe_nodes[:, None] - 1) + np.arange(model.ndm)[None, :]).reshape(-1)
    obs_dofs = torch.as_tensor(obs, device=model.device)
    # the same 1-based probe validation as make_fh_fun
    if not (1 <= cfg.ele_id <= model.nele):
        raise ValueError(f"ele_id {cfg.ele_id} outside [1, {model.nele}]")
    nq = model.B.shape[1]
    if any(not (1 <= int(p) <= nq) for p in cfg.nipt_id):
        raise ValueError(f"nipt_id {cfg.nipt_id} outside [1, {nq}]")
    e = cfg.ele_id - 1
    q = torch.as_tensor(cfg.nipt_id, device=model.device) - 1
    B_probe = model.B[e, q]
    lm_probe = model.lm[e]
    modes = torch.as_tensor(kl.modes, dtype=model.dtype, device=model.device)

    def fh(thetas):
        E = torch.exp(kl.mean_log + thetas.to(model.dtype) @ modes)
        u = solve(E, model.f_ext.expand(E.shape[0], -1))
        y = u[:, obs_dofs]
        eps3 = torch.einsum("qai,bi->bqa", B_probe, u[:, lm_probe])
        Ee = E[:, e, None]
        return y, von_mises_reference(_stress6(model, eps3, lam1 * Ee, mu1 * Ee))

    fh.solver = solve
    return fh
