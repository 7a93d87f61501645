"""Certified reduced-basis solver for the parametric stiffness family
(counterpart of ``vbicm_tpu/rom/reduced_basis.py``).

With the load fixed, the operator family

    K(lam, mu) = lam*K_lam + mu*K_mu = mu * (t*K_lam + K_mu),  t = lam/mu

has the one-parameter solution manifold ``u(lam, mu) = u_hat(t)/mu``, which
a handful of snapshots compress to machine precision:

  offline (host, float64, SciPy sparse): greedy-select snapshot parameters
  from a candidate t-grid by the true residual norm, solve each with a
  sparse direct factorization, orthonormalize -> basis Q (n, r), project
  A_r = Q^T K_lam Q, B_r = Q^T K_mu Q, f_r = Q^T f, and diagonalize the
  reduced pencil once, eigh(A_r, B_r);

  online (the model's device, batched PyTorch): every sample's reduced
  solve is a length-r diagonal scale, u_r = V diag(1/(lam*g + mu)) V^T f_r,
  and the observation operator reads only the probe rows of Q. It is r x r
  work with no kernel in it, differentiable by autograd.

  certificate: ||f - K(c) Q u_r|| from precomputed Gram blocks, a cheap
  online monitor (:func:`residual_norm`).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Tuple

import numpy as np
import scipy.linalg
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from ..config import ProblemConfig
from ..model import FemModel
from ..ops.element import material_coeffs
from ..ops.vonmises import von_mises_reference


@dataclasses.dataclass(frozen=True)
class ReducedBasis:
    Q: np.ndarray  # (ndof, r) basis (zero rows on fixed dofs)
    g: np.ndarray  # (r,) generalized eigenvalues of (A_r, B_r)
    V: np.ndarray  # (r, r) eigenvectors, V^T B_r V = I
    f_r: np.ndarray  # (r,) = Q^T f
    # error-certificate Gram data: ||f - K Q u||^2 =
    #   ff - 2 sum_p c_p u.(m_p) + sum_pq c_p c_q u.(G_pq u)
    ff: float
    m: np.ndarray  # (P, r) with m_p = (K_p Q)^T f
    G: np.ndarray  # (P, P, r, r) with G_pq = (K_p Q)^T (K_q Q)
    t_snapshots: Tuple[float, ...]
    max_rel_residual: float  # certified max over the training grid

    @property
    def r(self) -> int:
        return int(self.Q.shape[1])


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


def _sparse_parts(model: FemModel):
    """SciPy CSR K_lam, K_mu on the full dof set from the model's element
    blocks, rows and columns of fixed dofs zeroed, with a unit diagonal on
    the fixed dofs of the mu-part (so (t A + B) solves act on free dofs)."""
    lm = model.lm.cpu().numpy()
    ndof = model.ndof
    rows = np.repeat(lm, lm.shape[1], axis=1).reshape(-1)
    cols = np.tile(lm, (1, lm.shape[1])).reshape(-1)
    free_mask = _host(model.free_mask) > 0
    d = sp.diags(free_mask.astype(np.float64))
    mats = [d @ sp.csr_matrix((_host(ke).reshape(-1), (rows, cols)), shape=(ndof, ndof)) @ d
            for ke in (model.ke_lam, model.ke_mu)]
    mats[1] = mats[1] + sp.diags((~free_mask).astype(np.float64))
    return mats[0], mats[1]


def build_reduced_basis(
    model: FemModel,
    *,
    t_range: Tuple[float, float] = (0.2, 5.0),
    n_candidates: int = 33,
    tol: float = 1e-10,
    max_basis: int = 64,
) -> ReducedBasis:
    """Greedy certified reduced basis, built on the host in float64.

    The t = lam/mu candidate grid is log-spaced over ``t_range`` (the
    Cook's prior maps to t in ~[0.86, 1.16]; the default is a wide margin).
    The greedy stops when the worst true relative residual over the grid
    drops below ``tol``, or when the worst candidate's snapshot adds no new
    direction (then it warns and returns the floor-accuracy basis)."""
    A, B = _sparse_parts(model)
    f = _host(model.f_ext) * _host(model.free_mask)
    fnorm = float(np.linalg.norm(f))
    ts = np.geomspace(t_range[0], t_range[1], n_candidates)

    Q = np.zeros((model.ndof, 0))
    chosen = []
    max_res = np.inf
    next_t = float(ts[len(ts) // 2])  # start at the geometric middle
    while Q.shape[1] < max_basis:
        u = spla.spsolve((next_t * A + B).tocsc(), f)
        chosen.append(next_t)
        # Gram-Schmidt against the current basis, twice for stability
        v = u.copy()
        for _ in range(2):
            if Q.shape[1]:
                v -= Q @ (Q.T @ v)
        nv = np.linalg.norm(v)
        grew = nv > 1e-13 * np.linalg.norm(u)
        if grew:
            Q = np.concatenate([Q, (v / nv)[:, None]], axis=1)
        # true residuals over the grid with the current basis
        AQ, BQ = A @ Q, B @ Q
        Ar, Br = Q.T @ AQ, Q.T @ BQ
        fr = Q.T @ f
        res = np.empty(len(ts))
        for i, t in enumerate(ts):
            ur = np.linalg.solve(t * Ar + Br, fr)
            res[i] = np.linalg.norm(f - (t * (AQ @ ur) + BQ @ ur)) / fnorm
        max_res = float(res.max())
        if max_res < tol:
            break
        if not grew:
            # the manifold is exhausted at working precision: max_res is the
            # attainable floor, and the greedy would re-select the same t
            warnings.warn(
                f"reduced basis stagnated at r={Q.shape[1]} with max relative "
                f"residual {max_res:.2e} > tol={tol:.0e}; returning the "
                "floor-accuracy basis (check rb.max_rel_residual)"
            )
            break
        next_t = float(ts[int(res.argmax())])

    AQ, BQ = A @ Q, B @ Q
    Ar, Br = Q.T @ AQ, Q.T @ BQ
    fr = Q.T @ f
    g, V = scipy.linalg.eigh(Ar, Br)
    KQ = np.stack([AQ, BQ])  # (P, ndof, r)
    return ReducedBasis(
        Q=Q,
        g=g,
        V=V,
        f_r=fr,
        ff=float(f @ f),
        m=np.einsum("pnr,n->pr", KQ, f),
        G=np.einsum("pnr,qns->pqrs", KQ, KQ),
        t_snapshots=tuple(chosen),
        max_rel_residual=max_res,
    )


def _reduced_solver(rb: ReducedBasis, dtype, device) -> Callable:
    """``solve(lam, mu (B,)) -> u_r (B, r)`` with the basis's V, g and
    V^T f_r on ``device`` in ``dtype``, copied there once."""
    V = torch.as_tensor(rb.V, dtype=dtype, device=device)
    g = torch.as_tensor(rb.g, dtype=dtype, device=device)
    fV = torch.as_tensor(rb.V.T @ rb.f_r, dtype=dtype, device=device)

    def solve(lam, mu):
        return (fV / (lam[:, None] * g + mu[:, None])) @ V.T

    return solve


def reduced_solve(rb: ReducedBasis, lam, mu):
    """u_r (B, r) for lam, mu (B,): O(r^2) a sample, differentiable, on
    lam's device and in its dtype."""
    return _reduced_solver(rb, lam.dtype, lam.device)(lam, mu)


def residual_norm(rb: ReducedBasis, lam, mu, u_r):
    """Certified ||f - K(c) Q u_r|| / ||f|| (B,) from the Gram data, for
    lam, mu (B,) and u_r (B, r).

    The expansion ``ff - 2 lin + quad`` cancels catastrophically once the
    true residual is below ~sqrt(eps)*||f||, so this estimator floors near
    1e-8 relative in float64: the greedy build uses true residuals, and this
    is a cheap online out-of-range monitor."""
    c = torch.stack([lam, mu], dim=-1)
    m = torch.as_tensor(rb.m, dtype=u_r.dtype, device=u_r.device)
    G = torch.as_tensor(rb.G, dtype=u_r.dtype, device=u_r.device)
    lin = 2.0 * torch.einsum("bp,pr,br->b", c, m, u_r)
    quad = torch.einsum("bp,bq,pqrs,br,bs->b", c, c, G, u_r, u_r)
    val = torch.clamp_min(rb.ff - lin + quad, 0.0)
    return torch.sqrt(val) / np.sqrt(rb.ff)


def make_fh_fun_rom(model: FemModel, rb: ReducedBasis,
                    cfg: ProblemConfig = ProblemConfig()) -> Callable:
    """The ROM observation operator ``fh(thetas (B, 2)) -> (y (B, ndm),
    h (B, nq))``: O(r^2) a sample, batched on the model's device,
    differentiable in thetas. Only the probe rows of Q are used online; the
    basis's accuracy is certified by ``rb.max_rel_residual`` over its
    training range."""
    from ..solver import _stress6

    if not (1 <= cfg.node_id <= model.nnodes):
        raise ValueError(f"probe node_id {cfg.node_id} outside [1, {model.nnodes}]")
    if not (1 <= cfg.ele_id <= model.nele):
        raise ValueError(f"probe ele_id {cfg.ele_id} outside [1, {model.nele}]")
    dt, dev = model.dtype, model.device
    tm = torch.tensor(cfg.theta_map.theta_mean, dtype=dt, device=dev)
    ts = torch.tensor(cfg.theta_map.theta_std, dtype=dt, device=dev)
    obs_dofs = model.ndm * (cfg.node_id - 1) + np.arange(model.ndm)
    q = torch.as_tensor(cfg.nipt_id, device=dev) - 1
    B_probe = model.B[cfg.ele_id - 1, q]  # (nq, 3, 8) | (nq, 6, 24)
    lm_probe = model.lm[cfg.ele_id - 1].cpu().numpy()
    Q_obs = torch.as_tensor(rb.Q[obs_dofs], dtype=dt, device=dev)  # (ndm, r)
    Q_ele = torch.as_tensor(rb.Q[lm_probe], dtype=dt, device=dev)  # (edof, r)
    solve = _reduced_solver(rb, dt, dev)

    def fh(thetas):
        thetas = thetas.to(dt)
        E = torch.exp(ts[0] * thetas[:, 0] + tm[0])
        v = 0.5 * torch.sigmoid(ts[1] * thetas[:, 1] + tm[1])
        c0, c1 = material_coeffs(model.stype, E, v)
        u_r = solve(c0, c1)  # (B, r)
        y = u_r @ Q_obs.T
        eps3 = torch.einsum("qai,bi->bqa", B_probe, u_r @ Q_ele.T)
        sig6 = _stress6(model, eps3, c0[:, None], c1[:, None])
        return y, von_mises_reference(sig6)

    return fh
