"""Certified reduced-basis ROM for the random-field operator family
(counterpart of ``vbicm_tpu/rom/field.py``).

The per-element-coefficient operator of the KL field family
(``ops.solve.make_field_solver``) is exactly affine in the field,

    K(E) = sum_e E_e A_e,   E_e = exp(mean_log + (modes^T theta)_e),

so with a reduced basis Q (ndof, r) the reduced operator is

    K_r(E) = sum_e E_e M_e,   M_e = Q_e^T ke_unit_e Q_e  (precomputed),

one (B, nele) x (nele, r^2) product a batch of fields followed by batched
r x r dense solves. The JAX package computes these outside any Pallas
kernel, so they are library calls here (``torch.matmul``,
``torch.linalg.solve``).

Offline: a host-side greedy over prior draws of theta with TRUE residual
certification (sparse direct snapshot solves, incremental reduced-operator
updates), plus a held-out validation sweep. The host code is the JAX
package's, so the basis is bitwise equal for the same seed. Its docstring
records where the family compresses: up to about 8 KL modes; the 16-mode
family stays on the full-order field solver.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable

import numpy as np
import torch

from ..config import ProblemConfig
from ..model import FemModel
from ..ops.element import lame_from_Ev
from ..ops.vonmises import von_mises_reference
from ..prob.randomfield import KLExpansion
from ..solver import _stress6


@dataclasses.dataclass(frozen=True)
class FieldReducedBasis:
    Q: np.ndarray  # (ndof, r) basis (zero rows on fixed dofs)
    M: np.ndarray  # (nele, r, r) reduced unit-modulus element blocks
    f_r: np.ndarray  # (r,) = Q^T f
    nu: float
    theta_snapshots: np.ndarray  # (r_sel, n_modes) greedy-selected draws
    max_rel_residual: float  # certified max over the TRAINING candidate set
    val_max_rel_residual: float  # measured max over held-out prior draws

    @property
    def r(self) -> int:
        return int(self.Q.shape[1])


def _host_model(model: FemModel):
    """(lm, ndof, free_mask, f_ext, ke_lam, ke_mu) of the model as NumPy."""
    return tuple(t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t
                 for t in (model.lm, model.ndof, model.free_mask, model.f_ext, model.ke_lam,
                           model.ke_mu))


def _field_csr(model: FemModel, ke_unit: np.ndarray, E: np.ndarray):
    """Host CSR of K(E) = assemble(E_e ke_unit_e), fixed dofs masked with
    unit diagonal."""
    import scipy.sparse as sp

    lm, ndof, free_mask = _host_model(model)[:3]
    rows = np.repeat(lm, lm.shape[1], axis=1).reshape(-1)
    cols = np.tile(lm, (1, lm.shape[1])).reshape(-1)
    data = (E[:, None, None] * ke_unit).reshape(-1)
    K = sp.csr_matrix((data, (rows, cols)), shape=(ndof, ndof))
    free = free_mask > 0
    d = sp.diags(free.astype(np.float64))
    return d @ K @ d + sp.diags((~free).astype(np.float64))


def build_reduced_basis_field(
    model: FemModel,
    kl: KLExpansion,
    *,
    nu: float = 0.3,
    n_candidates: int = 96,
    n_validate: int = 64,
    tol: float = 1e-8,
    max_basis: int = 128,
    seed: int = 0,
    verbose: bool = False,
) -> FieldReducedBasis:
    """Greedy certified RB over the theta prior N(0, I_{n_modes}), on the
    host.

    Candidates are ``n_candidates`` fixed prior draws (+ the mean field as
    the greedy seed); each greedy step direct-solves the worst-residual
    candidate's full system and re-certifies the whole set with TRUE
    residuals. ``val_max_rel_residual`` reports the same certificate on
    ``n_validate`` fresh draws the greedy never saw.
    """
    import scipy.sparse.linalg as spla

    if model.stype not in (2, 4):
        raise NotImplementedError(
            "field ROM supports plane strain (stype=2) and 3-D (stype=4)"
        )
    lm, ndof, free_mask, f_ext, ke_lam, ke_mu = _host_model(model)
    lam1, mu1 = lame_from_Ev(1.0, nu)
    ke_unit = lam1 * ke_lam + mu1 * ke_mu
    f = f_ext * free_mask
    fnorm = float(np.linalg.norm(f))

    rng = np.random.default_rng(seed)
    thetas = np.concatenate(
        [np.zeros((1, kl.n_modes)),  # mean field: the greedy seed
         rng.standard_normal((n_candidates, kl.n_modes))]
    )
    fields = np.exp(kl.mean_log + thetas @ kl.modes)  # (n_cand+1, nele)
    Ks = [_field_csr(model, ke_unit, E) for E in fields]

    n_all = len(Ks)
    Q = np.zeros((ndof, 0))
    Kr = np.zeros((n_all, max_basis, max_basis))  # per-candidate Q^T K_i Q
    chosen: list[int] = []
    next_i = 0
    max_res = np.inf
    while Q.shape[1] < max_basis:
        u = spla.spsolve(Ks[next_i].tocsc(), f)
        v = u.copy()
        for _ in range(2):  # twice-is-enough Gram-Schmidt
            if Q.shape[1]:
                v -= Q @ (Q.T @ v)
        nv = np.linalg.norm(v)
        if nv <= 1e-13 * np.linalg.norm(u):
            warnings.warn(
                f"field reduced basis stagnated at r={Q.shape[1]} with max "
                f"relative residual {max_res:.2e} > tol={tol:.0e}; returning "
                "the floor-accuracy basis (check rb.max_rel_residual)"
            )
            break
        # the snapshot is recorded only once it grew the basis, so
        # theta_snapshots[k] generated Q[:, k]
        chosen.append(next_i)
        q = v / nv
        r = Q.shape[1]
        # incremental reduced-operator update: one sparse matvec w = K_i q
        # per candidate, new row/col [Q^T w; q^T w] (K_i symmetric)
        for i, K in enumerate(Ks):
            w = K @ q
            col = Q.T @ w
            Kr[i, :r, r] = col
            Kr[i, r, :r] = col
            Kr[i, r, r] = q @ w
        Q = np.concatenate([Q, q[:, None]], axis=1)
        r += 1
        f_r = Q.T @ f
        u_rs = np.linalg.solve(
            Kr[:, :r, :r], np.broadcast_to(f_r[:, None], (n_all, r, 1)).copy()
        )[..., 0]  # batched (n_all, r)
        xs = Q @ u_rs.T  # (ndof, n_all)
        res = np.array(
            [np.linalg.norm(f - K @ xs[:, i]) for i, K in enumerate(Ks)]
        ) / fnorm
        max_res = float(res.max())
        if verbose:
            print(f"[field-rb] r={r} max_res={max_res:.3e}", flush=True)
        if max_res < tol:
            break
        next_i = int(res.argmax())

    r = Q.shape[1]
    if r >= 0.8 * n_all:
        warnings.warn(
            f"field reduced basis used {r} of {n_all} candidates: the pool "
            "is nearly exhausted, so the training certificate is an "
            "overfit-optimistic number; trust val_max_rel_residual (or "
            "enlarge n_candidates)."
        )
    f_r = Q.T @ f
    # held-out certification on fresh prior draws
    th_val = rng.standard_normal((n_validate, kl.n_modes))
    val_max = 0.0
    for th in th_val:
        E = np.exp(kl.mean_log + th @ kl.modes)
        K = _field_csr(model, ke_unit, E)
        KQ = K @ Q
        u_r = np.linalg.solve(Q.T @ KQ, f_r)
        val_max = max(val_max, float(np.linalg.norm(f - KQ @ u_r) / fnorm))

    # reduced unit-modulus element blocks M_e = Q_e^T ke_unit_e Q_e
    Q_e = Q[lm]  # (nele, edof, r)
    M = np.einsum("eai,eab,ebj->eij", Q_e, ke_unit, Q_e, optimize=True)

    return FieldReducedBasis(
        Q=Q,
        M=M,
        f_r=f_r,
        nu=float(nu),
        theta_snapshots=thetas[chosen],
        max_rel_residual=max_res,
        val_max_rel_residual=val_max,
    )


def _reduced_solve(Mf, f_r, E):
    """u_r (B, r) from E (B, nele): the reduced operators as one product
    with Mf (nele, r^2), symmetrized, then batched r x r solves."""
    r = f_r.shape[0]
    Kr = torch.matmul(E, Mf).reshape(E.shape[0], r, r)
    Kr = 0.5 * (Kr + Kr.transpose(1, 2))
    return torch.linalg.solve(Kr, f_r.expand(E.shape[0], r))


def reduced_field_solve(rb: FieldReducedBasis, E):
    """u_r(E): E (B, nele) -> (B, r) on E's device and dtype. Natively
    differentiable; no custom backward at r x r scale."""
    Mf = torch.as_tensor(rb.M.reshape(rb.M.shape[0], -1), dtype=E.dtype, device=E.device)
    return _reduced_solve(Mf, torch.as_tensor(rb.f_r, dtype=E.dtype, device=E.device), E)


def make_fh_fun_field_rom(
    model: FemModel,
    kl: KLExpansion,
    rb: FieldReducedBasis,
    cfg: ProblemConfig,
    *,
    probe_nodes,
) -> Callable:
    """Batched ROM observation operator for the field family, ``fh(thetas
    (B, n_modes)) -> (y, h)`` with the semantics of ``prob.randomfield.
    make_fh_fun_field`` (displacement probes and the local-modulus von
    Mises), O(nele r^2 + r^3) a field instead of a CG solve; its exactness
    is certified by ``rb.max_rel_residual`` and ``rb.val_max_rel_residual``."""
    dt, dev = model.dtype, model.device
    probe_nodes = np.asarray(probe_nodes, dtype=np.int64)
    if probe_nodes.min() < 1 or probe_nodes.max() > model.nnodes:
        raise ValueError("probe_nodes outside [1, nnodes]")
    obs = (model.ndm * (probe_nodes[:, None] - 1) + np.arange(model.ndm)[None, :]).reshape(-1)
    if not (1 <= cfg.ele_id <= model.nele):
        raise ValueError(f"ele_id {cfg.ele_id} outside [1, {model.nele}]")
    nq = model.B.shape[1]
    if any(not (1 <= int(p) <= nq) for p in cfg.nipt_id):
        raise ValueError(f"nipt_id {cfg.nipt_id} outside [1, {nq}]")
    e = cfg.ele_id - 1
    q = torch.as_tensor(cfg.nipt_id, device=dev) - 1
    B_probe = model.B[e, q]
    lam_nu, mu_nu = lame_from_Ev(1.0, rb.nu)

    def as_t(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dt, device=dev)

    Mf = as_t(rb.M.reshape(rb.M.shape[0], -1))
    f_r = as_t(rb.f_r)
    Q_obs = as_t(rb.Q[obs])
    Q_ele = as_t(rb.Q[model.lm[e].cpu().numpy()])
    modes = as_t(kl.modes)

    def fh(thetas):
        E = torch.exp(kl.mean_log + thetas.to(dt) @ modes)
        u_r = _reduced_solve(Mf, f_r, E)
        y = u_r @ Q_obs.T
        eps3 = torch.einsum("qai,bi->bqa", B_probe, u_r @ Q_ele.T)
        Ee = E[:, e, None]
        return y, von_mises_reference(_stress6(model, eps3, lam_nu * Ee, mu_nu * Ee))

    return fh
