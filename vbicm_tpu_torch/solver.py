"""Forward FEM solve and the differentiable observation operator
(counterpart of ``vbicm_tpu/solver.py``).

For the reference's linear problem a forward analysis is one solve
``K(lam, mu) u_f = f_f``. Solves here are batched: ``solve_free(c0 (B,),
c1 (B,)) -> u (B, ndof)``, and the observation operator maps a batch of
thetas to the probes, ``fh(thetas (B, 2)) -> (y (B, 2), h (B, 2))`` — the
batch dimension the JAX package gets from ``jax.vmap``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch

from .config import MaterialCard, ProblemConfig
from .model import FemModel
from .ops.element import material_coeffs, stress6_plane_strain
from .ops.solve import make_spectral_affine_solver
from .ops.vonmises import von_mises_reference


@dataclasses.dataclass(frozen=True)
class FemSolution:
    """Result of one forward analysis."""

    u: torch.Tensor  # (ndof,) nodal displacements, supports = 0
    strain: torch.Tensor  # (nele, nqpt, 6) [e11, e22, e33, g12, g23, g31]
    stress: torch.Tensor  # (nele, nqpt, 6) [s11, s22, s33, t12, t23, t31]
    reactions: torch.Tensor  # (ndof,) support reactions (nonzero on supp dofs)


def make_solver(model: FemModel, *, factor_dtype=None, refine_iters: int = 0) -> Callable:
    """Build ``solve_free(c0 (B,), c1 (B,)) -> u (B, ndof)`` for this model
    through the spectral pencil (``ops.solve``), the JAX package's default
    method for dense models; ``factor_dtype`` selects the precision of its
    apply."""
    base = make_spectral_affine_solver(
        torch.stack([model.k_lam_ff, model.k_mu_ff]),
        apply_dtype=factor_dtype,
        refine_iters=refine_iters,
    )
    embed = _make_free_embed(model)

    def solve_free(c0, c1):
        coeffs = torch.stack([c0, c1], dim=-1)
        # the load on the free dofs; constant, since prescribed displacements
        # (the JAX package's Dirichlet lift) are not ported yet
        return embed(base(coeffs, model.f_free.expand(c0.shape[0], -1)))

    return solve_free


def _make_free_embed(model: FemModel):
    """free-dof batch (B, nfree) -> full-dof batch (B, ndof), zeros on the
    supports, as a gather through a static permutation."""
    order = torch.cat([model.free_dof, model.supp_dof])
    inv = torch.argsort(order)
    nsupp = int(model.supp_dof.shape[0])

    def embed(u_f):
        tail = u_f.new_zeros((*u_f.shape[:-1], nsupp))
        return torch.cat([u_f, tail], dim=-1)[..., inv]

    return embed


def recover_fields(model: FemModel, u, c0, c1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(element, qpt) strain/stress 6-vectors from one displacement
    field u (ndof,); (c0, c1) = (lam, mu). Plane strain stores e33 = 0 but
    s33 = lam*(e11+e22)."""
    ue = u[model.lm]  # (nele, edof)
    eps3 = torch.einsum("eqai,ei->eqa", model.B, ue)
    sig6 = stress6_plane_strain(eps3, c0, c1)
    zero = torch.zeros_like(eps3[..., 0])
    eps6 = torch.stack([eps3[..., 0], eps3[..., 1], zero, eps3[..., 2], zero, zero], dim=-1)
    return eps6, sig6


def fea_solution(model: FemModel, material: MaterialCard = MaterialCard()) -> FemSolution:
    """Full forward analysis for one material (reference ``fea_solution``)."""
    c0, c1 = material_coeffs(model.stype, material.E, material.v)
    c0 = torch.tensor([c0], dtype=model.dtype, device=model.device)
    c1 = torch.tensor([c1], dtype=model.dtype, device=model.device)
    u = make_solver(model)(c0, c1)[0]
    c0, c1 = c0[0], c1[0]
    eps6, sig6 = recover_fields(model, u, c0, c1)
    # support reactions = internal force on the supported dofs
    ke = c0 * model.ke_lam + c1 * model.ke_mu
    fe = torch.einsum("eij,ej->ei", ke, u[model.lm])
    f_int = torch.zeros(model.ndof, dtype=u.dtype, device=u.device)
    f_int.index_add_(0, model.lm.reshape(-1), fe.reshape(-1))
    reactions = f_int * (1.0 - model.free_mask)
    return FemSolution(u=u, strain=eps6, stress=sig6, reactions=reactions)


def probe_von_mises(model: FemModel, u, c0, c1, ele_id: int, nipt_id) -> torch.Tensor:
    """Reference-convention von Mises at 1-based element/qpt probe ids, for
    one displacement field u (ndof,) and (c0, c1) = (lam, mu)."""
    q = torch.as_tensor(nipt_id, device=u.device) - 1
    eps3 = torch.einsum("qai,i->qa", model.B[ele_id - 1, q], u[model.lm[ele_id - 1]])
    return von_mises_reference(stress6_plane_strain(eps3, c0, c1))


def make_fh_fun(
    model: FemModel,
    cfg: ProblemConfig = ProblemConfig(),
    *,
    factor_dtype=None,
    refine_iters: int = 0,
) -> Callable:
    """Build the batched observation operator
    ``fh(thetas (B, 2)) -> (y (B, 2), h (B, 2))``.

    E = exp(std0 * t0 + mean0), nu = 0.5 * sigmoid(std1 * t1 + mean1);
    y = (ux, uy) at ``cfg.node_id``; h = reference von Mises at
    ``cfg.ele_id``, qpts ``cfg.nipt_id``. Differentiable in thetas.
    """
    solve_free = make_solver(model, factor_dtype=factor_dtype, refine_iters=refine_iters)
    if not (1 <= cfg.node_id <= model.nnodes):
        raise ValueError(f"probe node_id {cfg.node_id} outside [1, {model.nnodes}]")
    if not (1 <= cfg.ele_id <= model.nele):
        raise ValueError(f"probe ele_id {cfg.ele_id} outside [1, {model.nele}]")
    tm = torch.tensor(cfg.theta_map.theta_mean, dtype=model.dtype, device=model.device)
    ts = torch.tensor(cfg.theta_map.theta_std, dtype=model.dtype, device=model.device)
    obs_dofs = torch.as_tensor(
        model.ndm * (cfg.node_id - 1) + np.arange(model.ndm), device=model.device
    )
    q = torch.as_tensor(cfg.nipt_id, device=model.device) - 1
    B_probe = model.B[cfg.ele_id - 1, q]  # (nq, 3, 8)
    lm_probe = model.lm[cfg.ele_id - 1]

    def fh(thetas):
        thetas = thetas.to(model.dtype)
        E = torch.exp(ts[0] * thetas[:, 0] + tm[0])
        v = 0.5 * torch.sigmoid(ts[1] * thetas[:, 1] + tm[1])
        c0, c1 = material_coeffs(model.stype, E, v)
        u = solve_free(c0, c1)  # (B, ndof)
        y = u[:, obs_dofs]
        eps3 = torch.einsum("qai,bi->bqa", B_probe, u[:, lm_probe])
        sig6 = stress6_plane_strain(eps3, c0[:, None], c1[:, None])
        return y, von_mises_reference(sig6)

    return fh
