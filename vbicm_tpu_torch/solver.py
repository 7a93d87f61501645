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
from typing import Callable, Optional, Tuple

import numpy as np
import scipy.linalg
import torch

from .config import MaterialCard, ProblemConfig
from .model import FemModel
from .ops.element import material_coeffs, stress6_3d, stress6_plane_strain
from .ops.multigrid import (
    cooks_prolongation,
    make_gather_transfer,
    make_grid_transfer_nd,
    make_two_level_preconditioner,
)
from .ops.solve import (
    make_dense_affine_solver,
    make_matfree_affine_solver,
    make_spectral_affine_solver,
)
from .ops.spectral_kernel import spectral_apply_batched
from .ops.stencil import make_stencil_affine_matvec
from .ops.stencil3d import make_stencil_affine_matvec_3d
from .ops.vonmises import von_mises_reference
from .utils.trace import span


@dataclasses.dataclass(frozen=True)
class FemSolution:
    """Result of one forward analysis."""

    u: torch.Tensor  # (ndof,) nodal displacements, supports = 0
    strain: torch.Tensor  # (nele, nqpt, 6) [e11, e22, e33, g12, g23, g31]
    stress: torch.Tensor  # (nele, nqpt, 6) [s11, s22, s33, t12, t23, t31]
    reactions: torch.Tensor  # (ndof,) support reactions (nonzero on supp dofs)


_METHODS = ("spectral", "cholesky", "inverse")


def _check_method(method: str):
    """The JAX package's dense ``method``; ignored on matrix-free models (as
    there); any other value raises."""
    if method not in _METHODS:
        raise ValueError(f"unknown method {method!r}; expected one of {_METHODS}")


def make_solver(model: FemModel, *, method: str = "spectral", factor_dtype=None,
                refine_iters: int = 0, cg_tol: float = 1e-12,
                cg_maxiter: int = 4000) -> Callable:
    """Build ``solve_free(c0 (B,), c1 (B,)) -> u (B, ndof)`` for this model.

    Dense models: ``method="spectral"``, the spectral pencil (``ops.solve``),
    the JAX package's default, where ``factor_dtype`` selects the precision
    of its apply; or ``"cholesky"`` / ``"inverse"``, a factorization a
    sample (``ops.solve.make_dense_affine_solver``), K(c) built in
    ``factor_dtype``. Matrix-free models: Jacobi-PCG on the
    element operator (the element kernel on the GPU,
    ``ops.element_kernel``) at ``cg_tol`` and ``cg_maxiter``, whatever the
    method; ``factor_dtype`` is the CG's dtype, and ``refine_iters``
    refinements with float64 residuals bring the answer back to the model's.
    ``solve_free.solver`` is then the underlying
    ``ops.solve.MatfreeAffineSolver``."""
    _check_method(method)
    if not model.dense:
        base = make_matfree_affine_solver(
            torch.stack([model.ke_lam, model.ke_mu]), model.lm, model.free_mask, model.ndof,
            tol=cg_tol, maxiter=cg_maxiter, cg_dtype=factor_dtype, refine_iters=refine_iters)
        return _matfree_solve_free(model, base)
    parts = torch.stack([model.k_lam_ff, model.k_mu_ff])
    if method == "spectral":
        base = make_spectral_affine_solver(parts, apply_dtype=factor_dtype,
                                           refine_iters=refine_iters)
    else:
        base = make_dense_affine_solver(parts, factor_dtype=factor_dtype,
                                        refine_iters=refine_iters, method=method)
    embed = _make_free_embed(model)

    def solve_free(c0, c1):
        coeffs = torch.stack([c0, c1], dim=-1)
        # the load on the free dofs; constant, since prescribed displacements
        # (the JAX package's Dirichlet lift) are not ported yet
        return embed(base(coeffs, model.f_free.expand(c0.shape[0], -1)))

    return solve_free


def _matfree_solve_free(model: FemModel, base) -> Callable:
    """``solve_free(c0, c1)`` on a matrix-free solver ``base`` (full-dof
    vectors), with ``solve_free.solver = base``."""
    # the full-dof load on the free dofs; prescribed displacements (the JAX
    # package's Dirichlet lift) are not ported, so it is constant
    f_masked = model.f_ext * model.free_mask

    def solve_free(c0, c1):
        return base(torch.stack([c0, c1], dim=-1), f_masked.expand(c0.shape[0], -1))

    solve_free.solver = base
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


def _stress6(model: FemModel, eps, c0, c1):
    """The 6-stress of the model's section from its B-matrix strain: the
    in-plane 3-strain in plane strain, the full 6-strain for the solid."""
    if model.stype == 4:
        return stress6_3d(eps, c0, c1)
    return stress6_plane_strain(eps, c0, c1)


def recover_fields(model: FemModel, u, c0, c1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(element, qpt) strain/stress 6-vectors from one displacement
    field u (ndof,); (c0, c1) = (lam, mu). Plane strain stores e33 = 0 but
    s33 = lam*(e11+e22); the solid's B already gives the 6-strain."""
    ue = u[model.lm]  # (nele, edof)
    eps3 = torch.einsum("eqai,ei->eqa", model.B, ue)
    sig6 = _stress6(model, eps3, c0, c1)
    if model.stype == 4:
        return eps3, sig6
    zero = torch.zeros_like(eps3[..., 0])
    eps6 = torch.stack([eps3[..., 0], eps3[..., 1], zero, eps3[..., 2], zero, zero], dim=-1)
    return eps6, sig6


def fea_solution(model: FemModel, material: MaterialCard = MaterialCard(), *,
                 solve_free: Optional[Callable] = None) -> FemSolution:
    """Full forward analysis for one material (reference ``fea_solution``);
    ``solve_free(c0 (B,), c1 (B,)) -> u (B, ndof)`` overrides
    :func:`make_solver` (e.g. :func:`make_two_level_solver`)."""
    c0, c1 = material_coeffs(model.stype, material.E, material.v)
    c0 = torch.tensor([c0], dtype=model.dtype, device=model.device)
    c1 = torch.tensor([c1], dtype=model.dtype, device=model.device)
    if solve_free is None:
        solve_free = make_solver(model)
    u = solve_free(c0, c1)[0]
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
    return von_mises_reference(_stress6(model, eps3, c0, c1))


def make_fh_fun(
    model: FemModel,
    cfg: ProblemConfig = ProblemConfig(),
    *,
    method: str = "spectral",
    factor_dtype=None,
    refine_iters: int = 0,
    cg_tol: float = 1e-12,
    cg_maxiter: int = 4000,
    solve_free: Optional[Callable] = None,
) -> Callable:
    """Build the batched observation operator
    ``fh(thetas (B, 2)) -> (y (B, ndm), h (B, nq))``.

    E = exp(std0 * t0 + mean0), nu = 0.5 * sigmoid(std1 * t1 + mean1);
    y = the ``model.ndm`` displacements at ``cfg.node_id``; h = reference von Mises at
    ``cfg.ele_id``, qpts ``cfg.nipt_id``. Differentiable in thetas.
    ``method``, ``factor_dtype``, ``refine_iters``, ``cg_tol`` and
    ``cg_maxiter`` go to :func:`make_solver`;
    ``solve_free(c0 (B,), c1 (B,)) -> u (B, ndof)`` overrides it (e.g.
    :func:`make_two_level_solver`).
    """
    if solve_free is None:
        solve_free = make_solver(model, method=method, factor_dtype=factor_dtype,
                                 refine_iters=refine_iters, cg_tol=cg_tol,
                                 cg_maxiter=cg_maxiter)
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
    B_probe = model.B[cfg.ele_id - 1, q]  # (nq, 3, 8) | (nq, 6, 24)
    lm_probe = model.lm[cfg.ele_id - 1]

    def fh(thetas):
        with span("fh"):
            thetas = thetas.to(model.dtype)
            E = torch.exp(ts[0] * thetas[:, 0] + tm[0])
            v = 0.5 * torch.sigmoid(ts[1] * thetas[:, 1] + tm[1])
            c0, c1 = material_coeffs(model.stype, E, v)
            u = solve_free(c0, c1)  # (B, ndof)
            y = u[:, obs_dofs]
            eps3 = torch.einsum("qai,bi->bqa", B_probe, u[:, lm_probe])
            sig6 = _stress6(model, eps3, c0[:, None], c1[:, None])
            return y, von_mises_reference(sig6)

    return fh


class CoarseSpectralSolve:
    """Exact coarse-grid solve ``(coeffs (B, 2), r_full (B, ndof_c)) ->
    K_c(coeffs)^-1 r_full`` through the coarse pencil's eigenbasis and the
    spectral kernel, zeros on the coarse supports; the coarse part of the
    two-level preconditioner. It follows its input's dtype: float32 inside
    a float32 CG, float64 otherwise. The float32 apply keeps float32
    accuracy (3xTF32 on the card), the JAX package's default precision.

    ``free(coeffs, r_free (B, nfree)) -> (B, nfree)`` is the same solve on
    the free coarse dofs alone, in the order of ``free_dof`` (the coarse
    model's): the two-level preconditioner's fused form calls it with no
    gather or embed."""

    def __init__(self, coarse_model: FemModel):
        g, V = scipy.linalg.eigh(coarse_model.k_lam_ff.cpu().numpy(),
                                 coarse_model.k_mu_ff.cpu().numpy())
        device = coarse_model.device
        self._tables = {dt: (torch.as_tensor(V, dtype=dt, device=device).contiguous(),
                             torch.as_tensor(g, dtype=dt, device=device))
                        for dt in (torch.float32, torch.float64)}
        self.free_dof = coarse_model.free_dof
        self._embed = _make_free_embed(coarse_model)

    def free(self, coeffs, r_free):
        V_, g_ = self._tables[r_free.dtype]
        return spectral_apply_batched(V_, g_, coeffs.to(r_free.dtype).contiguous(), r_free)

    def __call__(self, coeffs, r_full):
        return self._embed(self.free(coeffs, r_full[:, self.free_dof].contiguous()))


def make_coarse_spectral_apply(coarse_model: FemModel) -> CoarseSpectralSolve:
    """The coarse model's :class:`CoarseSpectralSolve`."""
    return CoarseSpectralSolve(coarse_model)


def make_two_level_solver(
    model: FemModel,
    coarse_model: FemModel,
    nx_coarse: int,
    ny_coarse: int,
    ratio: int,
    *,
    cg_dtype=None,
    refine_iters: int = 0,
    tol: float = 1e-10,
    maxiter: int = 500,
    omega: float = 0.6,
    use_stencil: bool = False,
    refine_residual: str = "f64",
    cycle: str = "additive",
    transfer: str = "conv",
    with_rhs_solver: bool = False,
) -> Callable:
    """Matrix-free solver with the spectral-coarse two-level preconditioner,
    the full-order path for refined Cook's meshes. Returns
    ``solve_free(c0 (B,), c1 (B,)) -> u (B, ndof)`` with the adjoint
    backward pass; ``solve_free.solver`` is the underlying
    ``ops.solve.MatfreeAffineSolver`` (its ``last_cg_iters``).

    The fine grid is (nx_coarse*ratio, ny_coarse*ratio); the coarse solve
    runs through the spectral kernel (:func:`make_coarse_spectral_apply`).
    With ``use_stencil=True`` the CG runs in structured-grid form: K(c) as
    the stencil kernel (``ops.stencil``), the transfers as the 1-D hat
    products of ``ops.multigrid.make_grid_transfer_nd`` on the (ny, nx)
    grid. With ``use_stencil=False`` (the element path) K(c) is the element
    kernel (``ops.element_kernel``) and the transfers are the gather
    transfers of ``ops.multigrid.make_gather_transfer`` on the
    :func:`ops.multigrid.cooks_prolongation` tables. ``cg_dtype``,
    ``refine_iters`` and ``refine_residual`` ("f64" or "split_f32") are
    those of ``ops.solve.make_matfree_affine_solver``.

    Only ``cycle="additive"`` and ``transfer="conv"`` are ported; the JAX
    package's other options raise (a ``transfer`` other than "conv" on the
    element path raises ``ValueError``, as there). Its
    ``coarse_f32_precision`` is not taken: the float32 coarse apply here
    always keeps float32 accuracy (3xTF32 on the card).
    """
    if not use_stencil and transfer != "conv":
        raise ValueError(f"transfer={transfer!r} needs use_stencil=True")
    if transfer != "conv":
        raise NotImplementedError(f"transfer={transfer!r} is not ported (only 'conv'); "
                                  "ROADMAP Queue 1 item 12")
    _check_two_level_options(cycle, with_rhs_solver)
    if use_stencil:
        affine, _, diag_parts = make_stencil_affine_matvec(model, nx_coarse * ratio,
                                                           ny_coarse * ratio)
        transfer_ops = make_grid_transfer_nd((ny_coarse, nx_coarse), ratio, 2,
                                             device=model.device)
    else:
        if model.ndof != 2 * (nx_coarse * ratio + 1) * (ny_coarse * ratio + 1):
            raise ValueError("model does not match the refined Cook's grid of the transfers")
        # the matrix-free solver's own element operator and Jacobi diagonal
        affine = diag_parts = None
        transfer_ops = make_gather_transfer(*cooks_prolongation(nx_coarse, ny_coarse, ratio),
                                            device=model.device)
    return _two_level_solve_free(model, coarse_model, affine, diag_parts, transfer_ops,
                                 cg_dtype=cg_dtype, refine_iters=refine_iters, tol=tol,
                                 maxiter=maxiter, omega=omega, refine_residual=refine_residual)


def make_two_level_solver_box3d(
    model: FemModel,
    coarse_model: FemModel,
    cells_coarse,
    ratio: int,
    *,
    cg_dtype=None,
    refine_iters: int = 0,
    tol: float = 1e-10,
    maxiter: int = 500,
    omega: float = 0.6,
    refine_residual: str = "f64",
    cycle: str = "additive",
    with_rhs_solver: bool = False,
) -> Callable:
    """Two-level (spectral-coarse + Jacobi) matrix-free solver for
    structured hex8 box meshes (``mesh/solid3d.py`` numbering), the 3-D
    sibling of :func:`make_two_level_solver`. Returns ``solve_free(c0 (B,),
    c1 (B,)) -> u (B, ndof)`` with the adjoint backward pass;
    ``solve_free.solver`` is the underlying ``ops.solve.
    MatfreeAffineSolver``.

    ``cells_coarse`` = coarse (nx, ny, nz) cell counts; the fine model must
    be the same box at ``cells_coarse * ratio``. The CG runs K(c) as the
    27-point stencil kernel (``ops.stencil3d``), the transfers as the
    tensor-product hat products of ``ops.multigrid.make_grid_transfer_nd``
    and the coarse solve through the spectral kernel. ``cg_dtype``,
    ``refine_iters`` and ``refine_residual`` ("f64" or "split_f32") are
    those of ``ops.solve.make_matfree_affine_solver``.

    The JAX package's ``use_pallas`` and ``coarse_f32_precision`` are not
    taken: on CUDA tensors the kernel always runs, and the float32 coarse
    apply keeps float32 accuracy (3xTF32 on the card). ``cycle="vcycle"``
    and ``with_rhs_solver`` raise.
    """
    _check_two_level_options(cycle, with_rhs_solver)
    ncx, ncy, ncz = cells_coarse
    affine, diag_parts = make_stencil_affine_matvec_3d(model, ncx * ratio, ncy * ratio,
                                                       ncz * ratio)
    transfer_ops = make_grid_transfer_nd((ncz, ncy, ncx), ratio, 3, device=model.device)
    return _two_level_solve_free(model, coarse_model, affine, diag_parts, transfer_ops,
                                 cg_dtype=cg_dtype, refine_iters=refine_iters, tol=tol,
                                 maxiter=maxiter, omega=omega, refine_residual=refine_residual)


def _check_two_level_options(cycle, with_rhs_solver):
    if cycle != "additive":
        raise NotImplementedError(f"cycle={cycle!r} is not ported (only 'additive'); "
                                  "ROADMAP Queue 1 item 12")
    if with_rhs_solver:
        raise NotImplementedError("with_rhs_solver (the modal solver's rhs solve) is not "
                                  "ported; ROADMAP Queue 1 item 9")


def _two_level_solve_free(model, coarse_model, affine, diag_parts, transfer_ops, *, cg_dtype,
                          refine_iters, tol, maxiter, omega, refine_residual):
    """The two-level solve shared by the 2-D (stencil and element path) and
    3-D solvers: the additive preconditioner around the matrix-free CG."""
    prec = make_two_level_preconditioner(make_coarse_spectral_apply(coarse_model),
                                         model.free_mask, transfer_ops, omega=omega)
    base = make_matfree_affine_solver(
        torch.stack([model.ke_lam, model.ke_mu]),
        model.lm,
        model.free_mask,
        model.ndof,
        tol=tol,
        maxiter=maxiter,
        cg_dtype=cg_dtype,
        refine_iters=refine_iters,
        preconditioner=prec,
        affine_matvec=affine,
        diag_parts=diag_parts,
        refine_residual=refine_residual,
    )
    return _matfree_solve_free(model, base)
