"""Differentiable batched solvers for the affine operator K(c) = c0*A + c1*B
(counterpart of ``vbicm_tpu/ops/solve.py``): the spectral pencil solver for
dense models, and matrix-free preconditioned CG for refined meshes.

Spectral solver (``make_spectral_affine_solver``).

With A = parts[0] symmetric PSD (the lam-part of the stiffness) and
B = parts[1] SPD (the mu-part), the generalized eigenproblem A V = B V diag(g)
is solved once on the host in float64 (``scipy.linalg.eigh``, so V^T B V =
I). Then for every coefficient pair

    K(c)^-1 b = V diag(1 / (c0*g + c1)) V^T b,

which is the batched kernel of ``ops.spectral_kernel``. ``apply_dtype``
picks the precision of that apply; ``refine_iters`` polishes the answer
through residuals taken in the model dtype, ``r = b - K(c) x``. The backward
pass is the adjoint solve in eigen-coordinates: with a the forward
coordinates and w, b' = the adjoint's solution and coordinates,

    fbar = w,   cbar = -(sum_i g_i a_i b'_i, sum_i a_i b'_i),

since w^T A x = sum g a b' and w^T B x = sum a b'. Every solve, forward,
refinement and adjoint, goes through the kernel.
"""
from __future__ import annotations

import numpy as np
import scipy.linalg
import torch

from .assembly import jacobi_diagonal
from .element_kernel import ElementOperator
from .spectral_kernel import spectral_apply_batched


class SpectralAffineSolver:
    """``solve(coeffs (B, 2), f (B, n)) -> x (B, n)`` with the adjoint
    backward pass; built by :func:`make_spectral_affine_solver`."""

    def __init__(self, parts: torch.Tensor, apply_dtype, refine_iters: int):
        if parts.ndim != 3 or parts.shape[0] != 2:
            raise ValueError("spectral solver requires exactly 2 affine parts")
        parts_np = parts.detach().cpu().numpy().astype(np.float64)
        g, V = scipy.linalg.eigh(parts_np[0], parts_np[1])
        adt = parts.dtype if apply_dtype is None else apply_dtype
        self.parts = parts
        self.V = torch.as_tensor(V, device=parts.device).to(adt).contiguous()
        self.Vt = self.V.T.contiguous()
        self.g = torch.as_tensor(g, device=parts.device).to(adt)
        self.refine_iters = int(refine_iters)

    def _affine_matvec(self, coeffs, x):
        """K(c) x per sample, in x's dtype (the parts are symmetric)."""
        c = coeffs.to(x.dtype)
        return c[:, :1] * (x @ self.parts[0]) + c[:, 1:2] * (x @ self.parts[1])

    def coords_and_apply(self, coeffs, b):
        """(x, a): x = K(c)^-1 b in b's dtype, a its eigen-coordinates."""
        adt = self.V.dtype
        ca = coeffs.to(adt).contiguous()

        def apply(rhs):
            return spectral_apply_batched(self.V, self.g, ca, rhs.to(adt).contiguous(),
                                          return_coords=True, Vt=self.Vt)

        x, a = apply(b)
        x = x.to(b.dtype)
        for _ in range(self.refine_iters):
            dx, da = apply(b - self._affine_matvec(coeffs, x))
            a = a + da
            x = x + dx.to(b.dtype)
        return x, a

    def __call__(self, coeffs, f):
        return _SpectralSolve.apply(coeffs, f, self)


class _SpectralSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, coeffs, f, solver):
        x, a = solver.coords_and_apply(coeffs, f)
        ctx.save_for_backward(coeffs, a)
        ctx.solver = solver
        return x

    @staticmethod
    def backward(ctx, xbar):
        coeffs, a = ctx.saved_tensors
        solver = ctx.solver
        w, b = solver.coords_and_apply(coeffs, xbar)
        cbar = None
        if ctx.needs_input_grad[0]:
            ab = a * b
            cbar = -torch.stack([(solver.g * ab).sum(-1), ab.sum(-1)], dim=-1).to(coeffs.dtype)
        return cbar, w, None


def make_spectral_affine_solver(parts, *, apply_dtype=None, refine_iters: int = 0):
    """Differentiable batched solver for ``(c0*A + c1*B) u = f``.

    parts: (2, n, n) tensor (A, B) on the device the solves run on.
    ``apply_dtype=torch.float32`` runs the kernel in float32;
    ``refine_iters`` refinements bring the result back to the parts' dtype.
    """
    return SpectralAffineSolver(parts, apply_dtype, refine_iters)


# ---------------------------------------------------------------------------
# Matrix-free preconditioned conjugate gradients (refined meshes)
# ---------------------------------------------------------------------------

# pcg reads back whether any lane is still active every this many iterations:
# each read is a device sync, and a frozen lane does not change, so the
# result does not depend on it.
_CHECK_EVERY = 8


def _dot(a, b):
    return torch.einsum("bi,bi->b", a, b)


def pcg(matvec, b, prec, *, tol=1e-12, maxiter=1000):
    """Batched preconditioned CG with the per-lane semantics of the JAX
    package's ``jax.vmap(pcg)``.

    ``matvec(x (B, n)) -> (B, n)`` already applies the free-dof mask;
    ``prec(r) -> z`` is the batched preconditioner. Each lane has its own
    right-hand-side normalization, its own convergence test
    ``||r||^2 <= tol^2 ||b||^2`` and its own breakdown flag (a non-positive
    or NaN ``p'Kp`` or ``(r, z)``, which freezes the lane for good); a lane
    that is converged, broken down or at ``maxiter`` keeps its state.

    Returns (x (B, n), iterations (B,) int64, residual_norm_sq (B,)).
    """
    rdt = b.dtype
    tiny = 1e-30 if rdt == torch.float32 else 1e-300
    scale = torch.sqrt(torch.clamp_min(_dot(b, b), tiny))
    b = b / scale[:, None]
    bnorm = torch.clamp_min(_dot(b, b), tiny)
    thresh = tol * tol * bnorm
    x = torch.zeros_like(b)
    r = b.clone()  # b - matvec(0)
    z = prec(r)
    p = z.clone()
    rz = _dot(r, z)
    rr = _dot(r, r)
    it = torch.zeros(b.shape[0], dtype=torch.int64, device=b.device)
    dead = torch.zeros(b.shape[0], dtype=torch.bool, device=b.device)
    for k in range(maxiter):
        active = ~(rr <= thresh) & ~dead  # a NaN residual stays active, as in JAX
        if k % _CHECK_EVERY == 0 and not bool(active.any()):
            break
        kp = matvec(p)
        denom = _dot(p, kp)
        bad = ~(denom > 0)  # catches <= 0 and NaN
        alpha = torch.where(bad, 0.0, rz / torch.where(denom == 0, 1.0, denom))
        # the state is updated in place, and only on active lanes
        a = active[:, None]
        torch.where(a, x + alpha[:, None] * p, x, out=x)
        r_n = r - alpha[:, None] * kp
        z_n = prec(r_n)
        rz_n = _dot(r_n, z_n)
        dead_n = dead | (active & (bad | ~(rz_n > 0)))
        beta = torch.where(dead_n, 0.0, rz_n / torch.where(rz == 0, 1.0, rz))
        torch.where(a, z_n + beta[:, None] * p, p, out=p)
        torch.where(a, r_n, r, out=r)
        torch.where(a, z_n, z, out=z)
        rz = torch.where(active & ~dead_n, rz_n, rz)
        rr = _dot(r, r)
        it += active
        dead = torch.where(active, dead_n, dead)
    return x * scale[:, None], it, rr * scale * scale


class MatfreeAffineSolver:
    """``solve(coeffs (B, P), f (B, ndof)) -> u (B, ndof)`` for
    ``K(c) u = f`` on the free dofs, with the adjoint backward pass; built by
    :func:`make_matfree_affine_solver`. ``last_cg_iters`` holds the per-lane
    CG iteration counts of the last solve's CG runs (the first solve and
    each refinement), as device tensors."""

    def __init__(self, ke_parts, lm, free_mask, ndof, *, tol, maxiter, cg_dtype, refine_iters,
                 preconditioner, affine_matvec, diag_parts, refine_residual):
        if refine_residual == "compensated":
            raise NotImplementedError(
                "refine_residual='compensated' is not ported: on the H100 the float64 "
                "residual is the cheaper one (PERF.md; ROADMAP Queue 1 item 12)")
        if refine_residual not in ("f64", "split_f32"):
            raise ValueError(f"unknown refine_residual {refine_residual!r}")
        wdt = ke_parts.dtype
        self.cg_dtype = wdt if cg_dtype is None else cg_dtype
        if refine_residual == "split_f32" and self.cg_dtype != torch.float32:
            raise ValueError("refine_residual='split_f32' needs cg_dtype=float32")
        # the element path's operator (blocks, dof map and incidence tables),
        # built once; a given affine_matvec (e.g. a stencil) replaces it
        self.element = (ElementOperator(ke_parts, lm, ndof, (wdt, self.cg_dtype))
                        if affine_matvec is None else None)
        self.ndof = int(ndof)
        self.tol = float(tol)
        self.maxiter = int(maxiter)
        self.refine_iters = int(refine_iters)
        self.refine_residual = refine_residual
        self.preconditioner = preconditioner
        self.affine_matvec = affine_matvec
        self.free_mask = free_mask
        self.mask_cg = free_mask.to(self.cg_dtype)
        if diag_parts is None:
            diag_parts = torch.stack([jacobi_diagonal(ke_parts[p], lm, ndof)
                                      for p in range(ke_parts.shape[0])])
        self.diag_parts = diag_parts.to(self.cg_dtype)
        self.last_cg_iters = []

    def affine(self, coeffs, u):
        """``K(c) u`` in u's dtype: the given fused apply, or the element
        path (the element kernel on CUDA tensors, ``ops.element_kernel``)."""
        if self.affine_matvec is not None:
            return self.affine_matvec(coeffs, u)
        return self.element.affine(coeffs, u)

    def _cg_once(self, coeffs, b):
        """One PCG solve in the CG dtype, for the masked rhs b."""
        mask = self.mask_cg
        c = coeffs.to(self.cg_dtype)

        def mv(x):
            return self.affine(c, x * mask) * mask + x * (1.0 - mask)

        d = c @ self.diag_parts
        d = torch.where(mask > 0, torch.where(d == 0, 1.0, d), 1.0)
        minv = 1.0 / d
        if self.preconditioner is not None:
            prec = lambda r: self.preconditioner(coeffs, minv, r)  # noqa: E731
        else:
            prec = lambda r: minv * r  # noqa: E731
        bc = (b * self.free_mask).to(self.cg_dtype)
        x, iters, _ = pcg(mv, bc, prec, tol=self.tol, maxiter=self.maxiter)
        self.last_cg_iters.append(iters)
        return x

    def _residual(self, coeffs, b, x):
        mask = self.free_mask
        if self.refine_residual == "split_f32":
            # x = x1 + x2 exactly in two float32 halves; the residual's error
            # is the float32 rounding of the two applies
            x1 = x.to(torch.float32)
            x2 = (x - x1.to(x.dtype)).to(torch.float32)
            q = (self.affine(coeffs, x1 * self.mask_cg).to(x.dtype)
                 + self.affine(coeffs, x2 * self.mask_cg).to(x.dtype))
            return (b - q) * mask
        # fixed-dof identity term cancels since x, r live on free dofs
        return b * mask - self.affine(coeffs, x * mask) * mask

    def solve_once(self, coeffs, b):
        self.last_cg_iters = []
        x = self._cg_once(coeffs, b).to(b.dtype)
        for _ in range(self.refine_iters):
            r = self._residual(coeffs, b, x)
            x = x + self._cg_once(coeffs, r).to(b.dtype)
        return x * self.free_mask

    def __call__(self, coeffs, f):
        return _MatfreeSolve.apply(coeffs, f, self)


class _MatfreeSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, coeffs, f, solver):
        u = solver.solve_once(coeffs, f)
        ctx.save_for_backward(coeffs, u)
        ctx.solver = solver
        return u

    @staticmethod
    def backward(ctx, ubar):
        coeffs, u = ctx.saved_tensors
        solver = ctx.solver
        w = solver.solve_once(coeffs, ubar)
        cbar = None
        if ctx.needs_input_grad[0]:
            # cbar_p = -<w, K_p u> on the free dofs, per sample: K_p u is the
            # affine apply with unit coefficients
            unit = torch.eye(coeffs.shape[1], dtype=u.dtype, device=u.device)
            cbar = torch.stack(
                [-_dot(w, solver.affine(unit[p].expand(u.shape[0], -1), u) * solver.free_mask)
                 for p in range(coeffs.shape[1])], dim=-1).to(coeffs.dtype)
        return cbar, w, None


def make_matfree_affine_solver(
    ke_parts,
    lm,
    free_mask,
    ndof: int,
    *,
    tol: float = 1e-12,
    maxiter: int = 2000,
    cg_dtype=None,
    refine_iters: int = 0,
    preconditioner=None,
    affine_matvec=None,
    diag_parts=None,
    refine_residual: str = "f64",
):
    """Differentiable batched matrix-free solver for the affine operator
    ``K(c) = sum_p c_p K_p`` (counterpart of the JAX package's
    ``make_matfree_affine_solver``).

    ke_parts (P, nele, edof, edof) element bases, lm (nele, edof), free_mask
    (ndof,) 0/1. ``solve(coeffs (B, P), f (B, ndof)) -> u (B, ndof)`` with
    zeros on the fixed dofs. Without ``affine_matvec`` every application,
    float32 and float64, is the element kernel (``ops.element_kernel``,
    two parts); ``affine_matvec(coeffs, u) -> K(c) u`` replaces it (e.g. the
    stencil kernel, ``ops.stencil``); pass ``diag_parts`` (P, ndof) with it.
    ``preconditioner(coeffs, diag_inv, r) -> z`` replaces Jacobi.

    Mixed precision: ``cg_dtype=torch.float32`` runs the CG in float32 and
    ``refine_iters`` refinements, with residuals taken in float64
    (``refine_residual="f64"``) or from two float32 applies of the split
    iterate (``"split_f32"``), bring the answer back. The backward pass is
    the same refined solve applied to the cotangent, w, and
    ``cbar_p = -<w, K_p u>``.
    """
    return MatfreeAffineSolver(ke_parts, lm, free_mask, ndof, tol=tol, maxiter=maxiter,
                               cg_dtype=cg_dtype, refine_iters=refine_iters,
                               preconditioner=preconditioner, affine_matvec=affine_matvec,
                               diag_parts=diag_parts, refine_residual=refine_residual)
