"""Differentiable batched solvers for the affine operator K(c) = c0*A + c1*B
(counterpart of ``vbicm_tpu/ops/solve.py``): the spectral pencil solver for
dense models, the dense Cholesky and explicit-inverse solvers, and
matrix-free preconditioned CG for refined meshes.

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

Second derivatives (a Hessian through the solve, ``create_graph=True``):
the backward pass then takes the adjoint solve through the solve itself,
and the coefficient cotangent in the full space, ``cbar = -(w^T A x,
w^T B x)`` with the saved output x, so that autograd can differentiate the
backward pass; without a graph it is the eigen-coordinate form above. The
matrix-free affine solve and the per-element field solve do the same.

Field solver (``make_field_solver``): matrix-free PCG for the operator
``K(E) = sum_e E_e ke_unit_e`` of a per-element coefficient field (the
random-field family, ``prob.randomfield``), batched over fields.
"""
from __future__ import annotations

import functools

import numpy as np
import scipy.linalg
import torch
import torch.nn.functional as F

from ..utils.trace import count, span
from .assembly import dof_incidence, jacobi_diagonal
from .cg_update_kernel import CgUpdateKernel, CgUpdatePlain
from .cg_update_kernel import dot as _dot
from .element_kernel import ElementOperator
from .spectral_kernel import spectral_apply_batched


class DenseAffineSolver:
    """``solve(coeffs (B, P), f (B, n)) -> u (B, n)`` for ``K(c) = sum_p c_p
    parts_p`` by a per-sample factorization, with the adjoint backward pass;
    built by :func:`make_dense_affine_solver`."""

    def __init__(self, parts: torch.Tensor, factor_dtype, refine_iters: int, method: str):
        if method == "auto":
            method = "inverse" if factor_dtype is not None else "cholesky"
        if method not in ("cholesky", "inverse"):
            raise ValueError(f"unknown dense method {method!r}")
        self.parts = parts
        self.parts_f = parts if factor_dtype is None else parts.to(factor_dtype)
        self.refine_iters = int(refine_iters)
        self.method = method

    def affine_matvec(self, coeffs, x):
        """``sum_p c_p (parts_p x)`` per sample in x's dtype, through the
        parts (no (B, n, n) matrix in that dtype)."""
        px = torch.einsum("pij,bj->pbi", self.parts.to(x.dtype), x)
        c = coeffs.to(x.dtype)
        return sum(c[:, p, None] * px[p] for p in range(px.shape[0]))

    def factor(self, coeffs):
        """K(c) built in the factor dtype and factored: its lower Cholesky
        factor, or K^-1 formed from it (one n-column triangular solve pair).
        ``cholesky_ex`` does not read its status back (no host sync); a
        matrix that is not positive definite gives NaN, as ``cho_factor``."""
        pf = self.parts_f
        c = coeffs.to(pf.dtype)
        K = sum(c[:, p, None, None] * pf[p] for p in range(pf.shape[0]))
        L, _ = torch.linalg.cholesky_ex(K)
        if self.method == "inverse":
            eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
            return torch.cholesky_solve(eye.expand_as(K), L)
        return L

    def _apply(self, op, b):
        if self.method == "inverse":
            return (op @ b[..., None])[..., 0]
        return torch.cholesky_solve(b[..., None], op)[..., 0]

    def solve_refined(self, op, coeffs, b):
        """K(c)^-1 b in b's dtype: the factor's solve, then ``refine_iters``
        corrections from residuals taken through the parts in b's dtype."""
        fdt = op.dtype
        x = self._apply(op, b.to(fdt)).to(b.dtype)
        for _ in range(self.refine_iters):
            r = b - self.affine_matvec(coeffs, x)
            x = x + self._apply(op, r.to(fdt)).to(b.dtype)
        return x

    def __call__(self, coeffs, f):
        return _DenseSolve.apply(coeffs, f, self)


class _DenseSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, coeffs, f, solver):
        op = solver.factor(coeffs)
        u = solver.solve_refined(op, coeffs, f)
        ctx.save_for_backward(coeffs, u)
        ctx.solver, ctx.op = solver, op
        return u

    @staticmethod
    def backward(ctx, ubar):
        coeffs, u = ctx.saved_tensors
        solver = ctx.solver
        if torch.is_grad_enabled():
            # create_graph: the adjoint solve through the solve itself, so
            # that the backward pass can be differentiated (u is tracked)
            w = _DenseSolve.apply(coeffs, ubar, solver)
        else:
            w = solver.solve_refined(ctx.op, coeffs, ubar)
        cbar = None
        if ctx.needs_input_grad[0]:
            # cbar_p = -w^T (parts_p u), per sample
            pu = torch.einsum("pij,bj->bpi", solver.parts.to(u.dtype), u)
            cbar = -torch.einsum("bpi,bi->bp", pu, w).to(coeffs.dtype)
        return cbar, w, None


def make_dense_affine_solver(parts, *, factor_dtype=None, refine_iters: int = 0,
                             method: str = "auto"):
    """Differentiable batched solver for ``(sum_p c_p parts_p) u = f`` by a
    per-sample factorization (counterpart of the JAX package's
    ``make_dense_affine_solver``).

    parts: (P, n, n) symmetric positive-definite basis on the device the
    solves run on. Returns ``solve(coeffs (B, P), f (B, n)) -> u (B, n)``.
    ``method``: "cholesky" (every apply two triangular solves), "inverse"
    (K^-1 formed once a factorization, every apply a matvec) or "auto"
    ("inverse" with ``factor_dtype``, else "cholesky"). K(c) is built
    directly in ``factor_dtype``; ``refine_iters`` refinements with
    residuals through the parts in the right-hand side's dtype bring the
    answer back. The backward pass is the same refined solve applied to the
    cotangent, w, and ``cbar_p = -w^T (parts_p u)``. The factorization and
    triangular solves are ``torch.linalg``'s (the JAX package's are XLA's,
    not a Pallas kernel).
    """
    return DenseAffineSolver(parts, factor_dtype, refine_iters, method)


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
                                          return_coords=True)

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
        ctx.save_for_backward(coeffs, a, x)
        ctx.solver = solver
        return x

    @staticmethod
    def backward(ctx, xbar):
        coeffs, a, x = ctx.saved_tensors
        solver = ctx.solver
        if torch.is_grad_enabled():
            # create_graph: every tensor below is tracked, so the backward
            # pass can be differentiated (the JAX bwd, written in the full
            # space; x is this solve's tracked output)
            w = _SpectralSolve.apply(coeffs, xbar, solver)
            cbar = None
            if ctx.needs_input_grad[0]:
                cbar = -torch.stack([(w * (x @ P.to(x.dtype))).sum(-1) for P in solver.parts],
                                    dim=-1).to(coeffs.dtype)
            return cbar, w, None
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


def pcg(matvec, b, prec, *, tol=1e-12, maxiter=1000):
    """Batched preconditioned CG with the per-lane semantics of the JAX
    package's ``jax.vmap(pcg)``.

    ``matvec(x (B, n)) -> (B, n)`` already applies the free-dof mask;
    ``prec(r) -> z`` is the batched preconditioner. Each lane has its own
    right-hand-side normalization, its own convergence test
    ``||r||^2 <= tol^2 ||b||^2`` and its own breakdown flag (a non-positive
    or NaN ``p'Kp`` or ``(r, z)``, which freezes the lane for good); a lane
    that is converged, broken down or at ``maxiter`` keeps its state.

    Every lane runs each iteration of the loop until the last one
    converges; :func:`pcg_loop` gives the loop's steps and its reads of
    whether a lane is still active from the returned iterations. A loop
    step's vector work is ``ops.cg_update_kernel``'s two steps: on CUDA
    tensors its kernel pair, two launches a step; on CPU tensors the plain
    version. Spans (``utils.trace``): ``cg.matvec``, ``cg.update`` (around
    each of the two steps) and ``cg.check`` inside the loop; counters
    ``pcg.steps.fused`` and ``pcg.steps.plain``, the loop steps each way.

    Returns (x (B, n), iterations (B,) int64, residual_norm_sq (B,)).
    """
    if b.device.type == "cpu":
        return _pcg(matvec, b, prec, tol, maxiter, CgUpdatePlain, "pcg.steps.plain")
    with torch.cuda.device(b.device):
        return _pcg(matvec, b, prec, tol, maxiter, CgUpdateKernel, "pcg.steps.fused")


def _pcg(matvec, b, prec, tol, maxiter, update, counter):
    """:func:`pcg` with the loop's state and steps in ``update``
    (``CgUpdatePlain`` or ``CgUpdateKernel``), its steps counted in
    ``counter``."""
    rdt = b.dtype
    tiny = 1e-30 if rdt == torch.float32 else 1e-300
    scale = torch.sqrt(torch.clamp_min(_dot(b, b), tiny))
    b = (b / scale[:, None]).contiguous()
    bnorm = torch.clamp_min(_dot(b, b), tiny)
    thresh = tol * tol * bnorm
    x = torch.zeros_like(b)
    r = b.clone()  # b - matvec(0)
    z = prec(r)
    p = z.clone(memory_format=torch.contiguous_format)
    rz = _dot(r, z)
    rr = _dot(r, r)
    it = torch.zeros(b.shape[0], dtype=torch.int64, device=b.device)
    dead = torch.zeros(b.shape[0], dtype=torch.bool, device=b.device)
    state = update(x, r, p, rz, rr, thresh, it, dead)
    steps = 0
    for k in range(maxiter):
        if k % _CHECK_EVERY == 0:
            with span("cg.check"):
                done = not bool(state.active.any())
            if done:
                break
        with span("cg.matvec"):
            kp = matvec(p)
        with span("cg.update"):
            r_p = state.alpha(kp)
        z = prec(r_p)
        with span("cg.update"):
            state.beta(z)
        steps += 1
    count(counter, steps)
    return x * scale[:, None], it, state.rr * scale * scale


def pcg_loop(iters, maxiter=None):
    """(loop steps, activity reads) of the :func:`pcg` run whose lanes took
    ``iters`` iterations (its returned counts, one a lane): a lane is active
    until it stops for good and the loop reads every ``_CHECK_EVERY``
    iterations, so it ran the slowest lane's count rounded up to a multiple
    of that, cut at ``maxiter`` (None: never cut), and read once each time
    it looked."""
    steps = -(-int(iters.max()) // _CHECK_EVERY) * _CHECK_EVERY if len(iters) else 0
    if maxiter is not None and steps >= maxiter:
        return maxiter, -(-maxiter // _CHECK_EVERY)
    return steps, steps // _CHECK_EVERY + 1


def pcg_lane_use(runs, maxiter=None):
    """The share (%) of the batched loops' lane iterations that did work,
    over :func:`pcg` runs (each its per-lane iterations): the lanes'
    iterations over B times the loop's steps (:func:`pcg_loop`); None
    without a step."""
    done = slots = 0
    for it in runs:
        done += int(it.sum())
        slots += len(it) * pcg_loop(it, maxiter)[0]
    return 100.0 * done / slots if slots else None


def _masked(op, mask, x):
    """``op`` on the free dofs of x (``mask`` 1) and the identity on the
    fixed ones."""
    return op(x * mask) * mask + x * (1.0 - mask)


class _MatfreeSolver:
    """The matrix-free solve that :class:`MatfreeAffineSolver` and
    :class:`FieldSolver` share: PCG in the CG dtype on the free dofs with
    the Jacobi inverse diagonal handed to ``preconditioner(coeffs, diag_inv,
    r) -> z`` (None: Jacobi), ``refine_iters`` refinements, and the adjoint
    backward pass (:class:`_MatfreeSolve`). A solver gives its operator and
    diagonal in the CG dtype (``_operator``), its refinement residual
    (``_residual``) and its coefficient cotangent (``cotangent``).
    ``last_cg_iters`` holds the per-lane CG iteration counts of the last
    solve's CG runs (the first solve and each refinement), as device
    tensors."""

    def __init__(self, free_mask, ndof, *, tol, maxiter, cg_dtype, refine_iters, preconditioner):
        self.cg_dtype = cg_dtype
        self.free_mask = free_mask
        self.mask_cg = free_mask.to(cg_dtype)
        self.ndof = int(ndof)
        self.tol = float(tol)
        self.maxiter = int(maxiter)
        self.refine_iters = int(refine_iters)
        self.preconditioner = preconditioner
        self.last_cg_iters = []

    def cg_operator(self, coeffs):
        """(matvec, diag_inv): the CG's operator for ``coeffs`` (identity on
        the fixed dofs) and its Jacobi inverse diagonal, in the CG dtype."""
        op, d = self._operator(coeffs)
        mask = self.mask_cg
        minv = 1.0 / torch.where(mask > 0, torch.where(d == 0, 1.0, d), 1.0)
        return functools.partial(_masked, op, mask), minv

    def _cg_once(self, coeffs, b):
        """One PCG solve in the CG dtype, for the masked rhs b."""
        with span("cg.run"):
            mv, minv = self.cg_operator(coeffs)
            if self.preconditioner is not None:
                prec = lambda r: self.preconditioner(coeffs, minv, r)  # noqa: E731
            else:
                prec = lambda r: minv * r  # noqa: E731
            bc = (b * self.free_mask).to(self.cg_dtype)
            x, iters, _ = pcg(mv, bc, prec, tol=self.tol, maxiter=self.maxiter)
        self.last_cg_iters.append(iters)
        return x

    def solve_once(self, coeffs, b):
        self.last_cg_iters = []
        x = self._cg_once(coeffs, b).to(b.dtype)
        for _ in range(self.refine_iters):
            with span("refine.residual"):
                r = self._residual(coeffs, b, x)
            x = x + self._cg_once(coeffs, r).to(b.dtype)
        return x * self.free_mask

    def __call__(self, coeffs, f):
        return _MatfreeSolve.apply(coeffs, f, self)


class _MatfreeSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, coeffs, f, solver):
        with span("solve.forward"):
            u = solver.solve_once(coeffs, f)
        ctx.save_for_backward(coeffs, u)
        ctx.solver = solver
        return u

    @staticmethod
    def backward(ctx, ubar):
        coeffs, u = ctx.saved_tensors
        solver = ctx.solver
        graph = torch.is_grad_enabled()
        # backward runs on the autograd engine's thread: the spans open there
        with span("solve.adjoint"):
            if graph:
                # create_graph: the adjoint solve through the solve itself and
                # the cotangent from the tracked output u, so that the
                # backward pass can be differentiated
                w = _MatfreeSolve.apply(coeffs, ubar, solver)
            else:
                w = solver.solve_once(coeffs, ubar)
        cbar = None
        if ctx.needs_input_grad[0]:
            with span("solve.cotangent"):
                cbar = solver.cotangent(coeffs, w, u, graph).to(coeffs.dtype)
        return cbar, w, None


class MatfreeAffineSolver(_MatfreeSolver):
    """``solve(coeffs (B, P), f (B, ndof)) -> u (B, ndof)`` for
    ``K(c) u = f`` on the free dofs, with the adjoint backward pass; built by
    :func:`make_matfree_affine_solver`."""

    def __init__(self, ke_parts, lm, free_mask, ndof, *, tol, maxiter, cg_dtype, refine_iters,
                 preconditioner, affine_matvec, diag_parts, refine_residual):
        if refine_residual == "compensated":
            raise NotImplementedError(
                "refine_residual='compensated' is not ported: on the H100 the float64 "
                "residual is the cheaper one (PERF.md; ROADMAP Queue 1 item 12)")
        if refine_residual not in ("f64", "split_f32"):
            raise ValueError(f"unknown refine_residual {refine_residual!r}")
        wdt = ke_parts.dtype
        cg_dtype = wdt if cg_dtype is None else cg_dtype
        if refine_residual == "split_f32" and cg_dtype != torch.float32:
            raise ValueError("refine_residual='split_f32' needs cg_dtype=float32")
        super().__init__(free_mask, ndof, tol=tol, maxiter=maxiter, cg_dtype=cg_dtype,
                         refine_iters=refine_iters, preconditioner=preconditioner)
        # the element path's operator (blocks, dof map and incidence tables),
        # built once; a given affine_matvec (e.g. a stencil) replaces it
        self.element = (ElementOperator(ke_parts, lm, ndof, (wdt, self.cg_dtype))
                        if affine_matvec is None else None)
        self.refine_residual = refine_residual
        self.affine_matvec = affine_matvec
        if diag_parts is None:
            diag_parts = torch.stack([jacobi_diagonal(ke_parts[p], lm, ndof)
                                      for p in range(ke_parts.shape[0])])
        self.diag_parts = diag_parts.to(self.cg_dtype)

    def affine(self, coeffs, u):
        """``K(c) u`` in u's dtype: the given fused apply, or the element
        path (the element kernel on CUDA tensors, ``ops.element_kernel``)."""
        if self.affine_matvec is not None:
            return self.affine_matvec(coeffs, u)
        return self.element.affine(coeffs, u)

    def _operator(self, coeffs):
        c = coeffs.to(self.cg_dtype)
        return functools.partial(self.affine, c), c @ self.diag_parts

    def _residual(self, coeffs, b, x):
        mask = self.free_mask
        if self.refine_residual == "split_f32":
            # x = x1 + x2 exactly in two float32 halves; the residual's
            # error is the float32 rounding of the two applies
            x1 = x.to(torch.float32)
            x2 = (x - x1.to(x.dtype)).to(torch.float32)
            q = (self.affine(coeffs, x1 * self.mask_cg).to(x.dtype)
                 + self.affine(coeffs, x2 * self.mask_cg).to(x.dtype))
            return (b - q) * mask
        # fixed-dof identity term cancels since x, r live on free dofs
        return b * mask - self.affine(coeffs, x * mask) * mask

    def cotangent(self, coeffs, w, u, graph):
        """``cbar_p = -<w, K_p u>`` on the free dofs, per sample: K_p u is
        the affine apply with unit coefficients, through :class:`_PartApply`
        under a graph."""
        unit = torch.eye(coeffs.shape[1], dtype=u.dtype, device=u.device)
        cbar = []
        for p in range(coeffs.shape[1]):
            c = unit[p].expand(u.shape[0], -1)
            ku = _PartApply.apply(u, c, self) if graph else self.affine(c, u)
            cbar.append(-_dot(w, ku * self.free_mask))
        return torch.stack(cbar, dim=-1)


class _PartApply(torch.autograd.Function):
    """``K(c) u`` for constant coefficients c through the solver's affine
    apply (a kernel on the card), differentiable in u: K(c) is symmetric,
    so the cotangent of u is ``K(c) g``."""

    @staticmethod
    def forward(ctx, u, c, solver):
        ctx.c, ctx.solver = c, solver
        return solver.affine(c, u)

    @staticmethod
    def backward(ctx, g):
        return _PartApply.apply(g, ctx.c, ctx.solver), None, None


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


# ---------------------------------------------------------------------------
# Per-element coefficient field solver (random-field inversion)
# ---------------------------------------------------------------------------


def _grid_layout(lm_np, ndof: int, grid):
    """(cells, node offsets) of a declared structured grid: ``grid`` (nx,
    ny) is the quad4 numbering of ``mesh/cooks.py`` (node row*(nx+1)+col,
    element r*nx+c, conn (n0, n0+1, n0+nx+2, n0+nx+1)), (nx, ny, nz) the
    hex8 numbering of ``mesh/solid3d.py`` (node (k*(ny+1)+j)*(nx+1)+i,
    element (k*ny+j)*nx+i, bottom quad counter-clockwise then top). cells
    are memory-major ((ny, nx) or (nz, ny, nx)); each offset is a conn
    slot's node in cells. A dof map that does not follow the layout raises
    ``ValueError``."""
    nd = len(grid)
    if nd == 2:
        lpos = ((0, 0), (0, 1), (1, 1), (1, 0))
    elif nd == 3:
        lpos = ((0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0),
                (1, 0, 0), (1, 0, 1), (1, 1, 1), (1, 1, 0))
    else:
        raise ValueError("grid must be (nx, ny) or (nx, ny, nz)")
    cells = tuple(int(c) for c in reversed(grid))
    Ns = tuple(c + 1 for c in cells)
    nele = int(np.prod(cells))
    if lm_np.shape[0] != nele or ndof != int(np.prod(Ns)) * nd:
        raise ValueError(f"lm/ndof do not match the declared {grid} grid")
    eidx = np.unravel_index(np.arange(nele), cells)
    nodes = np.stack([np.ravel_multi_index(tuple(eidx[a] + off[a] for a in range(nd)), Ns)
                      for off in lpos], axis=1)
    lm_expect = (nd * nodes[:, :, None] + np.arange(nd)).reshape(nele, nd * len(lpos))
    if not np.array_equal(lm_np, lm_expect):
        raise ValueError("lm table does not follow the structured-grid layout")
    return cells, lpos


class FieldSolver(_MatfreeSolver):
    """``solve(E (B, nele), f (B, ndof)) -> u (B, ndof)`` for ``K(E) u = f``
    on the free dofs with ``K(E) = sum_e E_e ke_unit_e``, the adjoint
    backward pass and its second derivative; built by
    :func:`make_field_solver`."""

    def __init__(self, ke_unit, lm, free_mask, ndof, *, tol, maxiter, cg_dtype, refine_iters,
                 preconditioner, grid):
        super().__init__(free_mask, ndof, tol=tol, maxiter=maxiter,
                         cg_dtype=ke_unit.dtype if cg_dtype is None else cg_dtype,
                         refine_iters=refine_iters, preconditioner=preconditioner)
        self.ke_unit = ke_unit
        self.ke_cg = ke_unit.to(self.cg_dtype)
        lm_np = np.asarray(lm.cpu() if isinstance(lm, torch.Tensor) else lm, dtype=np.int64)
        self.nele, self.edof = lm_np.shape
        device = ke_unit.device
        if grid is not None:
            self.cells, self.lpos = _grid_layout(lm_np, self.ndof, grid)
        else:
            self.cells = None
            self.lm = torch.as_tensor(lm_np, device=device)
            # each dof's element entries in increasing order, padded with the
            # index of a zero appended to the flat entries: the sums run in
            # a fixed order (no atomics on the card)
            row_ptr, ent = dof_incidence(lm_np, self.ndof)
            counts = np.diff(row_ptr)
            width = max(1, int(counts.max()))
            table = np.full((self.ndof, width), lm_np.size, dtype=np.int64)
            slot = np.arange(ent.size) - np.repeat(row_ptr[:-1], counts)
            table[np.repeat(np.arange(self.ndof), counts), slot] = ent
            self.table = torch.as_tensor(table, device=device)
        # per-element unit diagonals: the E-weighted Jacobi diagonal is one
        # scatter of scaled values
        self.diag_e = torch.diagonal(self.ke_cg, dim1=-2, dim2=-1)

    def gather(self, x):
        """(B, ndof) -> (B, nele, edof) element dof values."""
        if self.cells is None:
            return x[:, self.lm]
        B, nd = x.shape[0], len(self.cells)
        g = x.reshape(B, *(c + 1 for c in self.cells), nd)
        parts = [g[(slice(None),) + tuple(slice(o, o + c) for o, c in zip(off, self.cells))]
                 for off in self.lpos]
        return torch.cat(parts, dim=-1).reshape(B, self.nele, self.edof)

    def scatter(self, qe):
        """(B, nele, edof) -> (B, ndof), the sum of element contributions
        into the dofs, in a fixed order."""
        B = qe.shape[0]
        if self.cells is None:
            flat = torch.cat([qe.reshape(B, -1), qe.new_zeros((B, 1))], dim=1)
            return flat[:, self.table].sum(-1)
        nd = len(self.cells)
        q = qe.reshape(B, *self.cells, len(self.lpos), nd)
        out = None
        for li, off in enumerate(self.lpos):
            pad = [0, 0]  # F.pad runs from the last axis (the dof channel) back
            for o in reversed(off):
                pad += [o, 1 - o]
            t = F.pad(q[..., li, :], pad)
            out = t if out is None else out + t
        return out.reshape(B, self.ndof)

    def _products(self, ke, E, x):
        """``K(E) x`` in x's dtype: the element products with the constant
        blocks ke, each element's scaled by its E, scattered."""
        qe = torch.einsum("eij,bej->bei", ke, self.gather(x))
        return self.scatter(E[:, :, None].to(qe.dtype) * qe)

    def _operator(self, E):
        Ec = E.to(self.cg_dtype)
        return (functools.partial(self._products, self.ke_cg, Ec),
                self.scatter(Ec[:, :, None] * self.diag_e))

    def _residual(self, E, b, x):
        mask = self.free_mask
        return b * mask - _masked(functools.partial(self._products, self.ke_unit, E), mask,
                                  x) * mask

    def cotangent(self, E, w, u, graph):
        """``Ebar_e = -w_e^T (ke_unit_e u_e)`` per field, (B, nele)."""
        mask = self.free_mask
        ku = torch.einsum("eij,bej->bei", self.ke_unit, self.gather(u * mask))
        return -torch.einsum("bei,bei->be", self.gather(w * mask), ku)


def make_field_solver(
    ke_unit,
    lm,
    free_mask,
    ndof: int,
    *,
    tol: float = 1e-12,
    maxiter: int = 4000,
    cg_dtype=None,
    refine_iters: int = 0,
    preconditioner=None,
    grid=None,
):
    """Differentiable batched matrix-free solver for a per-element
    coefficient field (counterpart of the JAX package's
    ``make_field_solver``): ``K(E) = sum_e E_e ke_unit_e``, E (B, nele)
    positive.

    ke_unit (nele, edof, edof) unit-modulus element blocks, lm (nele, edof),
    free_mask (ndof,) 0/1. ``solve(E (B, nele), f (B, ndof)) -> u (B,
    ndof)`` with zeros on the fixed dofs. Each CG iteration gathers the
    element dofs, multiplies by the constant blocks (one einsum over the
    batch), scales each element's product by its E and scatters. The
    scatter runs in a fixed order, no atomics: ``grid=(nx, ny)`` or ``(nx,
    ny, nz)`` declares the structured quad4 or hex8 numbering (the lm table
    is checked against it, ``ValueError`` if it does not follow), and then
    gather and scatter are reshapes, 4 or 8 shifted slices and padded adds;
    without ``grid`` the scatter sums each dof's padded list of element
    entries. Jacobi-PCG, or ``preconditioner(E, diag_inv, r) -> z`` with the
    E-weighted Jacobi inverse (e.g. ``prob.randomfield.
    make_mean_field_preconditioner``).

    ``cg_dtype=torch.float32`` with ``refine_iters`` refinements (residuals
    in ke_unit's dtype) is the mixed-precision policy of
    :func:`make_matfree_affine_solver`. The backward pass is the same
    refined solve applied to the cotangent, w, and ``Ebar_e = -w_e^T
    (ke_unit_e u_e)``; under ``create_graph`` it builds a graph, so a
    Hessian runs through it. The field matvec is PyTorch ops: the JAX
    package's is XLA's, not a Pallas kernel.
    """
    return FieldSolver(ke_unit, lm, free_mask, ndof, tol=tol, maxiter=maxiter, cg_dtype=cg_dtype,
                       refine_iters=refine_iters, preconditioner=preconditioner, grid=grid)
