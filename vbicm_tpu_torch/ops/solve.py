"""Differentiable spectral solver for two-term affine pencils (counterpart of
``vbicm_tpu/ops/solve.py::make_spectral_affine_solver``).

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
