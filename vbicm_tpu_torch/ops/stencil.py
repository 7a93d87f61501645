"""Structured-grid block-stencil matvec for the affine FEM operator
(counterpart of ``vbicm_tpu/ops/stencil.py``).

On a structured quad4 grid (the Cook's family, ``mesh/cooks.py``: node id =
row*(nx+1)+col) the assembled stiffness couples each node only to its 8 grid
neighbours, so ``K_p @ u`` is a 9-point stencil of 2x2 dof blocks:

    q[y, x, a] = sum_{dy,dx in {-1,0,1}} W_p[y, x, dy, dx, a, b] * u[y+dy, x+dx, b]

The tables are built once on the host in float64 by scattering the model's
element blocks by grid offset, so the stencil equals the assembled matvec to
rounding. The batched affine apply ``K(c) u`` runs the CUDA kernel of
``ops.stencil_kernel`` on the GPU in float32 and float64.
"""
from __future__ import annotations

import numpy as np
import torch

from .stencil_kernel import pack_w_interleaved, stencil_affine_matvec, stencil_part_reference


def build_stencil_tables(model, nx: int, ny: int) -> np.ndarray:
    """Per-offset block-coefficient tables W (2, NY, NX, 3, 3, 2, 2) from
    the model's affine element stiffness parts, for the structured quad4
    numbering of ``mesh/cooks.py`` (element e = r*nx + c, conn
    (n0, n0+1, n0+nx+2, n0+nx+1))."""
    NY, NX = ny + 1, nx + 1
    nele = nx * ny
    if model.nele != nele or model.ndof != NY * NX * 2:
        raise ValueError("model does not match the (nx, ny) structured grid")
    ke = np.stack([model.ke_lam.detach().cpu().numpy(), model.ke_mu.detach().cpu().numpy()])
    ke = ke.astype(np.float64)
    P = ke.shape[0]
    rr, cc = np.divmod(np.arange(nele), nx)
    # local node (row, col) offsets for conn order (n0, n0+1, n0+nx+2, n0+nx+1)
    lpos = np.array([[0, 0], [0, 1], [1, 1], [1, 0]])
    W = np.zeros((P, NY, NX, 3, 3, 2, 2))
    for li in range(4):
        iy = rr + lpos[li, 0]
        ix = cc + lpos[li, 1]
        for lj in range(4):
            dy = lpos[lj, 0] - lpos[li, 0] + 1
            dx = lpos[lj, 1] - lpos[li, 1] + 1
            for p in range(P):
                for a in range(2):
                    for b in range(2):
                        np.add.at(W[p, :, :, dy, dx, a, b], (iy, ix),
                                  ke[p, :, 2 * li + a, 2 * lj + b])
    return W


def stencil_diagonal(W) -> np.ndarray:
    """diag of K_p, (P, ndof): the (dy, dx) = (0, 0) offset's diagonal dof
    blocks."""
    W = np.asarray(W)
    return np.stack([np.stack([W[p, :, :, 1, 1, a, a] for a in range(2)], axis=-1).reshape(-1)
                     for p in range(W.shape[0])])


class StencilOperator:
    """The structured-grid operator of one model on one device: the block
    tables ``W`` and the kernel's packed ``planes``, each by dtype (float32,
    float64), and the float64 diagonal ``diag`` (P, ndof)."""

    def __init__(self, model, nx: int, ny: int, W=None):
        if W is None:
            W = build_stencil_tables(model, nx, ny)
        device = model.device
        planes = pack_w_interleaved(W)
        self.diag = torch.as_tensor(stencil_diagonal(W), device=device)  # (P, ndof) f64
        self.W = {dt: torch.as_tensor(W, dtype=dt, device=device).contiguous()
                  for dt in (torch.float32, torch.float64)}
        self.planes = {dt: torch.as_tensor(planes, dtype=dt, device=device).contiguous()
                       for dt in (torch.float32, torch.float64)}

    def affine(self, coeffs, u, rows_per_block: int = 1):
        """``K(c) u`` for coeffs (B, 2) and u (B, ndof), in u's dtype: the
        kernel on CUDA tensors (``rows_per_block`` grid rows a block), its
        plain version on CPU tensors."""
        dt = u.dtype
        return stencil_affine_matvec(self.W[dt], self.planes[dt],
                                     coeffs.to(dt).contiguous(), u.contiguous(),
                                     rows_per_block=rows_per_block)

    def part_matvec(self, p: int, x):
        """``K_p x`` for a batch x (B, ndof), as plain PyTorch (the 9-offset
        block stencil), in x's dtype."""
        return stencil_part_reference(self.W[x.dtype][p], x)


def make_stencil_part_matvec(model, nx: int, ny: int, W=None):
    """``(part_matvec(p, x), diag_parts)``: ``part_matvec`` applies the
    assembled ``K_p`` to a batch x (B, ndof) as a 9-point block stencil in
    x's dtype; ``diag_parts`` is (P, ndof) in float64."""
    op = StencilOperator(model, nx, ny, W)
    return op.part_matvec, op.diag


def make_stencil_affine_matvec(model, nx: int, ny: int):
    """``(affine, part_matvec, diag_parts)`` for the two-level solver:
    ``affine(coeffs (B, 2), u (B, ndof)) -> K(c) u`` through the stencil
    kernel (CUDA, float32 and float64) or its plain version (CPU)."""
    op = StencilOperator(model, nx, ny)
    return op.affine, op.part_matvec, op.diag
