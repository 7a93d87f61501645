"""Structured-grid 27-point block-stencil matvec for hex8 box meshes
(counterpart of ``vbicm_tpu/ops/stencil3d.py``).

On the structured hex8 numbering of ``mesh/solid3d.py`` (node =
(k*(ny+1) + j)*(nx+1) + i) the assembled affine stiffness couples each node
only to its 26 grid neighbours, so ``K_p @ u`` is a 27-point stencil of 3x3
dof blocks:

    q[z, y, x, a] = sum_{dz,dy,dx} W_p[z, y, x, dz, dy, dx, a, b] * u[z+dz, y+dy, x+dx, b]

The tables are built once on the host in float64 by scattering the model's
element blocks by grid offset, so the stencil equals the assembled matvec to
rounding. The batched affine apply ``K(c) u`` runs the CUDA kernel of
``ops.stencil3d_kernel`` on the GPU in float32 and float64.
"""
from __future__ import annotations

import numpy as np
import torch

from .stencil3d_kernel import (
    pack_w_nodes_3d,
    stencil3d_affine_matvec,
    stencil3d_part_reference,
)

# local hex8 node (k, j, i) offsets for the conn order of mesh/solid3d.py:
# bottom quad CCW then top quad CCW
_LPOS = np.array([[0, 0, 0], [0, 0, 1], [0, 1, 1], [0, 1, 0],
                  [1, 0, 0], [1, 0, 1], [1, 1, 1], [1, 1, 0]])


def build_stencil_tables_3d(model, nx: int, ny: int, nz: int) -> np.ndarray:
    """Per-offset block tables W (2, NZ, NY, NX, 3, 3, 3, 3, 3) from the
    model's affine element stiffness parts. For one pair of local nodes
    (li, lj) every element adds to a different grid node, so each pair is
    one vectorized add, taken in the JAX package's (li, lj) order."""
    NX, NY, NZ = nx + 1, ny + 1, nz + 1
    nele = nx * ny * nz
    if model.nele != nele or model.ndof != NZ * NY * NX * 3:
        raise ValueError("model does not match the (nx, ny, nz) structured grid")
    ke = np.stack([model.ke_lam.detach().cpu().numpy(), model.ke_mu.detach().cpu().numpy()])
    ke = ke.astype(np.float64)  # (2, nele, 24, 24)
    kk, rem = np.divmod(np.arange(nele), ny * nx)
    jj, ii = np.divmod(rem, nx)
    W = np.zeros((ke.shape[0], NZ, NY, NX, 3, 3, 3, 3, 3))
    for li in range(8):
        iz, iy, ix = kk + _LPOS[li, 0], jj + _LPOS[li, 1], ii + _LPOS[li, 2]
        for lj in range(8):
            dz, dy, dx = _LPOS[lj] - _LPOS[li] + 1
            W[:, iz, iy, ix, dz, dy, dx] += ke[:, :, 3 * li:3 * li + 3, 3 * lj:3 * lj + 3]
    return W


def stencil_diagonal_3d(W) -> np.ndarray:
    """diag of K_p, (P, ndof): the centre offset's diagonal dof blocks."""
    W = np.asarray(W)
    return np.stack([np.stack([W[p, :, :, :, 1, 1, 1, a, a] for a in range(3)], axis=-1)
                     .reshape(-1) for p in range(W.shape[0])])


class StencilOperator3d:
    """The hex8-box operator of one model: the kernel's node-major
    coefficients ``planes`` (``ops.stencil3d_kernel.pack_w_nodes_3d``) on
    the model's device, by dtype (float32, float64); the block tables ``W``
    (2, NZ, NY, NX, 3, 3, 3, 3, 3), float64 on the host, which the plain
    version reads and the kernel does not; and the float64 diagonal
    ``diag`` (P, ndof) on the device."""

    def __init__(self, model, nx: int, ny: int, nz: int, W=None):
        if W is None:
            W = build_stencil_tables_3d(model, nx, ny, nz)
        device = model.device
        self.W = torch.as_tensor(W, dtype=torch.float64)
        self.diag = torch.as_tensor(stencil_diagonal_3d(W), device=device)  # (P, ndof) f64
        self.planes = {dt: torch.as_tensor(pack_w_nodes_3d(W, torch.finfo(dt).bits // 8),
                                           dtype=dt, device=device).contiguous()
                       for dt in (torch.float32, torch.float64)}
        self._host_tables = {torch.float64: self.W}

    def tables(self, dtype):
        """``W`` in dtype on the host (cached), the plain version's operand."""
        if dtype not in self._host_tables:
            self._host_tables[dtype] = self.W.to(dtype)
        return self._host_tables[dtype]

    def affine(self, coeffs, u):
        """``K(c) u`` for coeffs (B, 2) and u (B, ndof), in u's dtype: the
        kernel on CUDA tensors, its plain version on CPU tensors."""
        dt = u.dtype
        W = self.tables(dt) if u.device.type == "cpu" else self.W  # the kernel reads its shape
        return stencil3d_affine_matvec(W, self.planes[dt], coeffs.to(dt).contiguous(),
                                       u.contiguous())

    def part_matvec(self, p: int, x):
        """``K_p x`` for a batch x (B, ndof), as plain PyTorch (the 27-offset
        block stencil), in x's dtype on x's device."""
        return stencil3d_part_reference(self.tables(x.dtype)[p].to(x.device), x)


def make_stencil_part_matvec_3d(model, nx: int, ny: int, nz: int, W=None):
    """``(part_matvec(p, x), diag_parts)``: ``part_matvec`` applies the
    assembled ``K_p`` to a batch x (B, ndof) as a 27-point block stencil in
    x's dtype; ``diag_parts`` is (P, ndof) in float64."""
    op = StencilOperator3d(model, nx, ny, nz, W)
    return op.part_matvec, op.diag


def make_stencil_affine_matvec_3d(model, nx: int, ny: int, nz: int):
    """``(affine, diag_parts)`` for the box two-level solver:
    ``affine(coeffs (B, 2), u (B, ndof)) -> K(c) u`` through the 3-D
    stencil kernel (CUDA, float32 and float64) or its plain version (CPU);
    ``diag_parts`` is (P, ndof) in float64."""
    op = StencilOperator3d(model, nx, ny, nz)
    return op.affine, op.diag
