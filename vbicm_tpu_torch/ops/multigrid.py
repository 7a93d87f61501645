"""Two-level (coarse grid + Jacobi) preconditioning for refined Cook's meshes
(counterpart of ``vbicm_tpu/ops/multigrid.py``, the additive cycle with
conv-form transfers).

    M^-1 r = P K_c(lam, mu)^-1 P^T r + omega * D^-1 r

P is the bilinear index-space prolongation from the coarse (nx_c, ny_c) grid
to the fine (ratio*nx_c, ratio*ny_c) grid, exact for the Cook's geometry,
which is bilinear in the index map; K_c^-1 is the coarse model's exact
spectral solve for any (lam, mu); D is the fine Jacobi diagonal. Vectors are
batched, (B, ndof), dofs interleaved per node.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def cooks_prolongation(nx_c: int, ny_c: int, ratio: int):
    """Bilinear prolongation for Cook's meshes: coarse (nx_c x ny_c) ->
    fine (nx_c*ratio x ny_c*ratio). Returns (idx (nfine_nodes, 4) int32,
    w (nfine_nodes, 4) float64) with fine nodal value = sum_k w*coarse[idx].
    """
    nx_f, ny_f = nx_c * ratio, ny_c * ratio
    ncx = nx_c + 1
    idx = np.zeros(((nx_f + 1) * (ny_f + 1), 4), dtype=np.int32)
    w = np.zeros(((nx_f + 1) * (ny_f + 1), 4))
    for j in range(ny_f + 1):
        for i in range(nx_f + 1):
            n = j * (nx_f + 1) + i
            ic, fi = divmod(i, ratio)
            jc, fj = divmod(j, ratio)
            if ic == nx_c:  # right edge
                ic, fi = nx_c - 1, ratio
            if jc == ny_c:
                jc, fj = ny_c - 1, ratio
            s = fi / ratio
            t = fj / ratio
            base = jc * ncx + ic
            idx[n] = (base, base + 1, base + ncx, base + ncx + 1)
            w[n] = ((1 - s) * (1 - t), s * (1 - t), (1 - s) * t, s * t)
    return idx, w


def hat_matrix(n_fine: int, n_coarse: int, r: int) -> np.ndarray:
    """1-D bilinear interpolation matrix (n_fine, n_coarse):
    P[f, c] = max(0, 1 - |f - r*c| / r), the hat of width 2r - 1 centred on
    each coarse node, clipped at the grid's ends."""
    f = np.arange(n_fine)[:, None]
    c = np.arange(n_coarse)[None, :]
    return np.maximum(0.0, 1.0 - np.abs(f - r * c) / r)


def make_grid_transfer_conv(nx_c: int, ny_c: int, ratio: int, *, device="cpu"):
    """``(prolong, restrict)`` on batched flat dof vectors: the JAX
    package's conv-form transfers (a depthwise hat-kernel convolution with
    ``lhs_dilation=ratio`` per axis, and the same kernel at stride ``ratio``
    for the restriction). Here each axis is one product with its 1-D hat
    matrix: the convolution's edge clipping is the matrix's clipped rows,
    and the restriction applies the transposed matrices, so the pair is
    exactly adjoint. Both follow their input's dtype (float32 or float64).

    prolong: (B, 2*(ny_c+1)*(nx_c+1)) -> (B, 2*(ny_c*r+1)*(nx_c*r+1));
    restrict: the reverse."""
    r = ratio
    NXc, NYc = nx_c + 1, ny_c + 1
    NXf, NYf = nx_c * r + 1, ny_c * r + 1
    mats = {}
    for dt in (torch.float32, torch.float64):
        py = torch.as_tensor(hat_matrix(NYf, NYc, r), dtype=dt, device=device)
        px = torch.as_tensor(hat_matrix(NXf, NXc, r), dtype=dt, device=device)
        mats[dt] = (py, px, py.T.contiguous(), px.T.contiguous())

    def prolong(u_c):
        py, px, _, _ = mats[u_c.dtype]
        B = u_c.shape[0]
        t = torch.matmul(py, u_c.reshape(B, NYc, NXc * 2))  # (B, NYf, NXc*2)
        t = torch.matmul(px, t.reshape(B * NYf, NXc, 2))  # (B*NYf, NXf, 2)
        return t.reshape(B, -1)

    def restrict(r_f):
        _, _, pyt, pxt = mats[r_f.dtype]
        B = r_f.shape[0]
        t = torch.matmul(pxt, r_f.reshape(B * NYf, NXf, 2))  # (B*NYf, NXc, 2)
        t = torch.matmul(pyt, t.reshape(B, NYf, NXc * 2))  # (B, NYc, NXc*2)
        return t.reshape(B, -1)

    return prolong, restrict


def make_two_level_preconditioner(
    coarse_apply: Callable,
    fine_free_mask,
    grid_transfer,
    *,
    omega: float = 0.5,
):
    """``prec(coeffs (B, 2), diag_inv (B, n), r (B, n)) -> z``, the additive
    two-level preconditioner with structured-grid transfers.

    ``coarse_apply(coeffs, r_c) -> K_c^-1 r_c`` solves on the coarse
    full-dof vector (fixed dofs zero), e.g. ``solver.
    make_coarse_spectral_apply``; ``grid_transfer`` is the ``(prolong,
    restrict)`` pair of :func:`make_grid_transfer_conv`; diag_inv is the fine
    Jacobi inverse diagonal for the current coefficients. The JAX package's
    gather/segment-sum transfers (``grid_transfer=None``) are not ported."""
    prolong, restrict = grid_transfer
    masks = {dt: fine_free_mask.to(dt) for dt in (torch.float32, torch.float64)}

    def prec(coeffs, diag_inv, r):
        mask = masks[r.dtype]
        r = r * mask
        z_smooth = omega * diag_inv * r
        z_c = coarse_apply(coeffs, restrict(r))
        return z_smooth + prolong(z_c) * mask

    return prec
