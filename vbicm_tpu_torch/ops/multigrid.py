"""Two-level (coarse grid + Jacobi) preconditioning for refined structured
meshes, Cook's quad4 and the hex8 box (counterpart of
``vbicm_tpu/ops/multigrid.py``, the additive cycle with tensor-product
transfers for the stencil paths and gather transfers for the element path).

    M^-1 r = P K_c(lam, mu)^-1 P^T r + omega * D^-1 r

P is the multilinear index-space prolongation from the coarse grid to the
fine grid refined ``ratio`` times per axis, exact for the Cook's geometry,
which is bilinear in the index map, and for the axis-aligned box; K_c^-1 is
the coarse model's exact spectral solve for any (lam, mu); D is the fine
Jacobi diagonal. Vectors are batched, (B, ndof), dofs interleaved per node.
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


def make_grid_transfer_nd(cells_coarse, ratio: int, ndof_node: int, *, device="cpu"):
    """``(prolong, restrict)`` on batched flat dof vectors of a structured
    grid: the JAX package's N-dimensional tensor-product transfers.

    ``cells_coarse`` holds the coarse cell counts per axis, slowest-varying
    first (``(nz, ny, nx)`` for the hex8 box numbering of
    ``mesh/solid3d.py``), with the ``ndof_node`` dof channel fastest. The
    prolongation applies each axis's 1-D hat matrix (:func:`hat_matrix`) in
    turn, as one batched matrix product; the restriction applies the
    transposed matrices in the reverse order, so the pair is exactly
    adjoint. Both follow their input's dtype (float32 or float64). On the
    Cook's grid, ``(ny_c, nx_c)`` with 2 dofs a node, they equal the JAX
    package's conv-form transfers (a depthwise hat-kernel convolution with
    ``lhs_dilation=ratio``, and the same kernel at stride ``ratio`` for the
    restriction): the convolution's edge clipping is the hat matrices'
    clipped rows.

    prolong: (B, ndof_node * prod(c + 1)) -> (B, ndof_node * prod(c*r + 1));
    restrict: the reverse."""
    nc = [c + 1 for c in cells_coarse]
    nf = [c * ratio + 1 for c in cells_coarse]
    mats = {}
    for dt in (torch.float32, torch.float64):
        ps = [torch.as_tensor(hat_matrix(f, c, ratio), dtype=dt, device=device)
              for f, c in zip(nf, nc)]
        mats[dt] = (ps, [p.T.contiguous() for p in ps])

    def prolong(u_c):
        ps, _ = mats[u_c.dtype]
        B = u_c.shape[0]
        t = u_c
        for k, p in enumerate(ps):
            # axes before k are fine already, axes after k still coarse
            t = torch.matmul(p, t.reshape(B * int(np.prod(nf[:k])), nc[k], -1))
        return t.reshape(B, -1)

    def restrict(r_f):
        _, pts = mats[r_f.dtype]
        B = r_f.shape[0]
        t = r_f
        for k in reversed(range(len(pts))):
            # axes before k are fine still, axes after k coarse already
            t = torch.matmul(pts[k], t.reshape(B * int(np.prod(nf[:k])), nf[k], -1))
        return t.reshape(B, -1)

    return prolong, restrict


def make_gather_transfer(idx, w, *, device="cpu"):
    """``(prolong, restrict)`` on batched flat dof vectors (2 dofs a node,
    interleaved) from the gather tables of :func:`cooks_prolongation`: the
    JAX package's gather/segment-sum transfers, the element-path two-level
    solver's. Any (idx, w) works; no grid structure is assumed.

    prolong: (B, 2 nc) -> (B, 2 nf), ``fine[n] = sum_k w[n, k] coarse[idx[n, k]]``,
    a gather. restrict: the exact transpose, ``coarse[c] = sum w[n, k]
    fine[n]`` over the (n, k) with ``idx[n, k] = c`` and ``w[n, k] != 0``,
    also a gather, through a transposed table built here on the host (each
    coarse node's fine nodes in increasing order, padded with weight 0):
    the sums run in a fixed order, so the result repeats bit for bit on the
    GPU, where ``index_add_`` would sum with atomics. Both follow their
    input's dtype (float32 or float64)."""
    idx = np.asarray(idx, dtype=np.int64)
    w = np.asarray(w, dtype=np.float64)
    nf = idx.shape[0]
    nc = int(idx.max()) + 1
    keep = w != 0.0
    fine = np.broadcast_to(np.arange(nf)[:, None], idx.shape)[keep]
    coarse, wk = idx[keep], w[keep]
    order = np.lexsort((fine, coarse))  # by coarse node, then fine node
    counts = np.bincount(coarse, minlength=nc)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(order.size) - np.repeat(starts, counts)
    width = max(1, int(counts.max()))
    idx_t = np.zeros((nc, width), dtype=np.int64)
    w_t = np.zeros((nc, width))
    idx_t[coarse[order], slot] = fine[order]
    w_t[coarse[order], slot] = wk[order]

    gidx = torch.as_tensor(idx, device=device)
    gidx_t = torch.as_tensor(idx_t, device=device)
    weights = {dt: (torch.as_tensor(w, dtype=dt, device=device)[None, :, :, None],
                    torch.as_tensor(w_t, dtype=dt, device=device)[None, :, :, None])
               for dt in (torch.float32, torch.float64)}

    def prolong(u_c):
        B = u_c.shape[0]
        return (u_c.reshape(B, nc, 2)[:, gidx] * weights[u_c.dtype][0]).sum(2).reshape(B, -1)

    def restrict(r_f):
        B = r_f.shape[0]
        return (r_f.reshape(B, nf, 2)[:, gidx_t] * weights[r_f.dtype][1]).sum(2).reshape(B, -1)

    return prolong, restrict


def make_two_level_preconditioner(
    coarse_apply: Callable,
    fine_free_mask,
    grid_transfer,
    *,
    omega: float = 0.5,
):
    """``prec(coeffs (B, 2), diag_inv (B, n), r (B, n)) -> z``, the additive
    two-level preconditioner.

    ``coarse_apply(coeffs, r_c) -> K_c^-1 r_c`` solves on the coarse
    full-dof vector (fixed dofs zero), e.g. ``solver.
    make_coarse_spectral_apply``; ``grid_transfer`` is a ``(prolong,
    restrict)`` pair: the structured-grid transfers of
    :func:`make_grid_transfer_nd` (the stencil paths) or the gather
    transfers of :func:`make_gather_transfer` (the element path); diag_inv
    is the fine Jacobi inverse diagonal for the current coefficients."""
    prolong, restrict = grid_transfer
    masks = {dt: fine_free_mask.to(dt) for dt in (torch.float32, torch.float64)}

    def prec(coeffs, diag_inv, r):
        mask = masks[r.dtype]
        r = r * mask
        z_smooth = omega * diag_inv * r
        z_c = coarse_apply(coeffs, restrict(r))
        return z_smooth + prolong(z_c) * mask

    return prec
