"""Element-block operators without assembly (counterpart of
``vbicm_tpu/ops/assembly.py``, the matrix-free part).

``K @ u`` is applied per element: gather the element's dofs, multiply by the
8x8 block, scatter-add back. Batched over samples, in plain PyTorch
(``index_add_``); it is the plain version of the element kernel
(``ops.element_kernel``), and the tests' operator that does not share code
with the stencil. :func:`dof_incidence` builds the kernel's tables.
"""
from __future__ import annotations

import numpy as np
import torch


def dof_incidence(lm, ndof: int):
    """The element-to-dof map read as a "pull" list for each dof, built on
    the host: ``(row_ptr (ndof + 1,), ent (nele * edof,))``, int32 NumPy,
    where ``ent[row_ptr[d]:row_ptr[d + 1]]`` are the flat entries
    ``e * edof + i`` with ``lm[e, i] == d``, in increasing order. It is the
    stable sort of the JAX package's ``make_sorted_scatter``, with the
    sorted dof ids replaced by their row pointers."""
    flat = np.asarray(lm.cpu() if isinstance(lm, torch.Tensor) else lm).reshape(-1)
    if flat.size and (flat.min() < 0 or flat.max() >= ndof):
        raise ValueError(f"dof map entries outside [0, {ndof})")
    ent = np.argsort(flat, kind="stable")
    row_ptr = np.zeros(ndof + 1, dtype=np.int64)
    np.cumsum(np.bincount(flat, minlength=ndof), out=row_ptr[1:])
    if row_ptr[-1] >= 2**31:
        raise ValueError("the dof map is too large for int32 incidence tables")
    return row_ptr.astype(np.int32), ent.astype(np.int32)


def gather_element_dofs(u, lm):
    """u (..., ndof) -> (..., nele, edof) element dof values."""
    return u[..., lm]


def make_sorted_scatter(lm, ndof: int):
    """``scatter(qe (..., nele, edof)) -> (..., ndof)``: the sum of element
    contributions into global dofs. The JAX package sorts the dof map for a
    segment sum, a TPU lowering; here it is one ``index_add_`` over the
    flattened map."""
    flat = lm.reshape(-1)

    def scatter(qe):
        lead = qe.shape[:-2]
        src = qe.reshape(-1, flat.shape[0])
        out = src.new_zeros((src.shape[0], ndof))
        out.index_add_(1, flat, src)
        return out.reshape(*lead, ndof)

    return scatter


def element_matvec(ke, lm, u, ndof: int):
    """Matrix-free ``K @ u`` from element blocks ke (nele, edof, edof) and
    the dof map lm (nele, edof), for u (..., ndof)."""
    qe = torch.einsum("eij,...ej->...ei", ke, gather_element_dofs(u, lm))
    return make_sorted_scatter(lm, ndof)(qe)


def element_affine_matvec(ke_parts, lm, coeffs, u, ndof: int):
    """``K(c) u = sum_p c_p K_p u`` per sample: ke_parts (P, nele, edof,
    edof), coeffs (B, P), u (B, ndof), in u's dtype. The coefficients scale
    each part's element products; the (B, nele, edof, edof) blocks of
    K(c) are never formed."""
    ue = gather_element_dofs(u, lm)
    c = coeffs.to(u.dtype)
    qe = None
    for p in range(ke_parts.shape[0]):
        qp = c[:, p, None, None] * torch.einsum("eij,bej->bei", ke_parts[p], ue)
        qe = qp if qe is None else qe + qp
    return make_sorted_scatter(lm, ndof)(qe)


def jacobi_diagonal(ke, lm, ndof: int):
    """Diagonal of the assembled K from element blocks (nele, edof, edof),
    summed on the host in ke's dtype in the fixed order of
    :func:`dof_incidence` (no atomics on the card, so every build gives the
    same bits), returned on ke's device."""
    row_ptr, ent = dof_incidence(lm, ndof)
    vals = torch.diagonal(ke, dim1=-2, dim2=-1).detach().cpu().numpy().reshape(-1)[ent]
    out = np.zeros(ndof, dtype=vals.dtype)
    starts = row_ptr[:-1]
    hit = starts < row_ptr[1:]  # dofs that some element touches
    if vals.size:
        out[hit] = np.add.reduceat(vals, starts[hit])
    return torch.as_tensor(out, device=ke.device)
