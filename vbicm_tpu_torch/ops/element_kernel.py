"""Batched affine element matvec: the CUDA kernel's wrapper and its plain
PyTorch version (counterpart of ``vbicm_tpu/ops/element_matvec_pallas.py``).

For a batch of samples s on any mesh (no grid structure assumed),
``q[s] = (c0[s] K_lam + c1[s] K_mu) u[s]`` from the element blocks. The
kernel (``csrc/element_matvec.cu``) fuses the gather of the element dofs,
the two-part multiply-adds and the scatter back to the dofs: it reads the
blocks as contiguous rows (2, nele, edof, edof) and, for each dof, pulls its
element entries through the incidence tables of
``ops.assembly.dof_incidence``, so the sums run in a fixed order and
repeat bit for bit. For quad4 a thread holds the rows of its first
``MAXE`` entries in registers over a run of samples and reads any further
entries' rows from memory, in the same order. The plain version is
``ops.assembly.element_affine_matvec`` (gather, einsum, ``index_add_``
through ``lm``), so a fault in the tables cannot hide in both. On CPU tensors the wrapper runs
the plain version; on CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from .. import _build
from .assembly import dof_incidence, element_affine_matvec

EDOFS = (8, 24)  # the element sizes the kernel is compiled for: quad4, hex8
MAXE = 4  # incidence entries a quad4 thread of the kernel holds in registers


def element_affine_matvec_kernel(ke_parts, lm, row_ptr, ent, coeffs, u):
    """Batched ``q = (c0 K_lam + c1 K_mu) u`` through the CUDA kernel.

    ke_parts (2, nele, edof, edof) element blocks; lm (nele, edof) the dof
    map; row_ptr (ndof + 1,) and ent (nele * edof,) its incidence tables
    (:func:`ops.assembly.dof_incidence`); coeffs (B, 2); u (B, ndof). CPU
    tensors run :func:`ops.assembly.element_affine_matvec` on ke_parts and
    lm. CUDA tensors run the kernel: ke_parts, coeffs and u all float32 or
    all float64, lm, row_ptr and ent int32, all contiguous, edof 8 or 24;
    for edof 8 ke_parts and lm 16-byte aligned (the kernel reads their rows
    as 16-byte vectors). Returns q (B, ndof) in u's dtype.

    Counter ``element_affine.launches`` (``utils.trace``): the kernel's
    launches.
    """
    if u.device.type == "cpu":
        return element_affine_matvec(ke_parts, lm, coeffs, u, u.shape[-1])
    if any(t.dtype != torch.int32 for t in (lm, row_ptr, ent)):
        raise TypeError(f"element_affine_matvec_kernel: lm, row_ptr, ent dtypes "
                        f"{[t.dtype for t in (lm, row_ptr, ent)]}; all must be int32")
    B, ndof = u.shape if u.ndim == 2 else (None, None)
    nele, edof = ke_parts.shape[1:3] if ke_parts.ndim == 4 else (None, None)
    if (B is None or nele is None or tuple(ke_parts.shape) != (2, nele, edof, edof)
            or tuple(lm.shape) != (nele, edof) or tuple(row_ptr.shape) != (ndof + 1,)
            or tuple(ent.shape) != (nele * edof,) or tuple(coeffs.shape) != (B, 2)):
        raise ValueError(f"element_affine_matvec_kernel: shapes ke_parts "
                         f"{tuple(ke_parts.shape)}, lm {tuple(lm.shape)}, row_ptr "
                         f"{tuple(row_ptr.shape)}, ent {tuple(ent.shape)}, coeffs "
                         f"{tuple(coeffs.shape)}, u {tuple(u.shape)}")
    if edof not in EDOFS:
        raise ValueError(f"element_affine_matvec_kernel: edof {edof}; the kernel takes "
                         f"{EDOFS}")
    # quad4 rows of ke_parts and lm are read as 16-byte vectors
    vec = 16 if edof == 8 else 0
    device = _build.check_operands(
        "element_affine_matvec_kernel", ("ke_parts", "coeffs", "u", "lm", "row_ptr", "ent"),
        (ke_parts, coeffs, u, lm, row_ptr, ent), floats=3, align=(vec, 0, 0, vec))
    dtype = u.dtype
    q = torch.empty_like(u)
    if B > 0:
        _build.launch("element_affine", dtype, device,
                      (ke_parts.data_ptr(), lm.data_ptr(), row_ptr.data_ptr(), ent.data_ptr(),
                       coeffs.data_ptr(), u.data_ptr(), q.data_ptr(), B, ndof, nele, edof),
                      lambda: f"(B={B}, ndof={ndof}, nele={nele}, edof={edof}, {dtype})")
    return q


def launch_plan(B: int, ndof: int, edof: int, dtype=torch.float32):
    """The launch the kernel makes at (B, ndof, edof) on the current CUDA
    device, as its C plan entry point reports it: (sample groups, blocks an
    SM holds, register entries a thread) -- for quad4 the runs of samples a
    block walks with its rows in registers, for hex8 the 8-sample tiles (no
    register entries). Builds the kernels on first use; needs a GPU."""
    plan = _build.kernel_fit(_build.entry("element_affine_plan", dtype), 3, B, ndof, edof)
    if plan is None:
        raise ValueError(f"element_affine kernel takes no launch at B={B}, ndof={ndof}, "
                         f"edof={edof}")
    return plan


class ElementOperator:
    """The element-path operator of one mesh on one device: the element
    blocks as contiguous rows (2, nele, edof, edof) for each dtype in
    ``dtypes``, the dof map ``lm`` and its incidence tables ``row_ptr``,
    ``ent`` (int32), built once."""

    def __init__(self, ke_parts, lm, ndof: int, dtypes=(torch.float32, torch.float64)):
        device = ke_parts.device
        row_ptr, ent = dof_incidence(lm, ndof)
        self.ke = {dt: ke_parts.to(dt).contiguous() for dt in dtypes}
        self.lm = lm.to(device=device, dtype=torch.int32).contiguous()
        self.row_ptr = torch.as_tensor(row_ptr, device=device)
        self.ent = torch.as_tensor(ent, device=device)

    def affine(self, coeffs, u):
        """``K(c) u`` for coeffs (B, 2) and u (B, ndof), in u's dtype: the
        kernel on CUDA tensors, its plain version on CPU tensors."""
        dt = u.dtype
        return element_affine_matvec_kernel(self.ke[dt], self.lm, self.row_ptr, self.ent,
                                            coeffs.to(dt).contiguous(), u.contiguous())
