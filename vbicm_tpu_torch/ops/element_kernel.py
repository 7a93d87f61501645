"""Batched affine element matvec: the CUDA kernel's wrapper and its plain
PyTorch version (counterpart of ``vbicm_tpu/ops/element_matvec_pallas.py``).

For a batch of samples s on any mesh (no grid structure assumed),
``q[s] = (c0[s] K_lam + c1[s] K_mu) u[s]`` from the element blocks. The
kernel (``csrc/element_matvec.cu``) fuses the gather of the element dofs,
the two-part multiply-adds and the scatter back to the dofs: it reads the
blocks as contiguous rows (2, nele, edof, edof) and, for each dof, pulls its
element entries through the incidence tables of
``ops.assembly.dof_incidence``, so the sums run in a fixed order and
repeat bit for bit. The plain version is ``ops.assembly.
element_affine_matvec`` (gather, einsum, ``index_add_`` through ``lm``), so
a fault in the tables cannot hide in both. On CPU tensors the wrapper runs
the plain version; on CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from .. import _build
from .assembly import dof_incidence, element_affine_matvec

EDOFS = (8, 24)  # the element sizes the kernel is compiled for: quad4, hex8


def element_affine_matvec_kernel(ke_parts, lm, row_ptr, ent, coeffs, u):
    """Batched ``q = (c0 K_lam + c1 K_mu) u`` through the CUDA kernel.

    ke_parts (2, nele, edof, edof) element blocks; lm (nele, edof) the dof
    map; row_ptr (ndof + 1,) and ent (nele * edof,) its incidence tables
    (:func:`ops.assembly.dof_incidence`); coeffs (B, 2); u (B, ndof). CPU
    tensors run :func:`ops.assembly.element_affine_matvec` on ke_parts and
    lm. CUDA tensors run the kernel: ke_parts, coeffs and u all float32 or
    all float64, lm, row_ptr and ent int32, all contiguous, edof 8 or 24.
    Returns q (B, ndof) in u's dtype.

    ``element_affine_matvec_kernel.launches`` counts the kernel's launches.
    """
    if u.device.type == "cpu":
        return element_affine_matvec(ke_parts, lm, coeffs, u, u.shape[-1])
    tensors = (ke_parts, lm, row_ptr, ent, coeffs, u)
    dtype = u.dtype
    if dtype not in (torch.float32, torch.float64) or ke_parts.dtype != dtype \
            or coeffs.dtype != dtype:
        raise TypeError(f"element_affine_matvec_kernel: dtypes ke_parts {ke_parts.dtype}, "
                        f"coeffs {coeffs.dtype}, u {dtype}; all must be float32 or all float64")
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
    for name, t in zip(("ke_parts", "lm", "row_ptr", "ent", "coeffs", "u"), tensors):
        if not t.is_contiguous():
            raise ValueError(f"element_affine_matvec_kernel: {name} must be contiguous")
    device = u.device
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError(f"element_affine_matvec_kernel: tensors on "
                         f"{[str(t.device) for t in tensors]}; all must be on one CUDA device "
                         "(or u on the CPU)")

    q = torch.empty_like(u)
    if B > 0:
        lib, _, _ = _build.load_library()
        fn = (lib.vbicm_element_affine_f32 if dtype == torch.float32
              else lib.vbicm_element_affine_f64)
        with torch.cuda.device(device):
            err = fn(ke_parts.data_ptr(), lm.data_ptr(), row_ptr.data_ptr(), ent.data_ptr(),
                     coeffs.data_ptr(), u.data_ptr(), q.data_ptr(), B, ndof, nele, edof,
                     torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"element_affine kernel launch failed with CUDA error {err} "
                               f"(B={B}, ndof={ndof}, nele={nele}, edof={edof}, {dtype})")
        element_affine_matvec_kernel.launches += 1
    return q


element_affine_matvec_kernel.launches = 0


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
