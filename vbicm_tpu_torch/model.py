"""FemModel: the preprocessed FEM problem as tensors on one device
(counterpart of ``vbicm_tpu/model.py``).

Everything theta-independent is built once on the host in float64 with
NumPy (B-matrices, ``dvol = thk * detJ * w``, the affine element stiffness
parts ``ke_lam``/``ke_mu`` and, for dense models, the assembled free-free
blocks ``k_lam_ff``/``k_mu_ff``; a matrix-free model leaves them ``None``),
then moved to the device in the requested
dtype. A sample's operator is then the two-term sum
``lam * K_lam + mu * K_mu``.

DOF convention: node n owns dofs (ndm*n + d), interleaved; element dof map
``lm[e] = [ndm*c0, ndm*c0+1, ..., ndm*c1, ...]`` for ``conn[e] = [c0, ...]``
(ndm = 2 in plane strain, 3 for the solid).

This package builds the quad4 / plane-strain and the hex8 / 3-D solid
(stype 4) unconstrained branches, dense or matrix-free; every other branch of
the JAX package's ``build_fem_model`` raises here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .config import SectionCard
from .mesh.feap import MeshData
from .ops import quadrature
from .ops.element import C_LAM3, C_LAM6, C_MU3, C_MU6
from .ops.shape import _HEX_ETA, _HEX_XI, _HEX_ZETA


@dataclasses.dataclass(frozen=True)
class FemModel:
    coords: torch.Tensor  # (nnodes, ndm)
    conn: torch.Tensor  # (nele, 4 | 8) int64
    lm: torch.Tensor  # (nele, edof) int64, edof = 8 (quad4) | 24 (hex8)
    free_dof: torch.Tensor  # (nfree,) int64
    supp_dof: torch.Tensor  # (nsupp,) int64
    free_mask: torch.Tensor  # (ndof,) model dtype, 1 on free dofs
    f_ext: torch.Tensor  # (ndof,)
    f_free: torch.Tensor  # (nfree,)
    B: torch.Tensor  # (nele, nqpt, 3, 8) | (nele, nqpt, 6, 24)
    dvol: torch.Tensor  # (nele, nqpt)
    ke_lam: torch.Tensor  # (nele, edof, edof)
    ke_mu: torch.Tensor  # (nele, edof, edof)
    k_lam_ff: Optional[torch.Tensor]  # (nfree, nfree); None when matrix-free
    k_mu_ff: Optional[torch.Tensor]
    nnodes: int
    nele: int
    ndof: int
    nfree: int
    nqpt: int
    thk: float
    dense: bool = True
    stype: int = 2
    ndm: int = 2

    @property
    def dtype(self) -> torch.dtype:
        return self.coords.dtype

    @property
    def device(self) -> torch.device:
        return self.coords.device


def _dof_maps(mesh: MeshData, ndm: int = 2):
    """LM / free / supported dof index arrays, 0-based interleaved; ``ndm``
    dofs per node."""
    ndof = mesh.nnodes * ndm
    lm = np.empty((mesh.nele, ndm * mesh.max_ele_node), dtype=np.int64)
    for d in range(ndm):
        lm[:, d::ndm] = mesh.conn * ndm + d
    fixed = np.zeros(ndof, dtype=bool)
    for node, flags in zip(mesh.bc_nodes, mesh.bc_flags):
        for d in range(ndm):
            if flags[d]:
                fixed[ndm * node + d] = True
    return lm, np.nonzero(~fixed)[0], np.nonzero(fixed)[0]


def _load_vector(mesh: MeshData, ndof: int, ndm: int = 2):
    f = np.zeros(ndof, dtype=np.float64)
    for node, vals in zip(mesh.load_nodes, mesh.load_vals):
        for d in range(ndm):
            f[ndm * node + d] += vals[d]
    return f


def _element_geometry(coords, conn, qpts, qwts, thk):
    """Host-side (NumPy) B-matrix / dvol precompute for all (elem, qpt)."""
    nele = conn.shape[0]
    nqpt = qpts.shape[0]
    xl = coords[conn]  # (nele, 4, 2)

    s = np.array([-1.0, 1.0, 1.0, -1.0])
    t = np.array([-1.0, -1.0, 1.0, 1.0])
    B = np.zeros((nele, nqpt, 3, 8))
    dvol = np.zeros((nele, nqpt))
    for q in range(nqpt):
        xi, eta = qpts[q]
        dn_nat = np.stack([0.25 * s * (1.0 + t * eta), 0.25 * t * (1.0 + s * xi)], axis=1)
        J = np.einsum("na,enb->eab", dn_nat, xl)  # (nele, 2, 2)
        detj = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
        inv_t = (
            np.stack(
                [
                    np.stack([J[:, 1, 1], -J[:, 1, 0]], axis=-1),
                    np.stack([-J[:, 0, 1], J[:, 0, 0]], axis=-1),
                ],
                axis=1,
            )
            / detj[:, None, None]
        )
        dn_glob = np.einsum("na,eab->enb", dn_nat, inv_t)  # (nele, 4, 2)
        B[:, q, 0, 0::2] = dn_glob[:, :, 0]
        B[:, q, 1, 1::2] = dn_glob[:, :, 1]
        B[:, q, 2, 0::2] = dn_glob[:, :, 1]
        B[:, q, 2, 1::2] = dn_glob[:, :, 0]
        dvol[:, q] = thk * detj * qwts[q]
    return B, dvol


def _hex8_dn_host(qpts):
    """Trilinear (hex8) natural derivatives at all quadrature points at
    once: (nqpt, 8, 3)."""
    s, t, r = _HEX_XI, _HEX_ETA, _HEX_ZETA
    xi, eta, zeta = (qpts[:, k][:, None] for k in range(3))
    return np.stack([0.125 * s * (1.0 + t * eta) * (1.0 + r * zeta),
                     0.125 * t * (1.0 + s * xi) * (1.0 + r * zeta),
                     0.125 * r * (1.0 + s * xi) * (1.0 + t * eta)], axis=2)


def _element_geometry_3d(coords, conn, qpts, qwts):
    """Host-side (NumPy) hex8 B-matrix / dvol precompute: B (nele, nqpt, 6,
    24) with strain rows [e11, e22, e33, g12, g23, g31], dvol = detJ * w."""
    nele = conn.shape[0]
    nqpt = qpts.shape[0]
    xl = coords[conn]  # (nele, 8, 3)
    dn_all = _hex8_dn_host(qpts)  # (nqpt, 8, 3)
    B = np.zeros((nele, nqpt, 6, 24))
    dvol = np.zeros((nele, nqpt))
    for q in range(nqpt):
        dn_nat = dn_all[q]
        J = np.einsum("na,enb->eab", dn_nat, xl)  # (nele, 3, 3)
        detj = np.linalg.det(J)
        if (detj <= 0.0).any():
            raise ValueError("non-positive Jacobian in a hex element")
        # dn_nat = dn_glob @ J^T, so dn_glob[n, b] = sum_a dn_nat[n, a] invJ[b, a]
        dn_glob = np.einsum("na,eba->enb", dn_nat, np.linalg.inv(J))  # (nele, 8, 3)
        B[:, q, 0, 0::3] = dn_glob[:, :, 0]
        B[:, q, 1, 1::3] = dn_glob[:, :, 1]
        B[:, q, 2, 2::3] = dn_glob[:, :, 2]
        B[:, q, 3, 0::3] = dn_glob[:, :, 1]
        B[:, q, 3, 1::3] = dn_glob[:, :, 0]
        B[:, q, 4, 1::3] = dn_glob[:, :, 2]
        B[:, q, 4, 2::3] = dn_glob[:, :, 1]
        B[:, q, 5, 0::3] = dn_glob[:, :, 2]
        B[:, q, 5, 2::3] = dn_glob[:, :, 0]
        dvol[:, q] = detj * qwts[q]
    return B, dvol


def _ke_part_host(B, C, dvol):
    """``ke[e] = sum_q dvol[e,q] B[e,q]^T C B[e,q]`` as batched matmuls."""
    nele, nqpt, nr, edof = B.shape
    CBw = np.matmul(C[None, None], B) * dvol[:, :, None, None]
    Bf = B.reshape(nele, nqpt * nr, edof)
    return np.matmul(Bf.transpose(0, 2, 1), CBw.reshape(nele, nqpt * nr, edof))


def build_fem_model(
    mesh: MeshData,
    section: SectionCard = SectionCard(),
    *,
    device,
    dense: Optional[bool] = None,
    dtype: torch.dtype = torch.float64,
) -> FemModel:
    """Preprocess a quad4 plane-strain mesh, or a hex8 mesh with
    ``SectionCard(stype=4)``, into a FemModel on ``device``.

    ``dense=None`` chooses, as the JAX package does: the assembled
    free-free parts when there are at most 4096 free dofs, matrix-free
    (``k_lam_ff``/``k_mu_ff`` left ``None``) above that."""
    is3d = mesh.max_node_dof == 3 or mesh.space_dim == 3
    if is3d:
        if mesh.max_ele_node != 8 or mesh.space_dim != 3 or mesh.max_node_dof != 3:
            raise NotImplementedError("3-D solids: 8-node hexahedra with 3 dofs/node only")
        if section.stype != 4:
            raise ValueError("3-D solid meshes take stype=4 (the full 3-D isotropic law)")
    else:
        if section.etype != 1 or mesh.max_ele_node != 4:
            raise NotImplementedError("only the quad4 element is ported so far in 2-D")
        if section.stype != 2:
            raise NotImplementedError("only plane strain (stype=2) is ported so far in 2-D; "
                                      "stype 4 is the 3-D solid path (hex meshes)")
    if mesh.disp_nodes.size:
        raise NotImplementedError("prescribed displacements are not ported yet")

    ndm = 3 if is3d else 2
    lm, free_dof, supp_dof = _dof_maps(mesh, ndm)
    ndof = mesh.nnodes * ndm
    nfree = free_dof.shape[0]
    if dense is None:
        dense = nfree <= 4096
    f_ext = _load_vector(mesh, ndof, ndm)

    if is3d:
        qpts, qwts = quadrature.int3d(min(5, max(1, section.intp)))
        B, dvol = _element_geometry_3d(mesh.coords, mesh.conn, qpts, qwts)
        C0, C1 = C_LAM6, C_MU6
    else:
        qpts, qwts = quadrature.quadr2d(section.intp, mesh.max_ele_node)
        B, dvol = _element_geometry(mesh.coords, mesh.conn, qpts, qwts, section.thk)
        C0, C1 = C_LAM3, C_MU3
    ke_lam = _ke_part_host(B, C0, dvol)
    ke_mu = _ke_part_host(B, C1, dvol)

    def as_dt(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=device)

    def as_idx(x):
        return torch.as_tensor(np.asarray(x, dtype=np.int64), device=device)

    k_lam_ff = k_mu_ff = None
    if dense:
        K_lam = np.zeros((ndof, ndof))
        K_mu = np.zeros((ndof, ndof))
        for e in range(lm.shape[0]):
            idx = lm[e]  # duplicate-free for unconstrained element maps
            K_lam[np.ix_(idx, idx)] += ke_lam[e]
            K_mu[np.ix_(idx, idx)] += ke_mu[e]
        k_lam_ff = as_dt(K_lam[np.ix_(free_dof, free_dof)])
        k_mu_ff = as_dt(K_mu[np.ix_(free_dof, free_dof)])

    free_mask = np.zeros(ndof)
    free_mask[free_dof] = 1.0

    return FemModel(
        coords=as_dt(mesh.coords),
        conn=as_idx(mesh.conn),
        lm=as_idx(lm),
        free_dof=as_idx(free_dof),
        supp_dof=as_idx(supp_dof),
        free_mask=as_dt(free_mask),
        f_ext=as_dt(f_ext),
        f_free=as_dt(f_ext[free_dof]),
        B=as_dt(B),
        dvol=as_dt(dvol),
        ke_lam=as_dt(ke_lam),
        ke_mu=as_dt(ke_mu),
        k_lam_ff=k_lam_ff,
        k_mu_ff=k_mu_ff,
        nnodes=mesh.nnodes,
        nele=mesh.nele,
        ndof=ndof,
        nfree=int(nfree),
        nqpt=int(qpts.shape[0]),
        thk=float(section.thk),
        dense=bool(dense),
        stype=int(section.stype),
        ndm=ndm,
    )
