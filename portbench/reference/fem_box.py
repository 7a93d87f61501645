"""Plain float64 FEM of the 3-D hex8 cantilever: mesh, hex8 solid stiffness,
assembly, the observation operator and its adjoint; the interface of
``fem`` (``build_problem``, ``Solver``, ``observe``, a problem's
``nnz_parts``).

The cantilever of ``examples/train_scaled_3d.py``: the box [0, lx] x [0, ly]
x [0, lz] on an nx x ny x nz grid of hex8 elements, the x = 0 face clamped
(all three dofs), the total tip force spread over the x = lx face as the
consistent load of a uniform traction (each face of the grid gives a quarter
of its share to each of its four corners); nodes numbered x fastest, then y,
then z, three dofs a node interleaved. The element is the trilinear hex8,
its nodes the bottom quad counter-clockwise, then the top one; the 2x2x2
Gauss rule with its points x fastest, then y, then z, each axis ascending
(the numbering of the port's ``ops/quadrature.py::int3d``, which the probe's
quadrature-point indices address: point 1 is (-, -, -), point 5 (-, -, +));
strains [e11, e22, e33, g12, g23, g31] with engineering shears; the isotropic
solid, so the stiffness is ``lam * K_lam + mu * K_mu``. theta maps to the
material as in ``fem``.

The observation is the displacement (ux, uy, uz) of one node, the prediction
``fem``'s reference-convention von Mises stress at two quadrature points of
one element.

Solves are ``fem.Solver``'s on the free dofs: dense LU below ``DENSE_MAX``
free dofs; above it CG preconditioned by the dense Cholesky factor of
``K_lam + K_mu`` on the device (7,776 free dofs at 32x8x8: a 484 MB factor).

Departures from the published description (the example's two-level solver,
trainer and dataset):

- every solve is float64 to round-off, where the example's solver runs
  float32 CG to 3e-3 with one refinement: the reference is what those
  solves approximate;
- the nets' input standardisation (``y_norm``) takes the moments of the
  reference's own redraw of the dataset (its own float64 solves at the
  dataset's draws), not those of the program's dataset;
- the trainer's learning-rate decay and epochs are not followed: the
  reference takes single step-1 steps, from the seed's weights or from the
  program's state, as the harness hands them over.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse
import torch

from .fem import DENSE_MAX, Solver, _Solve, lame, von_mises  # noqa: F401

_G = 1.0 / np.sqrt(3.0)
# the 2x2x2 Gauss points, x fastest, each axis ascending; all weights 1
QPTS = np.array([[x, y, z] for z in (-_G, _G) for y in (-_G, _G) for x in (-_G, _G)])
# natural coordinates of the hex8 nodes
_XI = np.array([-1.0, 1.0, 1.0, -1.0, -1.0, 1.0, 1.0, -1.0])
_ETA = np.array([-1.0, -1.0, 1.0, 1.0, -1.0, -1.0, 1.0, 1.0])
_ZETA = np.array([-1.0, -1.0, -1.0, -1.0, 1.0, 1.0, 1.0, 1.0])
C_LAM = np.zeros((6, 6))
C_LAM[:3, :3] = 1.0
C_MU = np.diag([2.0, 2.0, 2.0, 1.0, 1.0, 1.0])
# a coefficient under this share of the largest one is zero to round-off
ZERO_SHARE = 1e-12


def box_mesh(nx, ny, nz, lx, ly, lz, tip_force):
    """(coords (nnodes, 3), conn (nele, 8), fixed dofs, load vector)."""
    z, y, x = np.meshgrid(np.linspace(0.0, lz, nz + 1), np.linspace(0.0, ly, ny + 1),
                          np.linspace(0.0, lx, nx + 1), indexing="ij")
    coords = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1)

    def node(i, j, k):
        return (k * (ny + 1) + j) * (nx + 1) + i

    k, j, i = (a.ravel() for a in np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                                              indexing="ij"))
    conn = np.stack([node(i, j, k), node(i + 1, j, k), node(i + 1, j + 1, k),
                     node(i, j + 1, k), node(i, j, k + 1), node(i + 1, j, k + 1),
                     node(i + 1, j + 1, k + 1), node(i, j + 1, k + 1)], axis=1)
    kk, jj = (a.ravel() for a in np.meshgrid(np.arange(nz + 1), np.arange(ny + 1),
                                             indexing="ij"))
    clamped = node(0, jj, kk)
    fixed = np.sort((3 * clamped[:, None] + np.arange(3)).ravel())
    # the x = lx face: each of its ny * nz faces a quarter to each corner
    fk, fj = (a.ravel() for a in np.meshgrid(np.arange(nz), np.arange(ny), indexing="ij"))
    share = np.zeros(coords.shape[0])
    for dj, dk in ((0, 0), (1, 0), (0, 1), (1, 1)):
        np.add.at(share, node(nx, fj + dj, fk + dk), 0.25)
    f = (share[:, None] / share.sum() * np.asarray(tip_force, dtype=np.float64)).ravel()
    return coords, conn, fixed, f


def hex8_b(coords, conn):
    """B (nele, 8 qpts, 6, 24) and dvol = detJ (nele, 8), the Gauss weights
    being 1."""
    xl = coords[conn]  # (nele, 8, 3)
    nele = conn.shape[0]
    B = np.zeros((nele, 8, 6, 24))
    dvol = np.zeros((nele, 8))
    for q, (xi, eta, zeta) in enumerate(QPTS):
        dn = 0.125 * np.stack([_XI * (1 + _ETA * eta) * (1 + _ZETA * zeta),
                               _ETA * (1 + _XI * xi) * (1 + _ZETA * zeta),
                               _ZETA * (1 + _XI * xi) * (1 + _ETA * eta)], axis=1)  # (8, 3)
        J = np.einsum("na,enb->eab", dn, xl)  # J[a, b] = dx_b / dxi_a
        d = np.einsum("na,eba->enb", dn, np.linalg.inv(J))  # dN/dx_b (nele, 8, 3)
        for row, (a, b) in enumerate(((0, 0), (1, 1), (2, 2))):
            B[:, q, row, a::3] = d[:, :, b]
        for row, (a, b) in zip((3, 4, 5), ((0, 1), (1, 2), (2, 0))):
            B[:, q, row, a::3] = d[:, :, b]
            B[:, q, row, b::3] = d[:, :, a]
        dvol[:, q] = np.linalg.det(J)
    return B, dvol


@dataclasses.dataclass
class BoxProblem:
    """One box configuration's FEM on one device, the fields ``fem.Solver``
    and ``observe`` read: the free-free stiffness parts (K_lam, K_mu) as
    SciPy CSR, the load on the free dofs, the three observed free-dof
    positions, the stress probe ``B_probe`` (2, 6, 24) and ``lm_probe``
    (24,)."""

    cells: tuple  # (nx, ny, nz)
    ndof: int
    free: np.ndarray
    parts: tuple
    f_free: np.ndarray
    obs: np.ndarray
    B_probe: np.ndarray
    lm_probe: np.ndarray
    theta_mean: tuple
    theta_std: tuple
    device: torch.device
    nnz_parts: tuple  # coefficients of K_lam, K_mu over all dofs nonzero to round-off

    @property
    def nfree(self):
        return self.free.shape[0]


def build_problem(config: dict, device) -> BoxProblem:
    """The configuration's mesh, stiffness parts, load and probes."""
    m = config["mesh"]
    nx, ny, nz = m["nx"], m["ny"], m["nz"]
    coords, conn, fixed, f = box_mesh(nx, ny, nz, m["lx"], m["ly"], m["lz"], m["tip_force"])
    ndof = 3 * coords.shape[0]
    B, dvol = hex8_b(coords, conn)
    lm = (3 * conn[:, :, None] + np.arange(3)).reshape(conn.shape[0], 24)
    rows = np.repeat(lm, 24, axis=1).ravel()
    cols = np.tile(lm, (1, 24)).ravel()
    free = np.setdiff1d(np.arange(ndof), fixed)
    parts, nnz = [], []
    for C in (C_LAM, C_MU):
        ke = np.einsum("eqai,ab,eqbj,eq->eij", B, C, B, dvol)
        K = scipy.sparse.csr_matrix((ke.ravel(), (rows, cols)), shape=(ndof, ndof))
        K.sum_duplicates()
        nnz.append(int(np.count_nonzero(np.abs(K.data) > ZERO_SHARE * np.abs(K.data).max())))
        parts.append(K[free][:, free].tocsr())
    probe = config["probe"]
    node, ele = probe["node_id"] - 1, probe["ele_id"] - 1
    pos = {d: i for i, d in enumerate(free)}
    tm = config["theta_map"]
    return BoxProblem(
        cells=(nx, ny, nz), ndof=ndof, free=free, parts=tuple(parts), f_free=f[free],
        obs=np.array([pos[3 * node + d] for d in range(3)]),
        B_probe=B[ele, np.asarray(probe["nipt_id"]) - 1], lm_probe=lm[ele],
        theta_mean=tuple(tm["mean"]), theta_std=tuple(tm["std"]),
        device=torch.device(device), nnz_parts=tuple(nnz))


def observe(problem: BoxProblem, solver: Solver, theta, with_h=True):
    """(y (B, 3), h (B, 2) or None) of thetas (B, 2), differentiable in
    theta through the adjoint solve; in the solver's dtype."""
    theta = theta.to(solver.dtype)
    lam, mu = lame(problem, theta)
    f = torch.as_tensor(problem.f_free, dtype=solver.dtype, device=theta.device)
    u = _Solve.apply(lam, mu, f.expand(theta.shape[0], -1), solver)
    y = u[:, problem.obs]
    if not with_h:
        return y, None
    full = u.new_zeros((u.shape[0], problem.ndof))
    full[:, torch.as_tensor(problem.free, device=u.device)] = u
    ue = full[:, torch.as_tensor(problem.lm_probe, device=u.device)]
    Bp = torch.as_tensor(problem.B_probe, dtype=u.dtype, device=u.device)
    eps = torch.einsum("qai,bi->bqa", Bp, ue)  # (B, 2, 6)
    tr = eps[..., :3].sum(-1, keepdim=True)
    l, m = lam[:, None, None], mu[:, None, None]
    sig6 = torch.cat([l * tr + 2 * m * eps[..., :3], m * eps[..., 3:]], dim=-1)
    return y, von_mises(sig6)
