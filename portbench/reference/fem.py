"""Plain float64 FEM of Cook's membrane: mesh, quad4 plane-strain stiffness,
assembly, the observation operator and its adjoint.

Cook's membrane (Cook 1974): corners (0, 0), (48, 44), (48, 60), (0, 44),
thickness 10, the left edge clamped, a total shear of 50 in +y on the right
edge lumped uniformly with half weights at its two end nodes; nodes
numbered x fastest from the bottom edge, two dofs a node interleaved. The
element is the bilinear quad4 with the 2x2 Gauss rule, its points in the
corner order (-,-), (+,-), (+,+), (-,+); plane strain, so the stiffness is
``lam * K_lam + mu * K_mu``. theta maps to the material by
``E = exp(std0 * t0 + mean0)``, ``nu = 0.5 * sigmoid(std1 * t1 + mean1)``.

The observation is the displacement (ux, uy) of one node and the
prediction the reference-convention von Mises stress at two quadrature
points of one element: ``sqrt(0.5 * |P6 s6|^2)`` with P6 the deviatoric
projector restricted to [s11, s22, s33, t12, t23, t31], which keeps each
shear once and halves it (not the textbook sqrt(3 J2)).

Solves run on the free dofs in float64 (or a lower dtype for a control):
per sample dense LU below ``DENSE_MAX`` free dofs; above it preconditioned
CG whose preconditioner is the exact Cholesky factor of ``K_lam + K_mu``
(dense, on the device), which differs from ``K(lam, mu) / mu`` only by
``(lam / mu - 1) K_lam``, so CG converges in a few tens of iterations to
the factor's own accuracy.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import scipy.sparse
import torch

DENSE_MAX = 4096
_G = 1.0 / math.sqrt(3.0)
QPTS = np.array([[-_G, -_G], [_G, -_G], [_G, _G], [-_G, _G]])
_S = np.array([-1.0, 1.0, 1.0, -1.0])
_T = np.array([-1.0, -1.0, 1.0, 1.0])
C_LAM = np.array([[1.0, 1.0, 0.0], [1.0, 1.0, 0.0], [0.0, 0.0, 0.0]])
C_MU = np.array([[2.0, 0.0, 0.0], [0.0, 2.0, 0.0], [0.0, 0.0, 1.0]])


def cooks_mesh(nx: int, ny: int):
    """(coords (nnodes, 2), conn (nele, 4), fixed dofs, load vector)."""
    xi, eta = np.meshgrid(np.linspace(0.0, 1.0, nx + 1), np.linspace(0.0, 1.0, ny + 1))
    x = 48.0 * xi
    y_bot, y_top = 44.0 * xi, 44.0 + 16.0 * xi
    y = y_bot + (y_top - y_bot) * eta
    coords = np.stack([x.ravel(), y.ravel()], axis=1)
    r, c = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    n0 = (r * (nx + 1) + c).ravel()
    conn = np.stack([n0, n0 + 1, n0 + nx + 2, n0 + nx + 1], axis=1)
    left = np.arange(ny + 1) * (nx + 1)
    fixed = np.sort(np.concatenate([2 * left, 2 * left + 1]))
    f = np.zeros(2 * coords.shape[0])
    right = left + nx
    fy = np.full(ny + 1, 50.0 / ny)
    fy[[0, -1]] *= 0.5
    f[2 * right + 1] = fy
    return coords, conn, fixed, f


def quad4_b(coords, conn):
    """B (nele, 4 qpts, 3, 8) in [e11, e22, g12] and dvol = 10 detJ (nele, 4)."""
    xl = coords[conn]
    B = np.zeros((conn.shape[0], 4, 3, 8))
    dvol = np.zeros((conn.shape[0], 4))
    for q, (xi, eta) in enumerate(QPTS):
        dn = np.stack([0.25 * _S * (1.0 + _T * eta), 0.25 * _T * (1.0 + _S * xi)], axis=1)
        J = np.einsum("na,enb->eab", dn, xl)
        det = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
        Jinv = np.linalg.inv(J)
        dxy = np.einsum("na,eba->enb", dn, Jinv)  # dN/dx, dN/dy
        B[:, q, 0, 0::2] = dxy[:, :, 0]
        B[:, q, 1, 1::2] = dxy[:, :, 1]
        B[:, q, 2, 0::2] = dxy[:, :, 1]
        B[:, q, 2, 1::2] = dxy[:, :, 0]
        dvol[:, q] = 10.0 * det
    return B, dvol


@dataclasses.dataclass
class Problem:
    """One configuration's FEM on one device, in float64 unless a solve asks
    for less. ``parts`` are the free-free stiffness parts (K_lam, K_mu) as
    SciPy CSR; ``obs`` the two observed free-dof positions; ``B_probe``
    (2, 3, 8) and ``lm_probe`` (8,) the stress probe."""

    nx: int
    ny: int
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
    nnz_parts: tuple  # nonzeros of K_lam, K_mu over all dofs

    @property
    def nfree(self):
        return self.free.shape[0]


def build_problem(config: dict, device) -> Problem:
    """The configuration's mesh, stiffness parts, load and probes."""
    nx, ny = config["mesh"]["nx"], config["mesh"]["ny"]
    coords, conn, fixed, f = cooks_mesh(nx, ny)
    ndof = 2 * coords.shape[0]
    B, dvol = quad4_b(coords, conn)
    lm = np.repeat(2 * conn, 2, axis=1) + np.tile([0, 1], 4)
    rows = np.repeat(lm, 8, axis=1).ravel()
    cols = np.tile(lm, (1, 8)).ravel()
    free = np.setdiff1d(np.arange(ndof), fixed)
    parts, nnz = [], []
    for C in (C_LAM, C_MU):
        ke = np.einsum("eqai,ab,eqbj,eq->eij", B, C, B, dvol)
        K = scipy.sparse.csr_matrix((ke.ravel(), (rows, cols)), shape=(ndof, ndof))
        K.sum_duplicates()
        nnz.append(int(np.count_nonzero(K.data)))
        parts.append(K[free][:, free].tocsr())
    probe = config["probe"]
    node, ele = probe["node_id"] - 1, probe["ele_id"] - 1
    pos = {d: i for i, d in enumerate(free)}
    tm = config["theta_map"]
    return Problem(
        nx=nx, ny=ny, ndof=ndof, free=free, parts=tuple(parts), f_free=f[free],
        obs=np.array([pos[2 * node], pos[2 * node + 1]]),
        B_probe=B[ele, np.asarray(probe["nipt_id"]) - 1], lm_probe=lm[ele],
        theta_mean=tuple(tm["mean"]), theta_std=tuple(tm["std"]),
        device=torch.device(device), nnz_parts=tuple(nnz))


def lame(problem: Problem, theta):
    """(lam, mu) of thetas (B, 2), differentiable."""
    E = torch.exp(problem.theta_std[0] * theta[:, 0] + problem.theta_mean[0])
    nu = 0.5 * torch.sigmoid(problem.theta_std[1] * theta[:, 1] + problem.theta_mean[1])
    return nu * E / ((1.0 + nu) * (1.0 - 2.0 * nu)), 0.5 * E / (1.0 + nu)


class Solver:
    """``solve(lam (B,), mu (B,), rhs (B, nfree)) -> K^-1 rhs`` in ``dtype``
    on the problem's device."""

    def __init__(self, problem: Problem, dtype=torch.float64, tol=None, maxiter=200,
                 dense=None):
        self.dtype, self.device = dtype, problem.device
        self.dense = problem.nfree <= DENSE_MAX if dense is None else dense
        self.tol = tol if tol is not None else 100.0 * torch.finfo(dtype).eps
        self.maxiter = maxiter
        kw = dict(dtype=dtype, device=self.device)
        if self.dense:
            self.K = [torch.as_tensor(P.toarray(), **kw) for P in problem.parts]
        else:
            def csr(P):
                return torch.sparse_csr_tensor(torch.as_tensor(P.indptr, device=self.device),
                                               torch.as_tensor(P.indices, device=self.device),
                                               torch.as_tensor(P.data, **kw), P.shape)

            self.K = [csr(P) for P in problem.parts]
            M = csr((problem.parts[0] + problem.parts[1]).tocsr()).to_dense()
            self.L = torch.linalg.cholesky(M)
            del M

    def part_apply(self, p, x):
        """K_p x for x (B, n)."""
        if self.dense:
            return x @ self.K[p]
        return torch.sparse.mm(self.K[p], x.T.contiguous()).T

    def apply(self, lam, mu, x):
        return lam[:, None] * self.part_apply(0, x) + mu[:, None] * self.part_apply(1, x)

    def solve(self, lam, mu, rhs):
        lam, mu, rhs = (t.to(self.dtype) for t in (lam, mu, rhs))
        if self.dense:
            K = lam[:, None, None] * self.K[0] + mu[:, None, None] * self.K[1]
            return torch.linalg.solve(K, rhs)
        # CG on K(c) x = rhs preconditioned by (K_lam + K_mu)^-1 / mu, each
        # lane to its own tolerance
        def prec(r):
            return torch.cholesky_solve(r.T.contiguous(), self.L).T / mu[:, None]

        x = torch.zeros_like(rhs)
        r = rhs.clone()
        z = prec(r)
        p = z.clone()
        rz = (r * z).sum(1)
        bb = (rhs * rhs).sum(1)
        for _ in range(self.maxiter):
            if bool(((r * r).sum(1) <= self.tol**2 * bb).all()):
                break
            kp = self.apply(lam, mu, p)
            pkp = (p * kp).sum(1)
            alpha = torch.where(pkp > 0, rz / pkp, 0.0)  # a lane already at 0 stays
            x = x + alpha[:, None] * p
            r = r - alpha[:, None] * kp
            z = prec(r)
            rz_new = (r * z).sum(1)
            p = z + torch.where(rz > 0, rz_new / rz, 0.0)[:, None] * p
            rz = rz_new
        return x


class _Solve(torch.autograd.Function):
    """u = K(lam, mu)^-1 f with the adjoint backward: w = K^-1 ubar,
    d/dlam = -w K_lam u, d/dmu = -w K_mu u."""

    @staticmethod
    def forward(ctx, lam, mu, f, solver):
        u = solver.solve(lam, mu, f)
        ctx.save_for_backward(lam, mu, u)
        ctx.solver = solver
        return u

    @staticmethod
    def backward(ctx, ubar):
        lam, mu, u = ctx.saved_tensors
        s = ctx.solver
        w = s.solve(lam, mu, ubar)
        return (-(w * s.part_apply(0, u)).sum(1), -(w * s.part_apply(1, u)).sum(1), None, None)


def von_mises(sig6):
    """The reference convention on (..., 6) stresses [s11, s22, s33, t12,
    t23, t31]: deviatoric normals, halved shears."""
    dev = sig6[..., :3] - sig6[..., :3].mean(-1, keepdim=True)
    shear = 0.5 * sig6[..., 3:]
    return torch.sqrt(0.5 * ((dev * dev).sum(-1) + (shear * shear).sum(-1)))


def observe(problem: Problem, solver: Solver, theta, with_h=True):
    """(y (B, 2), h (B, 2) or None) of thetas (B, 2), differentiable in
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
    eps = torch.einsum("qai,bi->bqa", Bp, ue)
    tr = eps[..., 0] + eps[..., 1]
    l, m = lam[:, None], mu[:, None]
    zero = torch.zeros_like(tr)
    sig6 = torch.stack([l * tr + 2 * m * eps[..., 0], l * tr + 2 * m * eps[..., 1], l * tr,
                        m * eps[..., 2], zero, zero], dim=-1)
    return y, von_mises(sig6)
