"""The port's element-path matrix-free solvers against the JAX package
(CPU): Jacobi-PCG ``make_solver`` on matrix-free models, the gather grid
transfers, the element-path two-level solver (values, per-lane CG
iteration counts, adjoint) and ``fea_solution(solve_free=)``. The element
kernel's wrapper runs its plain version here."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from vbicm_tpu.config import MaterialCard as JaxMaterialCard
from vbicm_tpu.mesh import cooks_membrane_mesh as jax_cooks_mesh
from vbicm_tpu.model import build_fem_model as jax_build_fem_model
from vbicm_tpu.ops.assembly import element_matvec as jax_element_matvec
from vbicm_tpu.ops.multigrid import cooks_prolongation as jax_cooks_prolongation
from vbicm_tpu.ops.multigrid import (
    make_two_level_preconditioner as jax_make_two_level_preconditioner,
)
from vbicm_tpu.ops.solve import pcg as jax_pcg
from vbicm_tpu.solver import fea_solution as jax_fea_solution
from vbicm_tpu.solver import make_coarse_spectral_apply as jax_make_coarse_spectral_apply
from vbicm_tpu.solver import make_solver as jax_make_solver
from vbicm_tpu.solver import make_two_level_solver as jax_make_two_level_solver
from vbicm_tpu_torch.config import MaterialCard
from vbicm_tpu_torch.mesh import cooks_membrane_mesh
from vbicm_tpu_torch.model import build_fem_model
from vbicm_tpu_torch.ops.multigrid import cooks_prolongation, make_gather_transfer
from vbicm_tpu_torch.solver import fea_solution, make_solver, make_two_level_solver

NX, NY, R = 32, 16, 4  # the two-level cases: 32x16 fine (1,122 dofs), 8x4 coarse


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS/OpenMP thread while this file runs: its arrays are small,
    and the test workers running in parallel share the cores."""
    with threadpool_limits(1):
        yield


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max())


def _lam_mu(n, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(8.0, 16.0, n), rng.uniform(6.0, 9.0, n)


@pytest.fixture(scope="module")
def cooks20():
    """Cook's 20x10 matrix-free, both packages, and the port's dense model."""
    return (build_fem_model(cooks_membrane_mesh(20, 10), device="cpu", dense=False),
            jax_build_fem_model(jax_cooks_mesh(20, 10), dense=False),
            build_fem_model(cooks_membrane_mesh(20, 10), device="cpu", dense=True))


@pytest.mark.parametrize("kw,tol", [
    (dict(cg_tol=1e-12), 1e-10),
    (dict(factor_dtype="float32", refine_iters=3, cg_tol=1e-6), 1e-9),
], ids=["f64", "f32+3refinements"])
def test_make_solver_jacobi_pcg_matches_jax(cooks20, kw, tol):
    model, jmodel, _ = cooks20
    lam, mu = _lam_mu(3, 1)
    jkw = dict(kw)
    if "factor_dtype" in kw:
        jkw["factor_dtype"] = jnp.float32
        kw = {**kw, "factor_dtype": torch.float32}
    uj = np.asarray(jax.jit(jax.vmap(jax_make_solver(jmodel, **jkw)))(jnp.asarray(lam),
                                                                       jnp.asarray(mu)))
    solve = make_solver(model, **kw)
    u = solve(torch.as_tensor(lam), torch.as_tensor(mu)).numpy()
    # f64 Jacobi CG at tol 1e-12 on both sides: 1e-10 relative; f32 CG at
    # tol 1e-6 + three f64 refinements: within 1e-9 (the JAX package's own
    # mixed-precision test bound against f64 CG)
    assert _rel(u, uj) < tol
    assert len(solve.solver.last_cg_iters) == 1 + kw.get("refine_iters", 0)


def test_make_solver_matrix_free_matches_dense_spectral(cooks20):
    """Jacobi-PCG at tol 1e-14 against the dense spectral solve of the same
    mesh, the JAX package's test_matrix_free_cg_matches_dense bound."""
    model, _, dense = cooks20
    lam, mu = (torch.as_tensor(a) for a in _lam_mu(2, 2))
    u = make_solver(model, cg_tol=1e-14)(lam, mu)
    ud = make_solver(dense)(lam, mu)
    np.testing.assert_allclose(u.numpy(), ud.numpy(), atol=1e-8)


@pytest.mark.parametrize("nxc,nyc,r", [(5, 3, 2), (8, 4, 4)])
def test_gather_transfer_matches_jax_and_is_adjoint(nxc, nyc, r):
    idx, w = cooks_prolongation(nxc, nyc, r)
    nc, nf = 2 * (nxc + 1) * (nyc + 1), 2 * (nxc * r + 1) * (nyc * r + 1)
    mask = np.ones(nf)
    _, jprolong, jrestrict = jax_make_two_level_preconditioner(
        *jax_cooks_prolongation(nxc, nyc, r), lambda c, x: x, jnp.asarray(mask))
    rng = np.random.default_rng(nxc + r)
    uc, vf = rng.normal(size=(3, nc)), rng.normal(size=(3, nf))
    prolong, restrict = make_gather_transfer(idx, w)
    p = prolong(torch.as_tensor(uc)).numpy()
    rs = restrict(torch.as_tensor(vf)).numpy()
    # the same weights in float64, summation order aside: 1e-13
    assert _rel(p, jax.vmap(jprolong)(jnp.asarray(uc))) < 1e-13
    assert _rel(rs, jax.vmap(jrestrict)(jnp.asarray(vf))) < 1e-13
    # <P u, v> = <u, P^T v>: the restriction is the exact transpose
    lhs, rhs = (p * vf).sum(-1), (uc * rs).sum(-1)
    assert np.abs(lhs - rhs).max() <= 1e-12 * np.abs(lhs).max()
    # and float32 follows its input
    assert prolong(torch.as_tensor(uc, dtype=torch.float32)).dtype == torch.float32


@pytest.fixture(scope="module")
def two_level():
    """32x16 fine (matrix-free) and 8x4 coarse (dense) models, both packages."""
    return (jax_build_fem_model(jax_cooks_mesh(NX, NY), dense=False),
            jax_build_fem_model(jax_cooks_mesh(NX // R, NY // R), dense=True),
            build_fem_model(cooks_membrane_mesh(NX, NY), device="cpu", dense=False),
            build_fem_model(cooks_membrane_mesh(NX // R, NY // R), device="cpu", dense=True))


def test_element_two_level_solver_matches_jax_with_same_iterations(two_level):
    """float64 CG at tol 1e-10: the JAX package's element-path two-level
    solve, and its CG (the same preconditioner with the gather transfers,
    the element operator and the Jacobi diagonal) run lane by lane for the
    iteration counts."""
    jfine, jcoarse, fine, coarse = two_level
    lam, mu = _lam_mu(5, 3)
    js = jax_make_two_level_solver(jfine, jcoarse, NX // R, NY // R, R, tol=1e-10, maxiter=400)
    uj = np.asarray(jax.jit(jax.vmap(js))(jnp.asarray(lam), jnp.asarray(mu)))

    mask = np.asarray(jfine.free_mask)
    ke = np.stack([np.asarray(jfine.ke_lam), np.asarray(jfine.ke_mu)])
    dg = np.zeros((2, jfine.ndof))
    for p in range(2):
        np.add.at(dg[p], np.asarray(jfine.lm).reshape(-1),
                  np.diagonal(ke[p], axis1=1, axis2=2).reshape(-1))
    coeffs = np.stack([lam, mu], axis=1)
    dinv = np.where(mask > 0, 1.0 / (coeffs @ dg), 1.0)
    jprec, _, _ = jax_make_two_level_preconditioner(
        *jax_cooks_prolongation(NX // R, NY // R, R), jax_make_coarse_spectral_apply(jcoarse),
        jfine.free_mask, omega=0.6)
    b = np.asarray(jfine.f_ext) * mask

    def jax_cg(c, minv):
        def mv(x):
            y = sum(c[p] * jax_element_matvec(jnp.asarray(ke[p]), jfine.lm, x * mask, jfine.ndof)
                    for p in range(2))
            return y * mask + x * (1.0 - mask)
        return jax_pcg(mv, jnp.asarray(b), lambda r: jprec(c, minv, r), tol=1e-10,
                       maxiter=400)[1]

    itj = np.asarray(jax.jit(jax.vmap(jax_cg))(jnp.asarray(coeffs), jnp.asarray(dinv)))

    solve = make_two_level_solver(fine, coarse, NX // R, NY // R, R, tol=1e-10, maxiter=400)
    u = solve(torch.as_tensor(lam), torch.as_tensor(mu)).numpy()
    assert solve.solver.last_cg_iters[0].tolist() == itj.tolist()
    # float64 CG at tol 1e-10 on both sides: 1e-9 relative
    assert _rel(u, uj) < 1e-9


def test_element_two_level_mixed_precision_matches_jax(two_level):
    """float32 CG at tol 1e-4 + one float64 refinement, the trainer's form:
    the two packages' float32 roundings, in different orders, stay below
    1e-9 of max |u|."""
    jfine, jcoarse, fine, coarse = two_level
    lam, mu = _lam_mu(4, 4)
    kw = dict(refine_iters=1, tol=1e-4, maxiter=400)
    js = jax_make_two_level_solver(jfine, jcoarse, NX // R, NY // R, R, cg_dtype=jnp.float32, **kw)
    uj = np.asarray(jax.jit(jax.vmap(js))(jnp.asarray(lam), jnp.asarray(mu)))
    solve = make_two_level_solver(fine, coarse, NX // R, NY // R, R, cg_dtype=torch.float32, **kw)
    u = solve(torch.as_tensor(lam), torch.as_tensor(mu)).numpy()
    assert np.abs(u - uj).max() <= 1e-9 * np.abs(uj).max()


def test_element_two_level_adjoint_matches_autograd_through_dense(two_level):
    _, _, fine, coarse = two_level
    dense = build_fem_model(cooks_membrane_mesh(NX, NY), device="cpu", dense=True)
    lam, mu = _lam_mu(3, 5)
    wv = torch.as_tensor(np.random.default_rng(6).normal(size=(3, fine.ndof))) * fine.free_mask
    grads = []
    for solve in (make_two_level_solver(fine, coarse, NX // R, NY // R, R, tol=1e-12,
                                        maxiter=400),
                  make_solver(dense)):
        a, m = torch.tensor(lam, requires_grad=True), torch.tensor(mu, requires_grad=True)
        J = (solve(a, m) * wv).sum()
        grads.append(torch.stack(torch.autograd.grad(J, (a, m)), -1).numpy())
    # float64 CG at tol 1e-12 (the adjoint solve and the cotangents through
    # the element operator) against autograd through the spectral solve
    assert _rel(grads[0], grads[1]) < 1e-9


def test_element_two_level_rejects_stencil_only_transfers(two_level):
    _, _, fine, coarse = two_level
    for transfer in ("matmul", "dense"):
        with pytest.raises(ValueError):
            make_two_level_solver(fine, coarse, NX // R, NY // R, R, transfer=transfer)
    with pytest.raises(ValueError):  # a model that is not the refined grid
        make_two_level_solver(fine, coarse, NX // R, NY // R, 2)


def test_fea_solution_with_solve_free_matches_jax(cooks20):
    model, _, _ = cooks20
    jmodel = jax_build_fem_model(jax_cooks_mesh(20, 10))  # dense, the reference's path
    mat = MaterialCard(E=15.0, v=0.35)
    sol = fea_solution(model, mat, solve_free=make_solver(model, cg_tol=1e-14))
    jsol = jax_fea_solution(jmodel, JaxMaterialCard(**dataclasses.asdict(mat)))
    # Jacobi-PCG at tol 1e-14 against the JAX dense solve: 1e-8 absolute,
    # as the JAX package's own matrix-free check
    for got, want in ((sol.u, jsol.u), (sol.stress, jsol.stress), (sol.strain, jsol.strain),
                      (sol.reactions, jsol.reactions)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-8)
