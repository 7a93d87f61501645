"""The port's dense Cholesky and explicit-inverse solver against the JAX
package's ``make_dense_affine_solver`` on Cook's 8x4 (CPU): the solution
and its VJP in float64, the float32 factor with refinement, and a Hessian
through the solve's backward pass."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from vbicm_tpu.mesh import cooks_membrane_mesh as jax_cooks_membrane_mesh
from vbicm_tpu.model import build_fem_model as jax_build_fem_model
from vbicm_tpu.ops.solve import make_dense_affine_solver as jax_make_dense_affine_solver
from vbicm_tpu_torch.config import ProblemConfig
from vbicm_tpu_torch.eval.mcmc import make_fem_logpost
from vbicm_tpu_torch.mesh import cooks_membrane_mesh
from vbicm_tpu_torch.model import build_fem_model
from vbicm_tpu_torch.ops.solve import make_dense_affine_solver, make_spectral_affine_solver
from vbicm_tpu_torch.solver import make_fh_fun


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS/OpenMP thread while this file runs: its matrices are small,
    and the test workers running in parallel share the cores."""
    with threadpool_limits(1):
        yield


@pytest.fixture(scope="module")
def problem():
    """Cook's 8x4 parts in both packages, and B = 5 coefficient pairs,
    right-hand sides and output cotangents."""
    jm = jax_build_fem_model(jax_cooks_membrane_mesh(8, 4))
    parts_np = np.stack([np.asarray(jm.k_lam_ff), np.asarray(jm.k_mu_ff)])
    rng = np.random.default_rng(8)
    n = parts_np.shape[-1]
    coeffs = np.stack([rng.uniform(8.0, 16.0, 5), rng.uniform(6.0, 9.0, 5)], axis=1)
    return parts_np, coeffs, rng.normal(size=(5, n)), rng.normal(size=(5, n))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jax_solve_and_vjp(parts_np, coeffs, f, w, **kw):
    solve = jax.vmap(jax_make_dense_affine_solver(jnp.asarray(parts_np), **kw))
    u, vjp = jax.vjp(solve, jnp.asarray(coeffs), jnp.asarray(f))
    return (np.asarray(u), *(np.asarray(g) for g in vjp(jnp.asarray(w))))


def _torch_solve_and_vjp(parts_np, coeffs, f, w, **kw):
    solve = make_dense_affine_solver(torch.as_tensor(parts_np), **kw)
    c = torch.tensor(coeffs, requires_grad=True)
    b = torch.tensor(f, requires_grad=True)
    u = solve(c, b)
    gc, gf = torch.autograd.grad((u * torch.as_tensor(w)).sum(), (c, b))
    return u.detach().numpy(), gc.numpy(), gf.numpy()


@pytest.mark.parametrize("method", ["cholesky", "inverse"])
def test_dense_solve_and_vjp_match_jax_f64(problem, method):
    ours = _torch_solve_and_vjp(*problem, method=method)
    ref = _jax_solve_and_vjp(*problem, method=method)
    # 1e-12: one float64 factorization of the same matrix on each side
    for name, a, b in zip(("u", "coeff cotangent", "f cotangent"), ours, ref):
        assert _rel(a, b) < 1e-12, (name, _rel(a, b))


@pytest.mark.parametrize("method", ["cholesky", "inverse", "auto"])
def test_dense_f32_factor_with_refinement_is_within_twice_jax(problem, method):
    """A float32 factor and two float64 refinements: the port's error to the
    float64 solve is at most twice the JAX package's."""
    exact = _jax_solve_and_vjp(*problem, method="cholesky")
    kw = dict(method=method, refine_iters=2)
    ours = _torch_solve_and_vjp(*problem, factor_dtype=torch.float32, **kw)
    ref = _jax_solve_and_vjp(*problem, factor_dtype=jnp.float32, **kw)
    for a, b, x in zip(ours, ref, exact):
        assert _rel(a, x) <= max(2.0 * _rel(b, x), 1e-15), (_rel(a, x), _rel(b, x))
    parts = torch.as_tensor(problem[0])
    assert make_dense_affine_solver(parts, factor_dtype=torch.float32).method == "inverse"
    assert make_dense_affine_solver(parts).method == "cholesky"
    with pytest.raises(ValueError):
        make_dense_affine_solver(parts, method="lu")


@pytest.mark.parametrize("method", ["cholesky", "inverse"])
def test_hessian_through_the_dense_solve_matches_spectral(method):
    """The log-posterior's Hessian (a second derivative through the solve's
    backward pass) with the dense solve equals the spectral solve's."""
    model = build_fem_model(cooks_membrane_mesh(8, 4), device="cpu")
    cfg = ProblemConfig(node_id=45, ele_id=12)
    theta = torch.tensor([[0.3, -0.4], [-0.7, 0.2]], dtype=torch.float64)
    y_obs = make_fh_fun(model, cfg)(theta[:1])[0][0].detach() + 0.05
    hess = []
    for m in ("spectral", method):
        lp = make_fem_logpost(make_fh_fun(model, cfg, method=m), y_obs, cfg.sig_e)
        q = theta.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(lp(q).sum(), q, create_graph=True)
        hess.append(torch.stack([torch.autograd.grad(g[:, i].sum(), q, retain_graph=True)[0]
                                 for i in range(2)], dim=1))
    # 1e-9: two float64 solvers of the same system, differentiated twice
    assert _rel(hess[1], hess[0]) < 1e-9


def test_dense_solve_equals_spectral_solve(problem):
    parts_np, coeffs, f, _ = problem
    parts, c, b = (torch.as_tensor(a) for a in (parts_np, coeffs, f))
    u = make_spectral_affine_solver(parts)(c, b)
    for method in ("cholesky", "inverse"):
        assert _rel(make_dense_affine_solver(parts, method=method)(c, b), u) < 1e-12
