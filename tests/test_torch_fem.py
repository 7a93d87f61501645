"""The port's FEM model, forward solve and batched observation operator
against the JAX package and the reference golden (CPU, float64)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from vbicm_tpu.config import ProblemConfig as JaxProblemConfig
from vbicm_tpu.solver import make_fh_fun as jax_make_fh_fun
from vbicm_tpu_torch.config import MaterialCard, ProblemConfig, SectionCard
from vbicm_tpu_torch.mesh import cooks_membrane_mesh
from vbicm_tpu_torch.model import build_fem_model
from vbicm_tpu_torch.solver import fea_solution, make_fh_fun, make_solver, probe_von_mises


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS/OpenMP thread while this file runs: its matrices are small,
    and the test workers running in parallel share the cores."""
    with threadpool_limits(1):
        yield


@pytest.fixture(scope="module")
def model():
    return build_fem_model(cooks_membrane_mesh(20, 10), device="cpu")


@pytest.fixture(scope="module")
def thetas():
    return np.random.default_rng(11).normal(size=(16, 2))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", ["coords", "lm", "free_dof", "f_free", "B", "dvol",
                                  "ke_lam", "ke_mu", "k_lam_ff", "k_mu_ff"])
def test_build_fem_model_matches_jax(model, cooks_model, name):
    ours = getattr(model, name).numpy()
    ref = np.asarray(getattr(cooks_model, name))
    assert ours.shape == ref.shape
    # 1e-12: both build the same float64 NumPy host arrays
    np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=0)


def test_build_fem_model_rejects_unported_branches():
    mesh = cooks_membrane_mesh(4, 2)
    with pytest.raises(NotImplementedError):
        build_fem_model(mesh, SectionCard(stype=1), device="cpu")
    prescribed = dataclasses.replace(mesh, disp_nodes=np.array([14], dtype=np.int32),
                                     disp_vals=np.array([[0.0, 1.0]]))
    with pytest.raises(NotImplementedError):
        build_fem_model(prescribed, device="cpu")


def test_fea_solution_matches_golden(model, golden):
    for case in golden:
        mat = MaterialCard(E=case["E"], v=case["v"])
        sol = fea_solution(model, mat)
        u = sol.u.numpy()
        lam = torch.tensor(mat.lam, dtype=torch.float64)
        mu = torch.tensor(mat.mu, dtype=torch.float64)
        vm = probe_von_mises(model, sol.u, lam, mu, 12, (1, 3)).numpy()
        # 1e-9: the golden's own precision, as tests/test_forward_parity.py
        np.testing.assert_allclose(u[460:462], case["u_node231"], rtol=0, atol=1e-9)
        np.testing.assert_allclose(vm, case["vm_e12_q13"], rtol=0, atol=1e-9)
        np.testing.assert_allclose(np.linalg.norm(u), case["u_norm"], rtol=0, atol=1e-9)
        np.testing.assert_allclose(sol.stress[11].numpy().T, case["stress_e12"], atol=1e-9)


@pytest.mark.parametrize("dense,kw", [
    (True, dict(method="spectral")),
    (True, dict(method="spectral", cg_tol=1e-3, cg_maxiter=2)),  # no CG on a dense model
    (False, dict(method="spectral", cg_tol=1e-6, cg_maxiter=4000)),
    (False, dict(method="cholesky", cg_tol=1e-12, cg_maxiter=7)),  # stops short of convergence
], ids=["dense", "dense_cg_kw_unused", "matfree_cg_tol", "matfree_cg_maxiter"])
def test_fh_takes_the_jax_solver_keywords(model, cooks_model, thetas, dense, kw):
    """make_fh_fun's method, cg_tol and cg_maxiter as the JAX package takes
    them: Cook's 20x10 dense (the spectral pencil), and 8x4 matrix-free
    (Jacobi-PCG, where the JAX package ignores ``method``)."""
    from vbicm_tpu.mesh import cooks_membrane_mesh as jax_cooks_mesh
    from vbicm_tpu.model import build_fem_model as jax_build_fem_model

    if dense:
        ours, jmodel = model, cooks_model
    else:
        ours = build_fem_model(cooks_membrane_mesh(8, 4), device="cpu", dense=False)
        jmodel = jax_build_fem_model(jax_cooks_mesh(8, 4), dense=False)
    cfg = dataclasses.replace(ProblemConfig(), node_id=ours.nnodes, ele_id=ours.nele // 2)
    jcfg = dataclasses.replace(JaxProblemConfig(), node_id=ours.nnodes, ele_id=ours.nele // 2)
    y_j, h_j = jax.jit(jax.vmap(jax_make_fh_fun(jmodel, jcfg, **kw)))(jnp.asarray(thetas[:4]))
    with torch.no_grad():
        y, h = make_fh_fun(ours, cfg, **kw)(torch.as_tensor(thetas[:4]))
    # float64 on both sides and the same solver: 1e-10 dense; matrix-free,
    # CG stopped early, where ~40 Jacobi-PCG iterations have amplified the
    # two packages' float64 roundings: 1e-8 (measured 3.7e-10 at tol 1e-6)
    tol = 1e-10 if dense else 1e-8
    assert _rel(y, y_j) < tol and _rel(h, h_j) < tol
    if not dense:  # the keyword took effect: away from the tol-1e-12 solve
        with torch.no_grad():
            y_conv, _ = make_fh_fun(ours, cfg)(torch.as_tensor(thetas[:4]))
        assert _rel(y, y_conv) > (1e-9 if kw["cg_maxiter"] > 100 else 1e-4)  # 3.8e-9, 0.70


def test_solver_methods_not_ported_raise(model, thetas):
    """The dense "cholesky" and "inverse" methods, once refused, match the
    spectral fh to 1e-12; an unknown method raises ``ValueError``."""
    th = torch.as_tensor(thetas)
    with torch.no_grad():
        y_s, h_s = make_fh_fun(model)(th)
        for method in ("cholesky", "inverse"):
            y, h = make_fh_fun(model, method=method)(th)
            assert _rel(y, y_s) < 1e-12 and _rel(h, h_s) < 1e-12, method
    with pytest.raises(ValueError):
        make_fh_fun(model, method="lu")
    with pytest.raises(ValueError):
        make_solver(build_fem_model(cooks_membrane_mesh(4, 2), device="cpu", dense=False),
                    method="lu")


@pytest.mark.parametrize("mixed", [False, True], ids=["f64", "f32_apply_1_refinement"])
def test_batched_fh_matches_jax_vmap(model, cooks_model, thetas, mixed):
    kw = dict(factor_dtype=jnp.float32, refine_iters=1) if mixed else {}
    y_j, h_j = jax.jit(jax.vmap(jax_make_fh_fun(cooks_model, JaxProblemConfig(), **kw)))(
        jnp.asarray(thetas))
    kw = dict(factor_dtype=torch.float32, refine_iters=1) if mixed else {}
    with torch.no_grad():
        y, h = make_fh_fun(model, ProblemConfig(), **kw)(torch.as_tensor(thetas))
    assert y.shape == (16, 2) and h.shape == (16, 2)
    # 1e-10 in float64; with the float32 apply one refinement lands both
    # packages ~1e-11 from the float64 answer, so 1e-9
    tol = 1e-9 if mixed else 1e-10
    assert _rel(y, y_j) < tol
    assert _rel(h, h_j) < tol


def test_fh_jacobian_matches_jax_jacrev(model, cooks_model, thetas):
    jac_y, jac_h = jax.jit(jax.vmap(jax.jacrev(jax_make_fh_fun(cooks_model))))(
        jnp.asarray(thetas))
    th = torch.tensor(thetas, requires_grad=True)
    y, h = make_fh_fun(model)(th)
    for out, ref in ((y, jac_y), (h, jac_h)):
        rows = [torch.autograd.grad(out[:, k].sum(), th, retain_graph=True)[0] for k in range(2)]
        ours = torch.stack(rows, dim=1).numpy()  # (16, out, theta), as jacrev
        # 1e-8 of the Jacobian's scale: dh/dE is analytically 0 and lands at
        # round-off in both packages
        np.testing.assert_allclose(ours, np.asarray(ref), rtol=0,
                                   atol=1e-8 * np.abs(np.asarray(ref)).max())
