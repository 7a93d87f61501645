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
from vbicm_tpu_torch.solver import fea_solution, make_fh_fun, probe_von_mises


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
