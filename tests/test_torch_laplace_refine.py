"""The port's MAP + Laplace posterior (``eval/laplace.py``), per-observation
refinement (``vi/refine.py``) and the full-covariance step-1 loss with the
``e=`` override (``vi/elbo.py``) against the JAX package (CPU, float64).

Laplace: exact on the linear-Gaussian case to 1e-8; on Cook's 20x10 the
mode within 1e-6 and the covariance within rtol 1e-5 of the JAX package's
(the L-BFGS iterates differ, the point they converge to does not). The
Hessian through the matrix-free two-level solve's double backward (16x8,
stencil and element paths): rtol 1e-6 of ``jax.hessian``. The
losses: 1e-12 on the same e. Refinement: its learning rate equals optax's
schedule at every step to 1e-15, chunking leaves the trajectory bitwise
unchanged, and it recovers the exact correlated posterior
(tests/test_refine.py's tolerances).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from threadpoolctl import threadpool_limits

from vbicm_tpu.eval.laplace import laplace_posterior as jax_laplace_posterior
from vbicm_tpu.eval.mcmc import make_fem_logpost as jax_make_fem_logpost
from vbicm_tpu.mesh import cooks_membrane_mesh as jax_cooks_mesh
from vbicm_tpu.model import build_fem_model as jax_build_fem_model
from vbicm_tpu.config import ProblemConfig as JaxProblemConfig
from vbicm_tpu.solver import make_fh_fun as jax_make_fh_fun
from vbicm_tpu.solver import make_two_level_solver as jax_make_two_level_solver
from vbicm_tpu.vi.elbo import make_loss_step1 as jax_make_loss_step1
from vbicm_tpu.vi.elbo import make_loss_step1_fullcov as jax_make_loss_step1_fullcov
from vbicm_tpu.vi.elbo import make_loss_step2 as jax_make_loss_step2
from vbicm_tpu_torch.eval.laplace import laplace_posterior
from vbicm_tpu_torch.eval.mcmc import make_fem_logpost
from vbicm_tpu_torch.mesh import cooks_membrane_mesh
from vbicm_tpu_torch.model import build_fem_model
from vbicm_tpu_torch.config import ProblemConfig
from vbicm_tpu_torch.solver import make_fh_fun, make_two_level_solver
from vbicm_tpu_torch.vi.elbo import make_loss_step1, make_loss_step1_fullcov, make_loss_step2
from vbicm_tpu_torch.vi.refine import refine_lr, refine_posterior

# correlated linear-Gaussian: exact posterior known in closed form
A = np.array([[1.0, 1.0], [0.0, 0.15]])
SIG_E = 0.05
Y = np.array([0.9, 0.1])
PREC = np.eye(2) + A.T @ A / SIG_E
SIGMA = np.linalg.inv(PREC)
MU = SIGMA @ (A.T @ Y / SIG_E)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS/OpenMP thread while this file runs: its arrays are small,
    and the test workers running in parallel share the cores."""
    with threadpool_limits(1):
        yield


def _linear_logpost(t):
    r = torch.as_tensor(Y) - t @ torch.as_tensor(A).T
    return -0.5 * torch.sum(r**2, dim=-1) / SIG_E - 0.5 * torch.sum(t**2, dim=-1)


def test_laplace_exact_on_linear_gaussian():
    res = laplace_posterior(_linear_logpost, torch.zeros(2, dtype=torch.float64))
    assert res.converged and res.grad_norm < 1e-8
    np.testing.assert_allclose(res.theta_map, MU, atol=1e-8)
    np.testing.assert_allclose(res.cov, SIGMA, rtol=1e-8)


def test_laplace_rejects_saddle():
    def logpost(t):
        return 0.5 * t[:, 0] ** 2 - 0.5 * t[:, 1] ** 2  # saddle at 0

    with pytest.raises(ValueError, match="positive definite"):
        laplace_posterior(logpost, torch.tensor([0.3, 0.2], dtype=torch.float64), max_iters=5)


def test_laplace_on_cooks_matches_jax(cooks_model):
    """Cook's 20x10, one noisy observation: the mode within 1e-6 and the
    covariance (the inverse of the Hessian through the solve's double
    backward) within rtol 1e-5 of the JAX package's laplace_posterior."""
    model = build_fem_model(cooks_membrane_mesh(20, 10), device="cpu")
    y = np.array([-4.2, 5.6])
    res = laplace_posterior(make_fem_logpost(make_fh_fun(model), y, 1e-2),
                            torch.zeros(2, dtype=torch.float64), tol=1e-7)
    res_j = jax_laplace_posterior(
        jax_make_fem_logpost(jax_make_fh_fun(cooks_model), jnp.asarray(y), 1e-2),
        jnp.zeros(2), tol=1e-7)
    assert res.converged and res_j.converged
    np.testing.assert_allclose(res.theta_map, res_j.theta_map, rtol=0, atol=1e-6)
    np.testing.assert_allclose(res.cov, res_j.cov, rtol=1e-5)
    assert abs(res.logpost_map - res_j.logpost_map) <= 1e-8 * abs(res_j.logpost_map)


@pytest.mark.parametrize("use_stencil", [True, False], ids=["stencil", "element"])
def test_two_level_fh_hessian_matches_jax(use_stencil):
    """The log-posterior's Hessian through the matrix-free two-level solve
    (16x8 on an 8x4 coarse grid, float64, tol 1e-12; the backward pass
    differentiated once more) at two thetas against jax.hessian: rtol
    1e-6."""
    nx, ny, r = 16, 8, 2
    model = build_fem_model(cooks_membrane_mesh(nx, ny), device="cpu", dense=False)
    coarse = build_fem_model(cooks_membrane_mesh(nx // r, ny // r), device="cpu", dense=True)
    jmodel = jax_build_fem_model(jax_cooks_mesh(nx, ny), dense=False)
    jcoarse = jax_build_fem_model(jax_cooks_mesh(nx // r, ny // r), dense=True)
    kw = dict(node_id=model.nnodes, ele_id=(ny // 2) * nx + 3)
    kws = dict(tol=1e-12, maxiter=500, use_stencil=use_stencil)
    fh = make_fh_fun(model, ProblemConfig(**kw), solve_free=make_two_level_solver(
        model, coarse, nx // r, ny // r, r, **kws))
    jfh = jax_make_fh_fun(jmodel, JaxProblemConfig(**kw), solve_free=jax_make_two_level_solver(
        jmodel, jcoarse, nx // r, ny // r, r, **kws))
    y = np.asarray(jfh(jnp.asarray([0.3, -0.2]))[0]) + 0.01
    lp = make_fem_logpost(fh, y, 1e-2)
    jhess = jax.jit(jax.hessian(jax_make_fem_logpost(jfh, jnp.asarray(y), 1e-2)))
    for t in (np.array([0.3, -0.2]), np.array([-0.5, 0.8])):
        H = torch.autograd.functional.hessian(lambda x: lp(x[None])[0], torch.as_tensor(t))
        np.testing.assert_allclose(H.numpy(), np.asarray(jhess(jnp.asarray(t))), rtol=1e-6)


def _loss_inputs(seed, B=3, ne=5, d=2):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(B, 2))
    mu = rng.normal(size=(B, d))
    L = np.tril(rng.normal(size=(B, d, d))) * 0.3
    L[:, range(d), range(d)] = np.abs(L[:, range(d), range(d)]) + 0.2
    log_diag = 2.0 * np.log(L[:, range(d), range(d)])
    return y, mu, L, log_diag, rng.normal(size=(ne, d)), rng.normal(size=(ne, d))


def _f(th):
    return torch.tanh(th) * torch.tensor([2.0, -1.0], dtype=th.dtype)


def _f_j(th):
    return jnp.tanh(th) * jnp.asarray([2.0, -1.0])


def test_fullcov_loss_and_e_override_match_jax():
    """The full-covariance step-1 loss and the mean-field step-1 and step-2
    losses with ``e=`` in place of the fixed seeds, on the same arrays:
    1e-12 relative."""
    y, mu, L, log_diag, e_fixed, e = _loss_inputs(7)
    t = torch.as_tensor
    got = make_loss_step1_fullcov(_f, t(e_fixed), 0.05)(t(y), (t(mu), t(L), t(log_diag)), t(e))
    want = jax_make_loss_step1_fullcov(_f_j, jnp.asarray(e_fixed), 0.05)(
        jnp.asarray(y), (jnp.asarray(mu), jnp.asarray(L), jnp.asarray(log_diag)),
        jnp.asarray(e))
    assert abs(float(got) - float(want)) <= 1e-12 * abs(float(want))
    sig = np.exp(log_diag)
    for pairing in ("cross", "per_sample"):
        got = make_loss_step1(_f, t(e_fixed), 0.05, pairing)(t(y), (t(mu), t(sig), t(log_diag)),
                                                            t(e))
        want = jax_make_loss_step1(_f_j, jnp.asarray(e_fixed), 0.05, pairing)(
            jnp.asarray(y), (jnp.asarray(mu), jnp.asarray(sig), jnp.asarray(log_diag)),
            jnp.asarray(e))
        assert abs(float(got) - float(want)) <= 1e-12 * abs(float(want))
        # the override is used: the fixed seeds give another value
        assert float(make_loss_step1(_f, t(e_fixed), 0.05, pairing)(
            t(y), (t(mu), t(sig), t(log_diag)))) != float(got)
        zm, zs = np.log(np.abs(y) + 1.0), np.full_like(y, 1e-3)
        batch = (t(y), t(zm + 0.01), t(zs * 1.1))
        outs = (t(mu), t(sig), t(zm), t(zs), t(np.log(zs)))
        got = make_loss_step2(_f, t(e_fixed), 3e-3, 1e-3, pairing)(batch, outs, t(e))
        want = jax_make_loss_step2(_f_j, jnp.asarray(e_fixed), 3e-3, 1e-3, pairing)(
            tuple(jnp.asarray(b.numpy()) for b in batch),
            tuple(jnp.asarray(o.numpy()) for o in outs), jnp.asarray(e))
        assert abs(float(got) - float(want)) <= 1e-12 * abs(float(want))


@pytest.mark.parametrize("steps,lr", [(1500, 1e-2), (50, 5e-2), (7, 5e-3), (1, 1e-3)])
def test_refine_lr_is_optax_schedule(steps, lr):
    hold = int(0.6 * steps)
    sched = optax.join_schedules(
        [optax.constant_schedule(lr),
         optax.cosine_decay_schedule(lr, max(steps - hold, 1), alpha=0.02)], [hold])
    want = np.asarray(jax.vmap(sched)(jnp.arange(steps, dtype=jnp.int32)))
    got = np.array([refine_lr(lr, steps, t) for t in range(steps)])
    assert np.abs(got - want).max() <= 1e-15


def test_refine_chunked_matches_monolithic_bitwise():
    """chunk_steps (a tail chunk that does not divide steps included) leaves
    the trajectory, and so mu, L and every loss, unchanged bit for bit."""
    y = torch.tensor([0.8, -0.2], dtype=torch.float64)
    mu0, L0 = torch.zeros(2, dtype=torch.float64), 0.4 * torch.eye(2, dtype=torch.float64)
    out = [refine_posterior(_f, y, 0.05, mu0, L0, generator=torch.Generator().manual_seed(3),
                            steps=50, ne=4, lr=5e-2, chunk_steps=c) for c in (0, 15)]
    for a, b in zip(*out):
        assert torch.equal(a, b)
    assert out[0][2].shape == (50,)


def test_refine_recovers_exact_posterior_from_collapsed_init():
    """tests/test_refine.py: from a collapsed, biased init, refinement
    converges to the exact correlated posterior."""
    At = torch.as_tensor(A)
    mu, L, losses = refine_posterior(
        lambda th: th @ At.T, Y, SIG_E, torch.as_tensor(MU + 0.5), 0.01 * torch.eye(2,
                                                                                     dtype=At.dtype),
        generator=torch.Generator().manual_seed(0), steps=4000, ne=16, lr=2e-2)
    np.testing.assert_allclose(mu.numpy(), MU, atol=0.05)
    np.testing.assert_allclose((L @ L.T).numpy(), SIGMA, rtol=0.2, atol=5e-4)
    assert float(losses[-100:].mean()) < float(losses[:100].mean())
