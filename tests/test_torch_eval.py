"""The port's MCMC, HMC, chain diagnostics and densities (``eval/mcmc.py``,
``eval/postprocess.py``) against the JAX package on the CPU.

The deterministic parts are held to the JAX package on the same numpy
arrays: ``ess_rhat`` and every density to 1e-12, the Cook's 20x10 float64
log-posterior and its gradient to 1e-10 (its Hessian, through the spectral
solve's double backward, to 1e-8), the posterior predictive without noise to
1e-10. The samplers draw other random numbers than JAX's, so they are held
to the JAX tests' targets and tolerances (tests/test_eval.py).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from vbicm_tpu.eval.mcmc import ess_rhat as jax_ess_rhat
from vbicm_tpu.eval.mcmc import make_fem_logpost as jax_make_fem_logpost
from vbicm_tpu.eval.mcmc import posterior_predictive_z as jax_posterior_predictive_z
from vbicm_tpu.eval import postprocess as jax_pp
from vbicm_tpu.solver import fea_solution as jax_fea_solution
from vbicm_tpu.solver import make_fh_fun as jax_make_fh_fun
from vbicm_tpu_torch.config import MaterialCard
from vbicm_tpu_torch.eval import postprocess as pp
from vbicm_tpu_torch.eval.mcmc import (
    ess_rhat,
    hmc,
    make_fem_logpost,
    metropolis,
    posterior_predictive_z,
)
from vbicm_tpu_torch.mesh import cooks_membrane_mesh
from vbicm_tpu_torch.model import build_fem_model
from vbicm_tpu_torch.solver import fea_solution, make_fh_fun


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS/OpenMP thread while this file runs: its arrays are small,
    and the test workers running in parallel share the cores."""
    with threadpool_limits(1):
        yield


@pytest.fixture(scope="module")
def model():
    return build_fem_model(cooks_membrane_mesh(20, 10), device="cpu")


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _std_normal(th):
    return -0.5 * torch.sum(th**2, dim=-1)


def _chains(kind):
    rng = np.random.default_rng(0)
    if kind == "iid":
        return rng.standard_normal((4, 2000, 2))
    if kind == "ar1":  # autocorrelated chains, ESS well below N
        x = np.zeros((4, 2001, 2))
        for t in range(1, 2001):
            x[:, t] = 0.9 * x[:, t - 1] + rng.standard_normal((4, 2))
        return x[:, 1:]
    stuck = np.stack([np.full((2000, 2), m, float) for m in (-3, -1, 1, 3)])
    return stuck + 0.01 * rng.standard_normal(stuck.shape)


@pytest.mark.parametrize("kind", ["iid", "ar1", "stuck"])
def test_ess_rhat_matches_jax(kind):
    s = _chains(kind)
    ess, rhat = ess_rhat(s)
    ess_j, rhat_j = jax_ess_rhat(s)
    assert _rel(ess, ess_j) <= 1e-12 and _rel(rhat, rhat_j) <= 1e-12
    # the calibration of tests/test_eval.py: IID draws ESS ~ N, R-hat ~ 1;
    # stuck chains R-hat > 3, ESS < 100
    if kind == "iid":
        assert np.all(rhat < 1.01) and np.all(ess > 0.6 * 8000)
    if kind == "stuck":
        assert np.all(rhat > 3.0) and np.all(ess < 100)


def test_densities_match_jax():
    rng = np.random.default_rng(0)
    z = np.exp(rng.normal(size=(4000, 2)) * 0.1 + np.array([0.5, 0.3]))
    pts = z[:100]
    m, v = [0.5, 0.3], [0.01, 0.01]
    assert _rel(pp.gaussian_kde_pdf(z, pts), jax_pp.gaussian_kde_pdf(z, pts)) <= 1e-12
    assert _rel(pp.lognormal_pdf_2d(pts, m, v), jax_pp.lognormal_pdf_2d(pts, m, v)) <= 1e-12
    q = lambda p: pp.lognormal_pdf_2d(p, m, v)  # noqa: E731
    kld, kld_j = pp.kld_gaussian_kde(z, q), jax_pp.kld_gaussian_kde(z, q)
    assert abs(kld - kld_j) <= 1e-12 * abs(kld_j) and abs(kld) < 0.5
    x = np.linspace(0.5, 3.0, 200)
    assert _rel(pp.lognormal_pdf_1d(x, 0.5, 0.04), jax_pp.lognormal_pdf_1d(x, 0.5, 0.04)) <= 1e-12
    assert _rel(pp.normal_pdf_1d(x, 1.2, 0.3), jax_pp.normal_pdf_1d(x, 1.2, 0.3)) <= 1e-12


def test_von_mises_field_and_plots_match_jax(model, cooks_model, tmp_path):
    vm = pp.von_mises_field(model, fea_solution(model, MaterialCard()))
    vm_j = jax_pp.von_mises_field(cooks_model, jax_fea_solution(cooks_model, MaterialCard()))
    assert vm.shape == (200,) and np.all(vm > 0) and _rel(vm, vm_j) <= 1e-10
    sol = fea_solution(model, MaterialCard())
    pp.plot_deformed_mesh(model, sol.u, path=str(tmp_path / "mesh.png"))
    x = np.linspace(0.5, 3.0, 50)
    pp.plot_pdf_comparison_1d(x, {"lognormal": pp.lognormal_pdf_1d(x, 0.5, 0.04)},
                              samples=np.exp(np.random.default_rng(1).normal(0.5, 0.2, 500)),
                              path=str(tmp_path / "pdf1d.png"))
    assert os.path.exists(tmp_path / "mesh.png") and os.path.exists(tmp_path / "pdf1d.png")


@pytest.fixture(scope="module")
def logposts(model, cooks_model):
    """Both packages' Cook's 20x10 log-posteriors at one noisy observation."""
    y = np.array([-4.2, 5.6])
    fh = make_fh_fun(model)
    return (make_fem_logpost(fh, y, 1e-2),
            jax_make_fem_logpost(jax_make_fh_fun(cooks_model), jnp.asarray(y), 1e-2))


def test_fem_logpost_value_and_gradient_match_jax(logposts):
    """16 thetas from a seed: the batched log-posterior and each chain's
    gradient against JAX's vmap / grad, 1e-10 relative."""
    lp, lp_j = logposts
    th = np.random.default_rng(2).normal(size=(16, 2))
    q = torch.tensor(th, requires_grad=True)
    val = lp(q)
    (g,) = torch.autograd.grad(val.sum(), q)
    val_j = jax.jit(jax.vmap(lp_j))(jnp.asarray(th))
    g_j = jax.jit(jax.vmap(jax.grad(lp_j)))(jnp.asarray(th))
    assert val.shape == (16,) and _rel(val.detach(), val_j) <= 1e-10 and _rel(g, g_j) <= 1e-10


def test_fem_logpost_hessian_matches_jax(logposts):
    """The Hessian through the spectral solve's double backward (two
    graph-building backward passes give every chain's 2x2 block) against
    jax.hessian, 1e-8 relative."""
    lp, lp_j = logposts
    th = np.random.default_rng(3).normal(size=(4, 2))
    q = torch.tensor(th, requires_grad=True)
    (g,) = torch.autograd.grad(lp(q).sum(), q, create_graph=True)
    H = torch.stack([torch.autograd.grad(g[:, i].sum(), q, retain_graph=True)[0]
                     for i in range(2)], dim=1)
    H_j = jax.jit(jax.vmap(jax.hessian(lp_j)))(jnp.asarray(th))
    assert _rel(H, H_j) <= 1e-8


def test_posterior_predictive_without_noise_is_jax_h(model, cooks_model):
    th = np.random.default_rng(4).normal(size=(32, 2))
    z = posterior_predictive_z(torch.Generator().manual_seed(0), make_fh_fun(model), th, 0.0)
    z_j = jax_posterior_predictive_z(jax.random.PRNGKey(0),
                                     jax.jit(jax.vmap(jax_make_fh_fun(cooks_model))), th, 0.0)
    assert z.shape == (32, 2) and _rel(z, z_j) <= 1e-10


def test_metropolis_standard_normal():
    """tests/test_eval.py's target and tolerances: N(0, I) moments, burn-in
    adaptation from a step size far off, split-R-hat ~ 1, healthy ESS."""
    res = metropolis(torch.Generator().manual_seed(0), _std_normal, d=2, n_samples=4000,
                     burn=500, n_chains=8, step_size=5.0, device="cpu")
    s = res.samples.reshape(-1, 2)
    assert res.samples.shape == (8, 4000, 2)
    assert 0.15 < res.accept_rate < 0.5
    assert res.step_size.shape == (8,) and np.all(res.step_size < 5.0)
    np.testing.assert_allclose(s.mean(axis=0), 0.0, atol=0.06)
    np.testing.assert_allclose(s.std(axis=0), 1.0, atol=0.06)
    assert np.all(res.rhat < 1.02), res.rhat
    assert np.all(res.ess > 500), res.ess
    assert np.all(np.abs(s.mean(axis=0)) < 6 * res.mean_mcse())


def test_hmc_standard_normal_and_efficiency():
    """tests/test_eval.py's HMC target and tolerances, and its ESS edge over
    random-walk Metropolis at the same length."""
    res = hmc(torch.Generator().manual_seed(0), _std_normal, d=2, n_samples=1500, burn=300,
              n_chains=8, step_size=1.0, n_leapfrog=8, device="cpu")
    s = res.samples.reshape(-1, 2)
    assert res.accept_rate > 0.55, res.accept_rate
    np.testing.assert_allclose(s.mean(axis=0), 0.0, atol=0.08)
    np.testing.assert_allclose(s.std(axis=0), 1.0, atol=0.08)
    assert np.all(res.rhat < 1.02), res.rhat
    assert res.ess.min() > 0.25 * 1500 * 8, res.ess
    rw = metropolis(torch.Generator().manual_seed(1), _std_normal, d=2, n_samples=1500,
                    burn=300, n_chains=8, step_size=1.0, device="cpu")
    assert res.ess.min() > 2.0 * rw.ess.min(), (res.ess, rw.ess)


def test_samplers_thin_and_start_where_told():
    init = torch.full((3, 2), 0.5, dtype=torch.float64)
    for sampler in (metropolis, hmc):
        res = sampler(torch.Generator().manual_seed(2), _std_normal, n_samples=20, burn=10,
                      thin=3, n_chains=3, init=init)
        assert res.samples.shape == (3, 20, 2) and np.isfinite(res.samples).all()
    with pytest.raises(ValueError, match="device"):
        metropolis(torch.Generator(), _std_normal, n_samples=2, burn=1)


def test_fem_chain_concentrates_near_the_truth(model):
    """A short port-only chain on Cook's 20x10 (4 chains x 200 after 200
    burn-in): the posterior of theta_1 (the E-scale, identified by the
    displacements) sits near theta_true (tests/test_eval.py's bound), and
    its posterior predictive is finite."""
    fh = make_fh_fun(model)
    with torch.no_grad():
        y_clean, _ = fh(torch.tensor([[0.5, -0.5]], dtype=torch.float64))
    res = metropolis(torch.Generator().manual_seed(1), make_fem_logpost(fh, y_clean[0], 1e-3),
                     d=2, n_samples=200, burn=200, n_chains=4, step_size=0.15, device="cpu")
    s = res.samples.reshape(-1, 2)
    assert abs(s[:, 0].mean() - 0.5) < 0.2
    z = posterior_predictive_z(torch.Generator().manual_seed(2), fh, s[:200], 3e-3)
    assert z.shape == (200, 2) and np.all(np.isfinite(z))
