"""The port's random-field family (``prob/randomfield.py`` and the field
solver of ``ops/solve.py``) against the JAX package on the CPU, float64, on
the same numpy arrays.

The KL basis equals JAX's (dense at 10x5, and the randomized path) to 1e-12
up to each mode's sign. The field solve at 10x5 and on the 4x2x2 box, in the
lm-table and the structured-grid mode, at B = 3 fields: u within 1e-10 of
JAX's per-field solve, E-gradients within rtol 1e-8. The mean-field two-level
preconditioner at 16x8, ratio 4: u 1e-9, theta-gradients rtol 1e-6
(tests/test_randomfield.py's tolerances). The observation operator: y and h
1e-10, theta-gradients rtol 1e-8. The Hessian of the log-posterior through
the field solve's double backward: rtol 1e-6 of ``jax.hessian``; Laplace
through it: mode 1e-5, covariance rtol 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from vbicm_tpu.config import ProblemConfig as JaxProblemConfig
from vbicm_tpu.config import SectionCard as JaxSectionCard
from vbicm_tpu.eval.laplace import laplace_posterior as jax_laplace_posterior
from vbicm_tpu.eval.mcmc import make_fem_logpost as jax_make_fem_logpost
from vbicm_tpu.mesh import cooks_membrane_mesh as jax_cooks_mesh
from vbicm_tpu.mesh.solid3d import beam_hex8_mesh as jax_beam_hex8_mesh
from vbicm_tpu.model import build_fem_model as jax_build_fem_model
from vbicm_tpu.ops.multigrid import make_grid_transfer_conv as jax_make_grid_transfer_conv
from vbicm_tpu.ops.solve import make_field_solver as jax_make_field_solver
from vbicm_tpu.prob import randomfield as jrf
from vbicm_tpu_torch.config import ProblemConfig, SectionCard
from vbicm_tpu_torch.eval.laplace import laplace_posterior
from vbicm_tpu_torch.eval.mcmc import make_fem_logpost
from vbicm_tpu_torch.mesh import beam_hex8_mesh, cooks_membrane_mesh
from vbicm_tpu_torch.model import build_fem_model
from vbicm_tpu_torch.ops.element import lame_from_Ev
from vbicm_tpu_torch.ops.multigrid import make_grid_transfer_nd
from vbicm_tpu_torch.ops.solve import make_field_solver
from vbicm_tpu_torch.prob import randomfield as rf

NU = 0.3
N_MODES = 6
PROBES = tuple(range(8, 67, 6))  # tests/test_randomfield.py's 10 probes
CFG = dict(theta_dim=N_MODES, y_dim=2 * len(PROBES), ele_id=5)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS/OpenMP thread while this file runs: its arrays are small,
    and the test workers running in parallel share the cores."""
    with threadpool_limits(1):
        yield


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jax_kl(kl):
    """The JAX package's KLExpansion on the port's arrays."""
    return jrf.KLExpansion(modes=kl.modes, eigvals=kl.eigvals, mean_log=kl.mean_log,
                           corr_len=kl.corr_len, sigma=kl.sigma)


def _ke_unit(model):
    lam1, mu1 = lame_from_Ev(1.0, NU)
    return lam1 * model.ke_lam + mu1 * model.ke_mu


@pytest.fixture(scope="module")
def cooks():
    """Cook's 10x5 in both packages and the port's 6-mode KL basis."""
    model = build_fem_model(cooks_membrane_mesh(10, 5), device="cpu")
    kl = rf.build_kl_expansion(model, n_modes=N_MODES, corr_len=15.0, sigma=0.3)
    return jax_build_fem_model(jax_cooks_mesh(10, 5), dense=True), model, kl


@pytest.fixture(scope="module")
def box():
    """The 4x2x2 hex8 box in both packages and a 6-mode KL basis."""
    jmodel = jax_build_fem_model(jax_beam_hex8_mesh(4, 2, 2, lx=4.0), JaxSectionCard(stype=4),
                                 dense=True)
    model = build_fem_model(beam_hex8_mesh(4, 2, 2, lx=4.0), SectionCard(stype=4), device="cpu")
    kl = rf.build_kl_expansion(model, n_modes=N_MODES, corr_len=2.0, sigma=0.3)
    return jmodel, model, kl


@pytest.mark.parametrize("threshold", [2000, 0], ids=["dense", "randomized"])
def test_kl_basis_matches_jax(cooks, threshold):
    jmodel, model, _ = cooks
    kw = dict(n_modes=N_MODES, corr_len=15.0, sigma=0.3, dense_eigh_threshold=threshold)
    kl, jkl = rf.build_kl_expansion(model, **kw), jrf.build_kl_expansion(jmodel, **kw)
    np.testing.assert_allclose(rf.element_centroids(model), jrf.element_centroids(jmodel),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(kl.eigvals, jkl.eigvals, rtol=1e-12)
    for k in range(N_MODES):
        sign = np.sign(kl.modes[k] @ jkl.modes[k])
        assert _rel(sign * kl.modes[k], jkl.modes[k]) <= 1e-12
    assert (kl.mean_log, kl.corr_len, kl.sigma) == (jkl.mean_log, jkl.corr_len, jkl.sigma)


def _fields(kl, B, seed):
    return np.exp(kl.mean_log + np.random.default_rng(seed).standard_normal((B, kl.n_modes))
                  @ kl.modes)


@pytest.mark.parametrize("mesh,grid", [("cooks", None), ("cooks", (10, 5)), ("box", None),
                                       ("box", (4, 2, 2))])
def test_field_solve_and_gradient_match_jax(cooks, box, mesh, grid):
    """Three fields at once against JAX's solve of each: u 1e-10; the
    E-gradient of sum(w * u) (the adjoint and Ebar) rtol 1e-8."""
    jmodel, model, kl = cooks if mesh == "cooks" else box
    solve = make_field_solver(_ke_unit(model), model.lm, model.free_mask, model.ndof, grid=grid)
    jsolve = jax_make_field_solver(_ke_unit(model).numpy(), np.asarray(jmodel.lm),
                                   jmodel.free_mask, jmodel.ndof, grid=grid)
    E = _fields(kl, 3, seed=7)
    w = np.random.default_rng(8).standard_normal((3, model.ndof))
    f = model.f_ext.numpy()
    Et = torch.as_tensor(E).requires_grad_(True)
    u = solve(Et, torch.as_tensor(f).expand(3, -1))
    (g,) = torch.autograd.grad((torch.as_tensor(w) * u).sum(), Et)
    ju = jax.jit(jax.vmap(lambda e: jsolve(e, jnp.asarray(f))))(jnp.asarray(E))
    jg = jax.jit(jax.vmap(jax.grad(lambda e, wb: jnp.sum(wb * jsolve(e, jnp.asarray(f))))))(
        jnp.asarray(E), jnp.asarray(w))
    for b in range(3):
        assert _rel(u[b].detach(), ju[b]) <= 1e-10
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-8, atol=0)


@pytest.mark.parametrize("mesh,grid", [("cooks", (5, 10)), ("cooks", (10, 4)),
                                       ("box", (2, 2, 4)), ("box", (4, 2))])
def test_wrong_grid_raises(cooks, box, mesh, grid):
    _, model, _ = cooks if mesh == "cooks" else box
    with pytest.raises(ValueError):
        make_field_solver(_ke_unit(model), model.lm, model.free_mask, model.ndof, grid=grid)


def test_lm_and_grid_modes_agree_and_repeat(cooks):
    """The two gather/scatter forms give the same solve (1e-12), and each
    scatter repeats bit for bit."""
    _, model, kl = cooks
    E = torch.as_tensor(_fields(kl, 4, seed=1))
    f = model.f_ext.expand(4, -1)
    out = []
    for grid in (None, (10, 5)):
        s = make_field_solver(_ke_unit(model), model.lm, model.free_mask, model.ndof, grid=grid)
        qe = torch.randn((4, model.nele, 8), generator=torch.Generator().manual_seed(2),
                         dtype=torch.float64)
        assert torch.equal(s.scatter(qe), s.scatter(qe))
        out.append((s(E, f), s.scatter(qe)))
    assert _rel(out[1][0], out[0][0]) <= 1e-12
    assert _rel(out[1][1], out[0][1]) <= 1e-12


@pytest.mark.parametrize("nxc,nyc,r", [(4, 2, 4), (20, 10, 4)])
def test_mean_field_transfer_is_jax_conv(nxc, nyc, r):
    """The mean-field preconditioner's transfers on Cook's (the 16x8 test
    grid and the 80x40 example's) equal JAX's conv-form transfers."""
    nc, nf = 2 * (nxc + 1) * (nyc + 1), 2 * (nxc * r + 1) * (nyc * r + 1)
    rng = np.random.default_rng(nxc)
    uc, rf_ = rng.normal(size=(2, nc)), rng.normal(size=(2, nf))
    prolong, restrict = make_grid_transfer_nd((nyc, nxc), r, 2)
    jprolong, jrestrict = jax_make_grid_transfer_conv(nxc, nyc, r)
    for b in range(2):
        assert _rel(prolong(torch.as_tensor(uc))[b], jprolong(jnp.asarray(uc[b]))) <= 1e-13
        assert _rel(restrict(torch.as_tensor(rf_))[b], jrestrict(jnp.asarray(rf_[b]))) <= 1e-13


def test_mean_field_preconditioner_matches_jax():
    """16x8, ratio 4: the two-level mean-field-preconditioned field solve of
    three fields against JAX's (u 1e-9) and the theta-gradients rtol 1e-6."""
    ratio, nx, ny = 4, 16, 8
    jmodel = jax_build_fem_model(jax_cooks_mesh(nx, ny), dense=False)
    jcoarse = jax_build_fem_model(jax_cooks_mesh(nx // ratio, ny // ratio), dense=True)
    model = build_fem_model(cooks_membrane_mesh(nx, ny), device="cpu", dense=False)
    coarse = build_fem_model(cooks_membrane_mesh(nx // ratio, ny // ratio), device="cpu",
                             dense=True)
    kl = rf.build_kl_expansion(model, n_modes=N_MODES, corr_len=15.0, sigma=0.3)
    prec = rf.make_mean_field_preconditioner(coarse, nx // ratio, ny // ratio, ratio,
                                             model.free_mask, nu=NU, E0=20.0)
    jprec = jrf.make_mean_field_preconditioner(jcoarse, nx // ratio, ny // ratio, ratio,
                                               jmodel.free_mask, nu=NU, E0=20.0)
    solve = make_field_solver(_ke_unit(model), model.lm, model.free_mask, model.ndof,
                              preconditioner=prec)
    jsolve = jax_make_field_solver(_ke_unit(model).numpy(), np.asarray(jmodel.lm),
                                   jmodel.free_mask, jmodel.ndof, preconditioner=jprec)
    theta = np.random.default_rng(3).standard_normal((3, N_MODES))
    f = model.f_ext.numpy()
    jkl = _jax_kl(kl)
    th = torch.as_tensor(theta).requires_grad_(True)
    u = solve(rf.field_from_theta(kl, th), torch.as_tensor(f).expand(3, -1))
    (g,) = torch.autograd.grad((u**2).sum(), th)

    def jax_u(t):
        return jsolve(jrf.field_from_theta(jkl, t), jnp.asarray(f))

    ju = jax.jit(jax.vmap(jax_u))(jnp.asarray(theta))
    jg = jax.jit(jax.vmap(jax.grad(lambda t: jnp.sum(jax_u(t) ** 2))))(jnp.asarray(theta))
    np.testing.assert_allclose(u.detach().numpy(), np.asarray(ju), rtol=0, atol=1e-9)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6)
    # the preconditioned CG converges in fewer iterations than Jacobi
    jacobi = make_field_solver(_ke_unit(model), model.lm, model.free_mask, model.ndof)
    with torch.no_grad():
        jacobi(rf.field_from_theta(kl, th), torch.as_tensor(f).expand(3, -1))
        solve(rf.field_from_theta(kl, th), torch.as_tensor(f).expand(3, -1))
    assert int(solve.last_cg_iters[0].max()) < int(jacobi.last_cg_iters[0].min())


@pytest.mark.parametrize("mesh", ["cooks", "box"])
def test_fh_and_gradient_match_jax(cooks, box, mesh):
    """y and h of three thetas within 1e-10 of JAX's fh; the theta-gradient
    of sum(y^2) + sum(h) within rtol 1e-8."""
    jmodel, model, kl = cooks if mesh == "cooks" else box
    if mesh == "cooks":
        cfg, probes, grid = CFG, PROBES, (10, 5)
    else:
        cfg = dict(theta_dim=N_MODES, y_dim=12, ele_id=8, nipt_id=(1, 5))
        probes, grid = [model.nnodes, model.nnodes - 1, model.nnodes - 4, 20], (4, 2, 2)
    fh = rf.make_fh_fun_field(model, kl, ProblemConfig(**cfg), probe_nodes=probes, nu=NU,
                              grid=grid)
    jfh = jrf.make_fh_fun_field(jmodel, _jax_kl(kl), JaxProblemConfig(**cfg), probe_nodes=probes,
                                nu=NU, grid=grid)
    theta = np.random.default_rng(5).standard_normal((3, N_MODES)) * 0.8
    th = torch.as_tensor(theta).requires_grad_(True)
    y, h = fh(th)
    (g,) = torch.autograd.grad((y**2).sum() + h.sum(), th)

    def jloss(t):
        jy, jh = jfh(t)
        return jnp.sum(jy**2) + jnp.sum(jh)

    jy, jh = jax.jit(jax.vmap(jfh))(jnp.asarray(theta))
    jg = jax.jit(jax.vmap(jax.grad(jloss)))(jnp.asarray(theta))
    for b in range(3):
        assert _rel(y[b].detach(), jy[b]) <= 1e-10 and _rel(h[b].detach(), jh[b]) <= 1e-10
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-8)


def test_fh_float32_cg_with_one_refinement(cooks):
    """The trainer's policy, float32 CG at tol 1e-4 plus one float64
    refinement, against the float64 fh: y and h within 1e-7 relative."""
    _, model, kl = cooks
    cfg = ProblemConfig(**CFG)
    fh64 = rf.make_fh_fun_field(model, kl, cfg, probe_nodes=PROBES, grid=(10, 5))
    fh32 = rf.make_fh_fun_field(model, kl, cfg, probe_nodes=PROBES, grid=(10, 5),
                                cg_dtype=torch.float32, refine_iters=1, tol=1e-4)
    theta = torch.as_tensor(np.random.default_rng(6).standard_normal((16, N_MODES)))
    with torch.no_grad():
        (y64, h64), (y32, h32) = fh64(theta), fh32(theta)
    assert _rel(y32, y64) <= 1e-7 and _rel(h32, h64) <= 1e-7
    assert [it.dtype for it in fh32.solver.last_cg_iters] == [torch.int64] * 2


@pytest.mark.parametrize("override,exc", [(dict(probe_nodes=(0, 5)), ValueError),
                                          (dict(probe_nodes=(5, 67)), ValueError),
                                          (dict(ele_id=0), ValueError),
                                          (dict(ele_id=51), ValueError),
                                          (dict(nipt_id=(1, 5)), ValueError)])
def test_fh_rejects_what_jax_rejects(cooks, override, exc):
    _, model, kl = cooks
    override = dict(override)
    probes = override.pop("probe_nodes", PROBES)
    cfg = ProblemConfig(**{**CFG, **override})
    with pytest.raises(exc):
        rf.make_fh_fun_field(model, kl, cfg, probe_nodes=probes)


def test_fh_rejects_plane_stress(cooks):
    _, model, kl = cooks
    with pytest.raises(NotImplementedError):
        rf.make_fh_fun_field(dataclasses.replace(model, stype=1), kl, ProblemConfig(**CFG),
                             probe_nodes=PROBES)


def test_field_from_theta_matches_jax(cooks):
    _, model, kl = cooks
    theta = np.random.default_rng(9).standard_normal((4, N_MODES))
    got = rf.field_from_theta(kl, torch.as_tensor(theta))
    jkl = _jax_kl(kl)
    for b in range(4):
        assert _rel(got[b], jrf.field_from_theta(jkl, jnp.asarray(theta[b]))) <= 1e-14
    assert _rel(rf.field_from_theta(kl, torch.as_tensor(theta[0])), got[0]) == 0.0


@pytest.mark.parametrize("form", ["meanfield", "fullcov"])
def test_posterior_field_moments_match_jax(cooks, form):
    _, _, kl = cooks
    rng = np.random.default_rng(1)
    tm = rng.standard_normal(N_MODES)
    if form == "meanfield":
        kw = dict(theta_var=rng.uniform(0.1, 0.5, N_MODES))
    else:
        A = rng.standard_normal((N_MODES, N_MODES)) * 0.3
        kw = dict(L=np.linalg.cholesky(A @ A.T + 0.05 * np.eye(N_MODES)))
    got = rf.posterior_field_moments(kl, torch.as_tensor(tm),
                                     **{k: torch.as_tensor(v) for k, v in kw.items()})
    want = jrf.posterior_field_moments(_jax_kl(kl), tm, **kw)
    for a, b in zip(got, want):
        assert _rel(a, b) <= 1e-12
    with pytest.raises(ValueError):
        rf.posterior_field_moments(kl, tm)


@pytest.fixture(scope="module")
def field_logposts():
    """tests/test_laplace.py:35's field problem in both packages: 10x5, 4
    modes, 8 probes, a noise-free observation at theta_true."""
    model = build_fem_model(cooks_membrane_mesh(10, 5), device="cpu")
    jmodel = jax_build_fem_model(jax_cooks_mesh(10, 5), dense=True)
    kl = rf.build_kl_expansion(model, n_modes=4, corr_len=15.0, sigma=0.3)
    cfg = dict(theta_dim=4, y_dim=16, ele_id=5, sig_e=1e-3)
    probes = tuple(range(8, 55, 6))
    fh = rf.make_fh_fun_field(model, kl, ProblemConfig(**cfg), probe_nodes=probes, tol=1e-12)
    jfh = jrf.make_fh_fun_field(jmodel, _jax_kl(kl), JaxProblemConfig(**cfg), probe_nodes=probes,
                                tol=1e-12)
    theta_true = np.array([0.7, -0.4, 0.2, 0.9])
    y_obs = np.asarray(jfh(jnp.asarray(theta_true))[0])
    return (make_fem_logpost(fh, y_obs, 1e-3),
            jax.jit(jax_make_fem_logpost(jfh, jnp.asarray(y_obs), 1e-3)), theta_true)


def test_field_logpost_hessian_matches_jax(field_logposts):
    """The Hessian through the field solve's double backward at two thetas
    against jax.hessian: rtol 1e-6."""
    lp, jlp, theta_true = field_logposts
    jhess = jax.jit(jax.hessian(jlp))
    for t in (theta_true + 0.1, np.array([0.2, 0.1, -0.3, 0.5])):
        H = torch.autograd.functional.hessian(lambda x: lp(x[None])[0], torch.as_tensor(t))
        np.testing.assert_allclose(H.numpy(), np.asarray(jhess(jnp.asarray(t))), rtol=1e-6,
                                   atol=1e-6 * float(np.abs(H.numpy()).max()))


def test_laplace_through_field_solver_matches_jax(field_logposts):
    """tests/test_laplace.py:35 in both packages: the mode within 1e-5 and
    the covariance within rtol 1e-4 of JAX's, and JAX's own gates."""
    lp, jlp, theta_true = field_logposts
    res = laplace_posterior(lp, torch.zeros(4, dtype=torch.float64), tol=1e-7)
    jres = jax_laplace_posterior(jlp, jnp.zeros(4), tol=1e-7)
    np.testing.assert_allclose(res.theta_map, jres.theta_map, rtol=0, atol=1e-5)
    np.testing.assert_allclose(res.cov, jres.cov, rtol=1e-4)
    assert res.grad_norm < 1e-6
    np.testing.assert_allclose(res.theta_map, theta_true, atol=0.05)
    stds = np.sqrt(np.diag(res.cov))
    assert np.all(stds < 1.0) and np.all(stds > 0)
