"""The port's batched PCG, two-level solver, observation operator and one
step-1 update through it against the JAX package (CPU), and the port's plain
path at the full 160x80 width against the JAX golden fixture."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from vbicm_tpu.config import ProblemConfig as JaxProblemConfig
from vbicm_tpu.mesh import cooks_membrane_mesh as jax_cooks_mesh
from vbicm_tpu.model import build_fem_model as jax_build_fem_model
from vbicm_tpu.models.mlp import init_vi_networks as jax_init_vi_networks
from vbicm_tpu.ops.assembly import element_matvec as jax_element_matvec
from vbicm_tpu.ops.multigrid import cooks_prolongation as jax_cooks_prolongation
from vbicm_tpu.ops.multigrid import make_grid_transfer_conv as jax_make_grid_transfer_conv
from vbicm_tpu.ops.multigrid import (
    make_two_level_preconditioner as jax_make_two_level_preconditioner,
)
from vbicm_tpu.ops.solve import make_matfree_affine_solver as jax_make_matfree_affine_solver
from vbicm_tpu.ops.solve import pcg as jax_pcg
from vbicm_tpu.solver import make_coarse_spectral_apply as jax_make_coarse_spectral_apply
from vbicm_tpu.solver import make_fh_fun as jax_make_fh_fun
from vbicm_tpu.solver import make_two_level_solver as jax_make_two_level_solver
from vbicm_tpu.vi.elbo import make_loss_step1 as jax_make_loss_step1
from vbicm_tpu_torch.config import ProblemConfig, TrainConfig
from vbicm_tpu_torch.mesh import cooks_membrane_mesh
from vbicm_tpu_torch.model import build_fem_model
from vbicm_tpu_torch.models.mlp import ThetaPosteriorNet, load_flax_params
from vbicm_tpu_torch.ops.assembly import element_affine_matvec
from vbicm_tpu_torch.ops.multigrid import make_grid_transfer_nd, make_two_level_preconditioner
from vbicm_tpu_torch.ops.solve import make_matfree_affine_solver, pcg
from vbicm_tpu_torch.solver import make_coarse_spectral_apply, make_fh_fun, make_two_level_solver
from vbicm_tpu_torch.vi.train import TwoStepTrainer

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                      "scaled_160x80_golden.json")
NX, NY, R = 16, 8, 4


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS/OpenMP thread while this file runs: its arrays are small,
    and the test workers running in parallel share the cores."""
    with threadpool_limits(1):
        yield


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max())


@pytest.fixture(scope="module")
def models():
    """16x8 fine (matrix-free) and 4x2 coarse (dense) models, both packages."""
    return (jax_build_fem_model(jax_cooks_mesh(NX, NY), dense=False),
            jax_build_fem_model(jax_cooks_mesh(NX // R, NY // R), dense=True),
            build_fem_model(cooks_membrane_mesh(NX, NY), device="cpu", dense=False),
            build_fem_model(cooks_membrane_mesh(NX // R, NY // R), device="cpu", dense=True))


def _coeffs(n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(8.0, 16.0, n), rng.uniform(6.0, 9.0, n)], axis=1)


@pytest.mark.parametrize("maxiter", [300, 12])
def test_pcg_matches_vmapped_jax_pcg(models, maxiter):
    """PCG in float64 on Cook's 16x8 with each package's two-level
    preconditioner and the element operator. At tol 1e-8 every lane's
    residual crosses its threshold clear of rounding, so both packages stop
    each lane at the same iteration."""
    jfine, jcoarse, fine, coarse = models
    n = fine.ndof
    rng = np.random.default_rng(7)
    coeffs = np.stack([rng.uniform(8.0, 16.0, 4), rng.uniform(6.0, 9.0, 4)], axis=1)
    mask = fine.free_mask.numpy()
    # right-hand sides of very different norms: each lane normalizes its own
    b = rng.normal(size=(4, n)) * np.array([1.0, 1e-10, 1e5, 3.0])[:, None] * mask
    ke = np.stack([np.asarray(jfine.ke_lam), np.asarray(jfine.ke_mu)])
    dg = np.zeros((2, n))
    for p in range(2):
        np.add.at(dg[p], np.asarray(jfine.lm).reshape(-1),
                  np.diagonal(ke[p], axis1=1, axis2=2).reshape(-1))
    dinv = np.where(mask > 0, 1.0 / (coeffs @ dg), 1.0)
    jprec, _, _ = jax_make_two_level_preconditioner(
        *jax_cooks_prolongation(NX // R, NY // R, R), jax_make_coarse_spectral_apply(jcoarse),
        jfine.free_mask, omega=0.6, grid_transfer=jax_make_grid_transfer_conv(NX // R, NY // R, R))

    def jax_solve(c, bb, minv):
        def mv(x):
            y = sum(c[p] * jax_element_matvec(jnp.asarray(ke[p]), jfine.lm, x * mask, n)
                    for p in range(2))
            return y * mask + x * (1.0 - mask)
        return jax_pcg(mv, bb, lambda r: jprec(c, minv, r), tol=1e-8, maxiter=maxiter)

    xj, itj, rrj = jax.jit(jax.vmap(jax_solve))(jnp.asarray(coeffs), jnp.asarray(b),
                                                 jnp.asarray(dinv))
    ke_t, mask_t = torch.as_tensor(ke), fine.free_mask
    c_t, minv_t = torch.as_tensor(coeffs), torch.as_tensor(dinv)
    prec = make_two_level_preconditioner(make_coarse_spectral_apply(coarse), fine.free_mask,
                                         make_grid_transfer_nd((NY // R, NX // R), R, 2), omega=0.6)

    def mv(x):
        return element_affine_matvec(ke_t, fine.lm, c_t, x * mask_t, n) * mask_t + x * (1 - mask_t)

    x, it, rr = pcg(mv, torch.as_tensor(b), lambda r: prec(c_t, minv_t, r), tol=1e-8,
                    maxiter=maxiter)
    assert it.tolist() == np.asarray(itj).tolist()
    if maxiter == 12:
        assert it.tolist() == [12] * 4
    # iterates: 1e-10 relative per lane, float64 on both sides
    for lane in range(4):
        assert _rel(x[lane].numpy(), np.asarray(xj)[lane]) < 1e-10
    # squared residual norms at the last iteration, ~1e-8 of ||b|| there:
    # rounding-level quantities, within 10 % of each other
    np.testing.assert_allclose(rr.numpy(), np.asarray(rrj), rtol=0.1)


def test_matfree_element_solver_matches_jax():
    """The matrix-free solver on its element operator with Jacobi, float64,
    forward and adjoint, against the JAX package's."""
    jmodel = jax_build_fem_model(jax_cooks_mesh(8, 4), dense=False)
    model = build_fem_model(cooks_membrane_mesh(8, 4), device="cpu", dense=False)
    coeffs = _coeffs(3, 13)
    rng = np.random.default_rng(14)
    f = rng.normal(size=(3, model.ndof)) * model.free_mask.numpy()
    ubar = rng.normal(size=(3, model.ndof))
    jsolve = jax_make_matfree_affine_solver(
        jnp.stack([jmodel.ke_lam, jmodel.ke_mu]), jmodel.lm, jmodel.free_mask, jmodel.ndof,
        tol=1e-12, maxiter=2000)
    uj, vjp = jax.vjp(jax.vmap(jsolve), jnp.asarray(coeffs), jnp.asarray(f))
    cbar_j, fbar_j = vjp(jnp.asarray(ubar))
    solve = make_matfree_affine_solver(torch.stack([model.ke_lam, model.ke_mu]), model.lm,
                                       model.free_mask, model.ndof, tol=1e-12, maxiter=2000)
    c, ft = torch.tensor(coeffs, requires_grad=True), torch.tensor(f, requires_grad=True)
    u = solve(c, ft)
    cbar, fbar = torch.autograd.grad(u, (c, ft), torch.as_tensor(ubar))
    # float64 Jacobi CG at tol 1e-12 in both packages: 1e-9 relative
    assert _rel(u.detach().numpy(), uj) < 1e-9
    assert _rel(fbar.numpy(), fbar_j) < 1e-9 and _rel(cbar.numpy(), cbar_j) < 1e-9


@pytest.mark.parametrize("residual,val_tol,grad_tol", [("f64", 1e-9, 1e-6),
                                                        ("split_f32", 5e-5, 1e-4)])
def test_two_level_solver_matches_jax(models, residual, val_tol, grad_tol):
    jfine, jcoarse, fine, coarse = models
    coeffs = _coeffs(5, 7)
    wvec = np.random.default_rng(8).normal(size=(5, fine.ndof))
    # float32 CG at tol 1e-4 plus one refinement: tight enough that the two
    # packages' float32 roundings, taken in different orders, stay below the
    # tolerances
    kw = dict(refine_iters=1, tol=1e-4, maxiter=400, use_stencil=True, refine_residual=residual)
    js = jax_make_two_level_solver(jfine, jcoarse, NX // R, NY // R, R, cg_dtype=jnp.float32, **kw)
    ts = make_two_level_solver(fine, coarse, NX // R, NY // R, R, cg_dtype=torch.float32, **kw)

    uj = np.asarray(jax.jit(jax.vmap(js))(jnp.asarray(coeffs[:, 0]), jnp.asarray(coeffs[:, 1])))

    def grad_j(c, w):  # d<u(c), w>/d(c0, c1) for one sample
        return jnp.stack(jax.grad(lambda a, b: jnp.vdot(js(a, b), w), (0, 1))(c[0], c[1]))

    gj = np.asarray(jax.jit(jax.vmap(grad_j))(jnp.asarray(coeffs), jnp.asarray(wvec)))

    c = torch.tensor(coeffs, requires_grad=True)
    u = ts(c[:, 0], c[:, 1])
    (g,) = torch.autograd.grad((u * torch.as_tensor(wvec)).sum(), c)
    assert np.abs(u.detach().numpy() - uj).max() <= val_tol * np.abs(uj).max()
    assert _rel(g.numpy(), gj) < grad_tol


def _scaled_cfg(model, nx, ny, cls):
    """The scaled configuration's probes: the last node, and element
    (ny // 2) * nx + 12."""
    return dataclasses.replace(cls(), node_id=model.nnodes, ele_id=(ny // 2) * nx + 12)


def test_fh_with_two_level_solver_matches_jax(models):
    jfine, jcoarse, fine, coarse = models
    thetas = np.random.default_rng(9).normal(size=(6, 2))
    kw = dict(tol=1e-12, maxiter=400, use_stencil=True)
    js = jax_make_two_level_solver(jfine, jcoarse, NX // R, NY // R, R, **kw)
    ts = make_two_level_solver(fine, coarse, NX // R, NY // R, R, **kw)
    yj, hj = jax.jit(jax.vmap(jax_make_fh_fun(jfine, _scaled_cfg(jfine, NX, NY, JaxProblemConfig),
                                      solve_free=js)))(jnp.asarray(thetas))
    fh = make_fh_fun(fine, _scaled_cfg(fine, NX, NY, ProblemConfig), solve_free=ts)
    with torch.no_grad():
        y, h = fh(torch.as_tensor(thetas))
    # float64 CG at tol 1e-12 in both packages: 1e-10 relative
    assert _rel(y.numpy(), yj) < 1e-10 and _rel(h.numpy(), hj) < 1e-10


def _grad_tree(net):
    """The theta net's gradients in flax's layout."""
    return {name: {f"Dense_{i}": {"kernel": layer.weight.grad.numpy().T,
                                  "bias": layer.bias.grad.numpy()}
                   for i, layer in enumerate(sub.layers)}
            for name, sub in net.named_children()}


def test_update_step1_through_two_level_fh_matches_jax(models):
    jfine, jcoarse, fine, coarse = models
    theta_net_j, theta_p, _, _ = jax_init_vi_networks(jax.random.PRNGKey(0))
    theta_p = jax.tree_util.tree_map(np.asarray, theta_p)
    rng = np.random.default_rng(10)
    e = rng.normal(size=(4, 2))
    kw = dict(refine_iters=1, tol=1e-4, maxiter=400, use_stencil=True)
    js = jax_make_two_level_solver(jfine, jcoarse, NX // R, NY // R, R, cg_dtype=jnp.float32, **kw)
    ts = make_two_level_solver(fine, coarse, NX // R, NY // R, R, cg_dtype=torch.float32, **kw)
    fh_j = jax.vmap(jax_make_fh_fun(jfine, _scaled_cfg(jfine, NX, NY, JaxProblemConfig),
                                    solve_free=js))
    cfg = _scaled_cfg(fine, NX, NY, ProblemConfig)
    fh = make_fh_fun(fine, cfg, solve_free=ts)
    with torch.no_grad():
        y0, _ = fh(torch.as_tensor(rng.normal(size=(8, 2))))
    yb = y0.numpy() + np.sqrt(cfg.sig_e) * rng.normal(size=(8, 2))

    loss_j = jax_make_loss_step1(lambda th: fh_j(th)[0], jnp.asarray(e), cfg.sig_e, "cross")
    val_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: loss_j(jnp.asarray(yb), theta_net_j.apply(p, jnp.asarray(yb)))))(theta_p)

    trainer = TwoStepTrainer(None, cfg, TrainConfig(), fh_batch=fh, device="cpu")
    net = load_flax_params(ThetaPosteriorNet(), theta_p)
    loss = trainer.update_step1(net, trainer.optimizer_step1(net), torch.as_tensor(yb),
                                torch.as_tensor(e))
    # float32 CG + one float64 refinement on both sides, rounded in
    # different orders: the loss to 1e-8, the gradients to 1e-6 of their
    # largest entry
    assert abs(float(loss) - float(val_j)) <= 1e-8 * abs(float(val_j))
    grads = _grad_tree(net)
    ref = grads_j["params"] if "params" in grads_j else grads_j
    scale = max(np.abs(np.asarray(g)).max() for g in jax.tree_util.tree_leaves(grads_j))
    for name in grads:
        for dense in grads[name]:
            for k in ("kernel", "bias"):
                np.testing.assert_allclose(grads[name][dense][k], np.asarray(ref[name][dense][k]),
                                           rtol=0, atol=1e-6 * scale, err_msg=f"{name}/{dense}/{k}")


@pytest.mark.parametrize("kwargs", [dict(use_stencil=False), dict(cycle="vcycle"),
                                    dict(transfer="matmul"), dict(transfer="dense"),
                                    dict(refine_residual="compensated"),
                                    dict(with_rhs_solver=True)],
                         ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_two_level_solver_rejects_unported_options(models, kwargs):
    _, _, fine, coarse = models
    kwargs = {"use_stencil": True, **kwargs}
    with pytest.raises(NotImplementedError):
        make_two_level_solver(fine, coarse, NX // R, NY // R, R, **kwargs)


@pytest.fixture(scope="module")
def scaled():
    """The golden fixture and the port's 160x80 / 40x20 models on the CPU."""
    with open(GOLDEN) as f:
        gold = json.load(f)
    nx, ny, r = (gold["mesh"][k] for k in ("nx", "ny", "ratio"))
    return (gold, build_fem_model(cooks_membrane_mesh(nx, ny), device="cpu", dense=False),
            build_fem_model(cooks_membrane_mesh(nx // r, ny // r), device="cpu", dense=True))


@pytest.mark.parametrize("residual,tol", [("f64", 1e-6), ("split_f32", 1e-3)])
def test_plain_path_160x80_matches_jax_golden(scaled, residual, tol):
    gold, model, coarse = scaled
    nx, ny, r = (gold["mesh"][k] for k in ("nx", "ny", "ratio"))
    assert model.ndof == gold["mesh"]["ndof"]
    probe = gold["probe"]
    cfg = dataclasses.replace(ProblemConfig(), node_id=probe["node_id"], ele_id=probe["ele_id"],
                              nipt_id=tuple(probe["nipt_id"]))
    solve = make_two_level_solver(model, coarse, nx // r, ny // r, r, cg_dtype=torch.float32,
                                  refine_iters=1, tol=3e-3, maxiter=400, use_stencil=True,
                                  refine_residual=residual)
    with torch.no_grad():
        y, h = make_fh_fun(model, cfg, solve_free=solve)(torch.as_tensor(gold["thetas"]))
    # the training setting (float32 CG at tol 3e-3 + one refinement) against
    # the JAX package's float64 CG at tol 1e-12: 1e-6 relative with float64
    # residuals, 1e-3 with split-float32 ones (their float32 floor)
    assert _rel(y.numpy(), gold["y"]) < tol and _rel(h.numpy(), gold["h"]) < tol
