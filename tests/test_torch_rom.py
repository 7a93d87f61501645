"""The port's certified reduced basis against the JAX package (CPU): the
greedy offline build on the host, the batched online reduced solve, its
residual certificate, and the ROM observation operator with its
gradient."""
import dataclasses
import importlib.util
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
from vbicm_tpu.rom import build_reduced_basis as jax_build_reduced_basis
from vbicm_tpu.rom import make_fh_fun_rom as jax_make_fh_fun_rom
from vbicm_tpu.rom.reduced_basis import reduced_solve as jax_reduced_solve
from vbicm_tpu.rom.reduced_basis import residual_norm as jax_residual_norm
from vbicm_tpu.vi.elbo import make_loss_step1 as jax_make_loss_step1
from vbicm_tpu_torch.config import ProblemConfig, TrainConfig
from vbicm_tpu_torch.mesh import cooks_membrane_mesh
from vbicm_tpu_torch.model import build_fem_model
from vbicm_tpu_torch.models.mlp import ThetaPosteriorNet, load_flax_params
from vbicm_tpu_torch.rom import build_reduced_basis, make_fh_fun_rom, reduced_solve, residual_norm
from vbicm_tpu_torch.solver import make_fh_fun
from vbicm_tpu_torch.vi.train import TwoStepTrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS/OpenMP thread while this file runs: its arrays are small,
    and the test workers running in parallel share the cores."""
    with threadpool_limits(1):
        yield


@pytest.fixture(scope="module", params=[(20, 10), (40, 20)], ids=["20x10", "40x20"])
def bases(request):
    """(nx, ny, port model, JAX model, port basis, JAX basis), matrix-free
    models, the JAX example's tol 1e-10."""
    nx, ny = request.param
    model = build_fem_model(cooks_membrane_mesh(nx, ny), device="cpu", dense=False)
    jmodel = jax_build_fem_model(jax_cooks_mesh(nx, ny), dense=False)
    return (nx, ny, model, jmodel, build_reduced_basis(model, tol=1e-10),
            jax_build_reduced_basis(jmodel, tol=1e-10))


def _scaled_cfg(model, nx, ny, cls):
    """The scaled configuration's probes: the last node, and element
    (ny // 2) * nx + 12."""
    return dataclasses.replace(cls(), node_id=model.nnodes, ele_id=(ny // 2) * nx + 12)


def test_reduced_basis_matches_jax(bases):
    _, _, _, _, rb, jrb = bases
    # the same greedy choices and basis size
    assert rb.t_snapshots == jrb.t_snapshots and rb.r == jrb.r
    # the same host float64 arithmetic (SciPy sparse LU, eigh): the reduced
    # pencil's eigenvalues to 1e-10 relative
    np.testing.assert_allclose(rb.g, jrb.g, rtol=1e-10)
    assert rb.max_rel_residual < 1e-10 and jrb.max_rel_residual < 1e-10
    np.testing.assert_allclose(rb.max_rel_residual, jrb.max_rel_residual, rtol=1e-3)
    # the basis spans the same space: projector difference to 1e-10
    np.testing.assert_allclose(rb.Q @ (rb.Q.T @ jrb.Q), jrb.Q, atol=1e-10)


def test_reduced_solve_and_certificate_match_jax(bases):
    _, _, _, _, rb, jrb = bases
    rng = np.random.default_rng(0)
    lam, mu = rng.uniform(8.0, 16.0, 4), rng.uniform(6.0, 9.0, 4)
    u_r = reduced_solve(rb, torch.as_tensor(lam), torch.as_tensor(mu))
    res = residual_norm(rb, torch.as_tensor(lam), torch.as_tensor(mu), u_r)
    uj = jax.vmap(lambda a, b: jax_reduced_solve(jrb, a, b))(jnp.asarray(lam), jnp.asarray(mu))
    resj = jax.vmap(lambda a, b, u: jax_residual_norm(jrb, a, b, u))(
        jnp.asarray(lam), jnp.asarray(mu), uj)
    # the displacements Q u_r in float64: 1e-10 relative (the bases agree to
    # 1e-10 as spans, not vector by vector)
    full, fullj = rb.Q @ u_r.numpy().T, jrb.Q @ np.asarray(uj).T
    assert np.abs(full - fullj).max() <= 1e-10 * np.abs(fullj).max()
    # the Gram certificate floors near 1e-8 (its cancellation): both there
    assert res.numpy().max() < 1e-6 and np.asarray(resj).max() < 1e-6


def test_rom_fh_and_gradient_match_jax(bases):
    nx, ny, model, jmodel, rb, jrb = bases
    thetas = np.random.default_rng(1).normal(size=(6, 2))
    fh = make_fh_fun_rom(model, rb, _scaled_cfg(model, nx, ny, ProblemConfig))
    jfh = jax_make_fh_fun_rom(jmodel, jrb, _scaled_cfg(jmodel, nx, ny, JaxProblemConfig))
    th = torch.tensor(thetas, requires_grad=True)
    y, h = fh(th)
    (g,) = torch.autograd.grad(y.sum() + h.sum(), th)
    yj, hj = jax.vmap(jfh)(jnp.asarray(thetas))
    gj = jax.vmap(jax.grad(lambda t: jnp.sum(jfh(t)[0]) + jnp.sum(jfh(t)[1])))(
        jnp.asarray(thetas))
    # float64 reduced solves on bases equal to 1e-10: 1e-9 relative
    for got, want in ((y, yj), (h, hj), (g, gj)):
        got = got.detach().numpy()
        assert np.abs(got - np.asarray(want)).max() <= 1e-9 * np.abs(np.asarray(want)).max()


def test_rom_fh_matches_full_order_dense(bases):
    """At 20x10 and 40x20 (dense spectral solves) the ROM is the full-order
    observation operator to its certified 1e-10 residual."""
    nx, ny, model, _, rb, _ = bases
    dense = build_fem_model(cooks_membrane_mesh(nx, ny), device="cpu", dense=True)
    cfg = _scaled_cfg(model, nx, ny, ProblemConfig)
    thetas = torch.as_tensor(np.random.default_rng(2).normal(size=(5, 2)) * 2.0)
    y, h = make_fh_fun_rom(model, rb, cfg)(thetas)
    yd, hd = make_fh_fun(dense, cfg)(thetas)
    for got, want in ((y, yd), (h, hd)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-8, atol=1e-10)


def test_update_step1_through_rom_fh_matches_jax():
    """One step-1 update (loss and gradients) through the ROM observation
    operator at 20x10, the scaled trainer's probes, against the JAX
    package's loss and gradients on the same weights and noise."""
    nx, ny = 20, 10
    model = build_fem_model(cooks_membrane_mesh(nx, ny), device="cpu", dense=False)
    jmodel = jax_build_fem_model(jax_cooks_mesh(nx, ny), dense=False)
    cfg = _scaled_cfg(model, nx, ny, ProblemConfig)
    fh = make_fh_fun_rom(model, build_reduced_basis(model), cfg)
    jfh = jax.vmap(jax_make_fh_fun_rom(jmodel, jax_build_reduced_basis(jmodel),
                                       _scaled_cfg(jmodel, nx, ny, JaxProblemConfig)))
    theta_net_j, theta_p, _, _ = jax_init_vi_networks(jax.random.PRNGKey(0))
    theta_p = jax.tree_util.tree_map(np.asarray, theta_p)
    rng = np.random.default_rng(10)
    e = rng.normal(size=(4, 2))
    with torch.no_grad():
        y0, _ = fh(torch.as_tensor(rng.normal(size=(8, 2))))
    yb = y0.numpy() + np.sqrt(cfg.sig_e) * rng.normal(size=(8, 2))
    loss_j = jax_make_loss_step1(lambda th: jfh(th)[0], jnp.asarray(e), cfg.sig_e, "cross")
    val_j, grads_j = jax.value_and_grad(
        lambda p: loss_j(jnp.asarray(yb), theta_net_j.apply(p, jnp.asarray(yb))))(theta_p)

    trainer = TwoStepTrainer(None, cfg, TrainConfig(), fh_batch=fh, device="cpu")
    net = load_flax_params(ThetaPosteriorNet(), theta_p)
    loss = trainer.update_step1(net, trainer.optimizer_step1(net), torch.as_tensor(yb),
                                torch.as_tensor(e))
    # float64 reduced solves on both sides: the loss and the gradients to
    # 1e-10 relative
    assert abs(float(loss) - float(val_j)) <= 1e-10 * abs(float(val_j))
    ref = grads_j["params"] if "params" in grads_j else grads_j
    for name, sub in net.named_children():
        for i, layer in enumerate(sub.layers):
            for k, got in (("kernel", layer.weight.grad.numpy().T),
                           ("bias", layer.bias.grad.numpy())):
                want = np.asarray(ref[name][f"Dense_{i}"][k])
                assert np.abs(got - want).max() <= 1e-10 * max(np.abs(want).max(), 1e-300), \
                    f"{name}/Dense_{i}/{k}"


def test_rom_example_path_at_40x20():
    """The scaled ROM example's path on Cook's 40x20 (coarse 10x5, ratio 4)
    at a cut depth (64 observations, 1 + 1 epochs): finite step-1 losses,
    and the ROM within the example's 1e-5 of the element-path two-level
    solve at 16 posterior means (its own check; chip_smoke.py runs it at
    160x80 on the card)."""
    spec = importlib.util.spec_from_file_location(
        "train_scaled_rom_torch", os.path.join(ROOT, "examples", "train_scaled_rom_torch.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    model, cfg = example.build(40, 20, "cpu")
    rb = build_reduced_basis(model, tol=1e-10)
    assert rb.max_rel_residual < 1e-10
    summary = example.train_and_check(model, cfg, rb, 40, 20, n_data=64, epochs1=1, epochs2=1,
                                      seed=0, device="cpu", verbose=False)
    assert np.all(np.isfinite(summary["hist_step1"]))
    assert summary["spot_rel_err"] < example.SPOT_TOL
