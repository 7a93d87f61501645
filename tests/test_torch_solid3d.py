"""The port's 3-D solid (hex8 meshes, 3-D quadrature, the hex8 / stype 4
model, stress recovery, probes and the observation operator), the frozen
input standardization of the nets and one step-1 update through a 3-D
observation operator, against the JAX package (CPU, float64). Inputs are
made with numpy from fixed seeds and handed to both packages."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from vbicm_tpu.config import MaterialCard as JaxMaterialCard
from vbicm_tpu.config import ProblemConfig as JaxProblemConfig
from vbicm_tpu.config import SectionCard as JaxSectionCard
from vbicm_tpu.mesh.solid3d import beam_hex8_mesh as jax_beam_hex8_mesh
from vbicm_tpu.mesh.solid3d import cube_hex8_mesh as jax_cube_hex8_mesh
from vbicm_tpu.model import build_fem_model as jax_build_fem_model
from vbicm_tpu.models.mlp import ThetaPosteriorNet as JaxThetaPosteriorNet
from vbicm_tpu.models.mlp import ZPredictiveNet as JaxZPredictiveNet
from vbicm_tpu.ops.quadrature import int3d as jax_int3d
from vbicm_tpu.solver import fea_solution as jax_fea_solution
from vbicm_tpu.solver import make_fh_fun as jax_make_fh_fun
from vbicm_tpu.solver import probe_von_mises as jax_probe_von_mises
from vbicm_tpu.solver import recover_fields as jax_recover_fields
from vbicm_tpu.vi.elbo import make_loss_step1 as jax_make_loss_step1
from vbicm_tpu_torch.config import MaterialCard, ProblemConfig, SectionCard, TrainConfig
from vbicm_tpu_torch.mesh import beam_hex8_mesh, cube_hex8_mesh
from vbicm_tpu_torch.model import build_fem_model
from vbicm_tpu_torch.models.mlp import ThetaPosteriorNet, ZPredictiveNet, load_flax_params
from vbicm_tpu_torch.ops.quadrature import int3d
from vbicm_tpu_torch.solver import fea_solution, make_fh_fun, probe_von_mises, recover_fields
from vbicm_tpu_torch.vi.train import TwoStepTrainer

NX, NY, NZ = 4, 2, 2
MESH_FIELDS = ("coords", "conn", "bc_nodes", "bc_flags", "load_nodes", "load_vals",
               "disp_nodes", "disp_vals")


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS/OpenMP thread while this file runs: its matrices are small,
    and the test workers running in parallel share the cores."""
    with threadpool_limits(1):
        yield


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _probe_cfg(cls, nnodes, nx=NX, ny=NY, nz=NZ):
    """The 3-D trainer's probes: the last node's 3 dofs, and the root
    element ((nz-1)*ny + ny//2)*nx + 2 at qpts (1, 5)."""
    return dataclasses.replace(cls(), y_dim=3, node_id=nnodes,
                               ele_id=((nz - 1) * ny + ny // 2) * nx + 2, nipt_id=(1, 5))


@pytest.fixture(scope="module", params=[True, False], ids=["dense", "matrix_free"])
def models(request):
    """The 4x2x2 cantilever, JAX and port, dense or matrix-free."""
    tip = (0.0, 0.0, -0.02)
    return (jax_build_fem_model(jax_beam_hex8_mesh(NX, NY, NZ, tip_force=tip),
                                JaxSectionCard(stype=4), dense=request.param),
            build_fem_model(beam_hex8_mesh(NX, NY, NZ, tip_force=tip), SectionCard(stype=4),
                            device="cpu", dense=request.param))


@pytest.mark.parametrize("cells", [(3, 2, 2), (4, 2, 2)], ids=lambda c: "x".join(map(str, c)))
def test_meshes_equal_jax(cells):
    n = cells[0]
    for ours, theirs in ((beam_hex8_mesh(*cells), jax_beam_hex8_mesh(*cells)),
                         (beam_hex8_mesh(*cells, lx=4.0, tip_force=(0.1, 0.2, -0.3)),
                          jax_beam_hex8_mesh(*cells, lx=4.0, tip_force=(0.1, 0.2, -0.3))),
                         (cube_hex8_mesh(n, 2.0), jax_cube_hex8_mesh(n, 2.0))):
        for name in MESH_FIELDS:
            a, b = getattr(ours, name), getattr(theirs, name)
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        assert (ours.space_dim, ours.max_node_dof, ours.max_ele_node) == (3, 3, 8)


@pytest.mark.parametrize("order", [1, 2, 3, 4, 5, -4, -9])
def test_int3d_equals_jax(order):
    for ours, theirs in zip(int3d(order), jax_int3d(order)):
        assert np.array_equal(ours, theirs)


@pytest.mark.parametrize("name", ["coords", "lm", "free_dof", "supp_dof", "free_mask", "f_ext",
                                  "f_free", "B", "dvol", "ke_lam", "ke_mu", "k_lam_ff",
                                  "k_mu_ff"])
def test_hex8_model_matches_jax(models, name):
    jmodel, model = models
    assert (model.ndm, model.stype, model.nqpt) == (3, 4, 8)
    assert (model.ndof, model.nfree, model.nele) == (jmodel.ndof, jmodel.nfree, jmodel.nele)
    ours, theirs = getattr(model, name), getattr(jmodel, name)
    if theirs is None:  # the matrix-free model's dense parts
        assert ours is None and not model.dense
        return
    ours, theirs = ours.numpy(), np.asarray(theirs)
    assert ours.shape == theirs.shape
    # 1e-13 relative: both build the same float64 NumPy host arrays
    assert np.abs(ours - theirs).max() <= 1e-13 * max(np.abs(theirs).max(), 1.0)


def test_solid_takes_stype_4_only():
    with pytest.raises(ValueError):
        build_fem_model(beam_hex8_mesh(2, 1, 1), SectionCard(stype=2), device="cpu")


@pytest.fixture(scope="module")
def dense_models():
    tip = (0.0, 0.0, -0.02)
    return (jax_build_fem_model(jax_beam_hex8_mesh(NX, NY, NZ, tip_force=tip),
                                JaxSectionCard(stype=4), dense=True),
            build_fem_model(beam_hex8_mesh(NX, NY, NZ, tip_force=tip), SectionCard(stype=4),
                            device="cpu", dense=True))


def test_fea_solution_and_recovery_match_jax(dense_models):
    jmodel, model = dense_models
    sol_j = jax_fea_solution(jmodel, JaxMaterialCard(E=21.0, v=0.28))
    sol = fea_solution(model, MaterialCard(E=21.0, v=0.28))
    # float64 spectral solves of the same pencil on both sides: 1e-10
    for name in ("u", "strain", "stress", "reactions"):
        assert _rel(getattr(sol, name).numpy(), getattr(sol_j, name)) < 1e-10, name
    mat = MaterialCard(E=18.0, v=0.31)
    lam, mu = (torch.tensor(x, dtype=torch.float64) for x in (mat.lam, mat.mu))
    eps, sig = recover_fields(model, sol.u, lam, mu)
    eps_j, sig_j = jax_recover_fields(jmodel, jnp.asarray(sol.u.numpy()), mat.lam, mat.mu)
    assert eps.shape == (model.nele, 8, 6)
    # the same float64 contraction of the same displacements: 1e-13
    assert _rel(eps.numpy(), eps_j) < 1e-13 and _rel(sig.numpy(), sig_j) < 1e-13
    vm = probe_von_mises(model, sol.u, lam, mu, 14, (1, 5, 8))
    vm_j = jax_probe_von_mises(jmodel, jnp.asarray(sol.u.numpy()), mat.lam, mat.mu, 14, (1, 5, 8))
    assert vm.shape == (3,) and _rel(vm.numpy(), vm_j) < 1e-13


def test_fh_3d_matches_jax(dense_models):
    jmodel, model = dense_models
    thetas = np.random.default_rng(21).normal(size=(16, 2))
    y_j, h_j = jax.jit(jax.vmap(jax_make_fh_fun(jmodel, _probe_cfg(JaxProblemConfig,
                                                                   jmodel.nnodes))))(
        jnp.asarray(thetas))
    with torch.no_grad():
        y, h = make_fh_fun(model, _probe_cfg(ProblemConfig, model.nnodes))(
            torch.as_tensor(thetas))
    assert y.shape == (16, 3) and h.shape == (16, 2)
    # float64 spectral solves on both sides: 1e-10
    assert _rel(y.numpy(), y_j) < 1e-10 and _rel(h.numpy(), h_j) < 1e-10


def _norm():
    rng = np.random.default_rng(22)
    return rng.normal(size=(1, 3)), rng.uniform(0.5, 2.0, size=(1, 3))


@pytest.mark.parametrize("cls,jcls", [(ThetaPosteriorNet, JaxThetaPosteriorNet),
                                      (ZPredictiveNet, JaxZPredictiveNet)],
                         ids=["theta", "z"])
def test_normalized_nets_match_flax(cls, jcls):
    mean, std = _norm()
    shift = tuple(float(v) for v in mean.ravel())
    scale = tuple(float(v) for v in std.ravel())
    flax_net = jcls(y_shift=shift, y_scale=scale)
    params = jax.tree_util.tree_map(np.asarray, flax_net.init(jax.random.PRNGKey(4),
                                                              jnp.zeros((1, 3))))
    net = load_flax_params(cls(y_dim=3, y_shift=shift, y_scale=scale), params)
    assert not any("y_s" in n for n, _ in net.named_parameters())  # constants, not parameters
    y = np.random.default_rng(23).normal(size=(10, 3)) * 3.0
    with torch.no_grad():
        ours = net(torch.as_tensor(y))
    for a, b in zip(ours, flax_net.apply(params, jnp.asarray(y))):
        # 1e-13: the same float64 affine maps, summation order aside
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-13, atol=1e-13)
    plain = load_flax_params(cls(y_dim=3), params)
    with torch.no_grad():
        assert not torch.allclose(plain(torch.as_tensor(y))[0], ours[0])


def test_update_step1_with_y_norm_through_3d_fh_matches_jax(dense_models):
    jmodel, model = dense_models
    mean, std = _norm()
    shift = tuple(float(v) for v in mean.ravel())
    scale = tuple(float(v) for v in std.ravel())
    flax_net = JaxThetaPosteriorNet(y_shift=shift, y_scale=scale)
    theta_p = jax.tree_util.tree_map(np.asarray, flax_net.init(jax.random.PRNGKey(5),
                                                               jnp.zeros((1, 3))))
    rng = np.random.default_rng(24)
    e = rng.normal(size=(4, 2))
    cfg_j = _probe_cfg(JaxProblemConfig, jmodel.nnodes)
    cfg = _probe_cfg(ProblemConfig, model.nnodes)
    fh = make_fh_fun(model, cfg)
    with torch.no_grad():
        y0, _ = fh(torch.as_tensor(rng.normal(size=(8, 2))))
    yb = y0.numpy() + np.sqrt(cfg.sig_e) * rng.normal(size=(8, 3))

    fh_j = jax.vmap(jax_make_fh_fun(jmodel, cfg_j))
    loss_j = jax_make_loss_step1(lambda th: fh_j(th)[0], jnp.asarray(e), cfg.sig_e, "per_sample")
    val_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: loss_j(jnp.asarray(yb), flax_net.apply(p, jnp.asarray(yb)))))(theta_p)

    trainer = TwoStepTrainer(None, cfg, TrainConfig(pairing="per_sample"), fh_batch=fh,
                             device="cpu", y_norm=(mean, std))
    net = load_flax_params(trainer.new_theta_net(torch.Generator().manual_seed(0)), theta_p)
    loss = trainer.update_step1(net, trainer.optimizer_step1(net), torch.as_tensor(yb),
                                torch.as_tensor(e))
    # float64 on both sides, through 32 3-D solves and their adjoints: 1e-10
    assert abs(float(loss) - float(val_j)) <= 1e-10 * abs(float(val_j))
    ref = grads_j["params"] if "params" in grads_j else grads_j
    scale_g = max(np.abs(np.asarray(g)).max() for g in jax.tree_util.tree_leaves(grads_j))
    for name, sub in net.named_children():
        for i, layer in enumerate(sub.layers):
            for k, g in (("kernel", layer.weight.grad.numpy().T), ("bias", layer.bias.grad.numpy())):
                np.testing.assert_allclose(g, np.asarray(ref[name][f"Dense_{i}"][k]), rtol=0,
                                           atol=1e-10 * scale_g, err_msg=f"{name}/Dense_{i}/{k}")
