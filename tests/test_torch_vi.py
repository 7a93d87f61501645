"""The port's networks, ELBO losses, Adam updates and bridge against the JAX
package, from the same flax weights and the same batches (CPU, float64)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from threadpoolctl import threadpool_limits

from vbicm_tpu.config import ProblemConfig as JaxProblemConfig
from vbicm_tpu.config import TrainConfig as JaxTrainConfig
from vbicm_tpu.models.mlp import init_vi_networks as jax_init_vi_networks
from vbicm_tpu.solver import make_fh_fun as jax_make_fh_fun
from vbicm_tpu.vi.elbo import make_loss_step1 as jax_make_loss_step1
from vbicm_tpu.vi.elbo import make_loss_step2 as jax_make_loss_step2
from vbicm_tpu.vi.train import TwoStepTrainer as JaxTwoStepTrainer
from vbicm_tpu_torch.config import ProblemConfig, TrainConfig
from vbicm_tpu_torch.mesh import cooks_membrane_mesh
from vbicm_tpu_torch.model import build_fem_model
from vbicm_tpu_torch.models.mlp import ThetaPosteriorNet, ZPredictiveNet, load_flax_params
from vbicm_tpu_torch.solver import make_fh_fun
from vbicm_tpu_torch.vi.elbo import make_loss_step1
from vbicm_tpu_torch.vi.train import TwoStepTrainer


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS/OpenMP thread while this file runs: its matrices are small,
    and the test workers running in parallel share the cores."""
    with threadpool_limits(1):
        yield

NB, BS = 3, 8  # three batches of eight observations


@pytest.fixture(scope="module")
def model():
    return build_fem_model(cooks_membrane_mesh(20, 10), device="cpu")


@pytest.fixture(scope="module")
def nets():
    """Flax nets and their initial parameters (as numpy trees)."""
    theta_net, theta_p, z_net, z_p = jax_init_vi_networks(jax.random.PRNGKey(0))
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    return theta_net, as_np(theta_p), z_net, as_np(z_p)


@pytest.fixture(scope="module")
def data(model):
    """Observations through the FEM plus noise, reparameterization seeds and
    bridge moments near their real values."""
    rng = np.random.default_rng(21)
    with torch.no_grad():
        y, h = make_fh_fun(model)(torch.as_tensor(rng.normal(size=(NB * BS, 2))))
    y = y.numpy() + np.sqrt(0.1) * rng.normal(size=(NB * BS, 2))
    e = rng.normal(size=(4, 2))
    logz_mean = np.log(h.numpy()) + 0.01 * rng.normal(size=(NB * BS, 2))
    logz_var = np.exp(rng.uniform(-8.0, -6.0, size=(NB * BS, 2)))
    return y, e, logz_mean, logz_var


def _tree(module, grads=False):
    """The module's weights (or gradients) in flax's layout."""
    out = {}
    for name, net in module.named_children():
        out[name] = {}
        for i, layer in enumerate(net.layers):
            w, b = (layer.weight.grad, layer.bias.grad) if grads else (layer.weight, layer.bias)
            out[name][f"Dense_{i}"] = {"kernel": w.detach().numpy().T, "bias": b.detach().numpy()}
    return out


def _assert_trees_close(ours, ref, rtol, atol):
    ref = ref["params"] if "params" in ref else ref
    for name in ours:
        for dense in ours[name]:
            for k in ("kernel", "bias"):
                np.testing.assert_allclose(ours[name][dense][k], np.asarray(ref[name][dense][k]),
                                           rtol=rtol, atol=atol, err_msg=f"{name}/{dense}/{k}")


def _rel(got, want):
    return abs(float(got) - float(want)) / abs(float(want))


def test_load_flax_params_outputs_match(nets):
    theta_net_j, theta_p, z_net_j, z_p = nets
    y = np.random.default_rng(1).normal(size=(10, 2)) * 3.0
    for net, flax_net, params in ((ThetaPosteriorNet(), theta_net_j, theta_p),
                                  (ZPredictiveNet(), z_net_j, z_p)):
        load_flax_params(net, params)
        with torch.no_grad():
            ours = net(torch.as_tensor(y))
        ref = flax_net.apply(params, jnp.asarray(y))
        for a, b in zip(ours, ref):
            # 1e-13: the same float64 affine maps, summation order aside
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("pairing", ["cross", "per_sample"])
def test_step1_loss_and_grads_match_jax(model, cooks_model, nets, data, pairing):
    theta_net_j, theta_p, _, _ = nets
    y, e, _, _ = data
    yb = y[:BS]
    fh_j = jax.vmap(jax_make_fh_fun(cooks_model))
    loss_j = jax_make_loss_step1(lambda th: fh_j(th)[0], jnp.asarray(e), 0.1, pairing)
    val_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: loss_j(jnp.asarray(yb), theta_net_j.apply(p, jnp.asarray(yb)))))(theta_p)

    net = load_flax_params(ThetaPosteriorNet(), theta_p)
    fh = make_fh_fun(model)
    loss_fn = make_loss_step1(lambda th: fh(th)[0], torch.as_tensor(e), 0.1, pairing)
    y_t = torch.as_tensor(yb)
    loss = loss_fn(y_t, net(y_t))
    loss.backward()
    # 1e-10: float64 on both sides, through 32 FEM solves and their adjoints
    assert _rel(loss.detach(), val_j) < 1e-10
    scale = max(np.abs(np.asarray(g)).max() for g in jax.tree_util.tree_leaves(grads_j))
    _assert_trees_close(_tree(net, grads=True), grads_j, rtol=1e-10, atol=1e-10 * scale)


def test_three_step1_adam_updates_match_optax(model, cooks_model, nets, data):
    theta_net_j, theta_p, _, _ = nets
    y, e, _, _ = data
    fh_j = jax.vmap(jax_make_fh_fun(cooks_model))
    loss_j = jax_make_loss_step1(lambda th: fh_j(th)[0], jnp.asarray(e), 0.1, "cross")
    opt = optax.adam(1e-3, b1=0.99, b2=0.999, eps=1e-10)

    @jax.jit
    def step(p, s, yb):
        loss, g = jax.value_and_grad(lambda q: loss_j(yb, theta_net_j.apply(q, yb)))(p)
        updates, s = opt.update(g, s, p)
        return optax.apply_updates(p, updates), s, loss

    params, state, losses_j = theta_p, opt.init(theta_p), []
    for b in range(NB):
        params, state, loss = step(params, state, jnp.asarray(y[b * BS:(b + 1) * BS]))
        losses_j.append(float(loss))

    trainer = TwoStepTrainer(model, ProblemConfig(), TrainConfig())
    net = load_flax_params(ThetaPosteriorNet(), theta_p)
    topt = trainer.optimizer_step1(net)
    e_t = torch.as_tensor(e)
    losses = [float(trainer.update_step1(net, topt, torch.as_tensor(y[b * BS:(b + 1) * BS]), e_t))
              for b in range(NB)]
    # 1e-9: three float64 steps; Adam divides by sqrt(v) + eps, which
    # magnifies round-off in the smallest gradient entries
    np.testing.assert_allclose(losses, losses_j, rtol=1e-9)
    _assert_trees_close(_tree(net), params, rtol=0, atol=1e-9)


def test_three_step2_adam_updates_match_optax(model, cooks_model, nets, data):
    theta_net_j, theta_p, z_net_j, z_p = nets
    y, e, lm, ls = data
    alpha, sig_eta = TrainConfig().alpha, ProblemConfig().sig_eta
    fh_j = jax.vmap(jax_make_fh_fun(cooks_model))
    loss_j = jax_make_loss_step2(lambda th: fh_j(th)[1], jnp.asarray(e), sig_eta, alpha, "cross")
    opt = optax.adam(1e-3, b1=0.9, b2=0.999, eps=1e-7)

    @jax.jit
    def step(zp, s, yb, lmb, lsb):
        tm, ts, _ = theta_net_j.apply(theta_p, yb)
        loss, g = jax.value_and_grad(
            lambda q: loss_j((yb, lmb, lsb), (tm, ts, *z_net_j.apply(q, yb))))(zp)
        updates, s = opt.update(g, s, zp)
        return optax.apply_updates(zp, updates), s, loss

    params, state, losses_j = z_p, opt.init(z_p), []
    batches = [tuple(a[b * BS:(b + 1) * BS] for a in (y, lm, ls)) for b in range(NB)]
    for yb, lmb, lsb in batches:
        params, state, loss = step(params, state, *(jnp.asarray(a) for a in (yb, lmb, lsb)))
        losses_j.append(float(loss))

    trainer = TwoStepTrainer(model, ProblemConfig(), TrainConfig())
    theta_net = load_flax_params(ThetaPosteriorNet(), theta_p)
    z_net = load_flax_params(ZPredictiveNet(), z_p)
    zopt = trainer.optimizer_step2(z_net)
    e_t = torch.as_tensor(e)
    losses = [float(trainer.update_step2(theta_net, z_net, zopt,
                                         *(torch.as_tensor(a) for a in batch), e_t))
              for batch in batches]
    # 1e-9: as for step 1
    np.testing.assert_allclose(losses, losses_j, rtol=1e-9)
    _assert_trees_close(_tree(z_net), params, rtol=0, atol=1e-9)
    assert all(p.grad is None for p in theta_net.parameters())  # step 1's net stays frozen


def test_bridge_moments_match_jax(model, cooks_model, nets, data):
    theta_net_j, theta_p, _, _ = nets
    y, e, _, _ = data
    # sig_eta = 0 in both, so the bridge's noise draw drops out
    jax_trainer = JaxTwoStepTrainer(cooks_model, JaxProblemConfig(sig_eta=0.0), JaxTrainConfig())
    mean_j, var_j = jax_trainer.bridge(y, e, theta_p, jax.random.PRNGKey(0))
    trainer = TwoStepTrainer(model, ProblemConfig(sig_eta=0.0), TrainConfig())
    mean, var = trainer.bridge(y, e, load_flax_params(ThetaPosteriorNet(), theta_p),
                               torch.Generator().manual_seed(0))
    # 1e-10 relative: float64 solves on both sides
    np.testing.assert_allclose(mean, mean_j, rtol=1e-10)
    np.testing.assert_allclose(var, var_j, rtol=1e-10)
