"""The port's full-covariance and flow posterior families against the JAX
package (CPU, float64): the nets from the same flax weights, the step-1 and
step-2 losses and their gradients on Cook's 8x4, one clipped Adam step
against optax; then the statistical gates of the JAX package's tests, run on
the port alone."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from threadpoolctl import threadpool_limits

from vbicm_tpu.config import ProblemConfig as JaxProblemConfig
from vbicm_tpu.mesh import cooks_membrane_mesh as jax_cooks_membrane_mesh
from vbicm_tpu.model import build_fem_model as jax_build_fem_model
from vbicm_tpu.models.flow import ThetaPosteriorFlowNet as JaxFlowNet
from vbicm_tpu.models.mlp import ThetaPosteriorFullCovNet as JaxFullCovNet
from vbicm_tpu.models.mlp import ZPredictiveNet as JaxZNet
from vbicm_tpu.solver import make_fh_fun as jax_make_fh_fun
from vbicm_tpu.vi.elbo import make_loss_step1_flow as jax_make_loss_step1_flow
from vbicm_tpu.vi.elbo import make_loss_step1_fullcov as jax_make_loss_step1_fullcov
from vbicm_tpu.vi.elbo import make_loss_step2 as jax_make_loss_step2
from vbicm_tpu_torch.config import ProblemConfig, TrainConfig
from vbicm_tpu_torch.mesh import cooks_membrane_mesh
from vbicm_tpu_torch.model import build_fem_model
from vbicm_tpu_torch.models.flow import ThetaPosteriorFlowNet, flow_moments
from vbicm_tpu_torch.models.mlp import (
    ThetaPosteriorFullCovNet,
    ZPredictiveNet,
    load_flax_params,
    marginal_variance,
)
from vbicm_tpu_torch.prob.datagen import generate_data_fem
from vbicm_tpu_torch.solver import make_fh_fun
from vbicm_tpu_torch.vi.elbo import (
    make_loss_step1,
    make_loss_step1_flow,
    make_loss_step1_fullcov,
    make_loss_step2,
)
from vbicm_tpu_torch.vi.train import TwoStepTrainer


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS/OpenMP thread while this file runs: its matrices are small,
    and the test workers running in parallel share the cores."""
    with threadpool_limits(1):
        yield


NODE, ELE = 45, 12  # Cook's 8x4: the tip node and an element near the root
B, NE = 6, 4


def _perturbed(tree, seed, scale=0.3):
    """A flax tree (as numpy) with every entry moved by seeded noise, so
    that the zero-initialized heads are not zero."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda a: np.asarray(a) + scale * rng.normal(size=a.shape), tree)


def _grads(module):
    """The module's gradients in flax's layout, ``couplings.<k>`` as
    ``couplings_<k>``."""
    out = {}
    for name, child in module.named_children():
        subs = ([(f"{name}_{k}", c) for k, c in enumerate(child)]
                if isinstance(child, torch.nn.ModuleList) else [(name, child)])
        for flax_name, mlp in subs:
            out[flax_name] = {f"Dense_{i}": {"kernel": layer.weight.grad.numpy().T,
                                             "bias": layer.bias.grad.numpy()}
                              for i, layer in enumerate(mlp.layers)}
    return out


def _assert_grads_close(module, grads_j, rtol):
    """Every gradient within ``rtol`` of the largest JAX gradient entry."""
    ref = grads_j["params"]
    scale = max(np.abs(np.asarray(g)).max() for g in jax.tree_util.tree_leaves(ref))
    ours = _grads(module)
    assert set(ours) == set(ref)
    for name in ours:
        for dense in ours[name]:
            for k in ("kernel", "bias"):
                np.testing.assert_allclose(ours[name][dense][k], np.asarray(ref[name][dense][k]),
                                           rtol=0, atol=rtol * scale,
                                           err_msg=f"{name}/{dense}/{k}")


@pytest.fixture(scope="module")
def fems():
    """Cook's 8x4 in both packages, and the batched fh of each."""
    cfg_j = JaxProblemConfig(node_id=NODE, ele_id=ELE)
    fh_j = jax.vmap(jax_make_fh_fun(jax_build_fem_model(jax_cooks_membrane_mesh(8, 4)), cfg_j))
    model = build_fem_model(cooks_membrane_mesh(8, 4), device="cpu")
    cfg = ProblemConfig(node_id=NODE, ele_id=ELE)
    return fh_j, make_fh_fun(model, cfg), model, cfg


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(12)
    y = np.stack([rng.normal(-1.0, 0.3, B), rng.normal(1.3, 0.3, B)], axis=1)
    e = rng.normal(size=(NE, 2))
    lm = np.log(np.abs(rng.normal(0.25, 0.02, (B, 2))))
    ls = np.exp(rng.uniform(-8.0, -6.0, (B, 2)))
    return y, e, lm, ls


def _fullcov_params():
    p = JaxFullCovNet().init(jax.random.PRNGKey(0), jnp.zeros((1, 2)))
    return _perturbed(p, 1, scale=0.05)


def _flow_params(n_couplings=4, scale=0.05):
    p = JaxFlowNet(n_couplings=n_couplings).init(jax.random.PRNGKey(0), jnp.zeros((1, 2)),
                                                 jnp.zeros((1, 2)))
    return _perturbed(p, 2, scale=scale)


def test_fullcov_net_matches_jax(inputs):
    y = inputs[0] * 3.0
    params = _fullcov_params()
    ref = JaxFullCovNet().apply(params, jnp.asarray(y))
    net = load_flax_params(ThetaPosteriorFullCovNet(), params)
    with torch.no_grad():
        ours = net(torch.as_tensor(y))
    for a, b in zip(ours, ref):
        # 1e-13: the same float64 affine maps, summation order aside
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-13, atol=1e-13)
    L = ours[1].numpy()
    assert np.all(np.triu(L, 1) == 0.0) and np.all(np.tril(L, -1)[:, 1, 0] != 0.0)
    np.testing.assert_allclose(marginal_variance(ours[1]).numpy(),
                               np.einsum("bij,bij->bi", L, L), rtol=1e-15)


def test_fullcov_net_starts_mean_field():
    """The off-diagonal head starts at zero: L is diagonal at init."""
    net = ThetaPosteriorFullCovNet(theta_dim=3)
    net.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        tm, L, log_diag = net(torch.randn(4, 2, dtype=torch.float64))
    assert L.shape == (4, 3, 3) and torch.equal(L, torch.diag_embed(torch.exp(0.5 * log_diag)))


def test_flow_net_matches_jax(inputs):
    y, e = inputs[0], inputs[1]
    params = _flow_params(scale=0.3)
    theta_j, logq_j = JaxFlowNet().apply(params, jnp.asarray(y), jnp.asarray(e))
    net = load_flax_params(ThetaPosteriorFlowNet(), params)
    with torch.no_grad():
        theta, logq = net(torch.as_tensor(y), torch.as_tensor(e))
    assert theta.shape == (B, NE, 2) and logq.shape == (B, NE)
    # 1e-13 of the largest entry: four couplings of the same float64 maps,
    # whose exp(s) factors carry the summation-order round-off along
    for ours, ref in ((theta, theta_j), (logq, logq_j)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-13 * np.abs(ref).max())


def test_flow_logq_is_the_change_of_variables(inputs):
    """logq of perturbed couplings against log N(e) - log|det d theta/d e|
    from ``torch.func.jacrev``."""
    net = load_flax_params(ThetaPosteriorFlowNet(n_couplings=2), _flow_params(2, scale=0.3))
    y = torch.as_tensor(inputs[0][:1])
    e = torch.as_tensor(inputs[1][:1])
    with torch.no_grad():
        _, logq = net(y, e)
    J = torch.func.jacrev(lambda ev: net(y, ev[None])[0][0, 0])(e[0])
    expected = (-math.log(2 * math.pi) - 0.5 * float((e**2).sum())
                - float(torch.log(torch.abs(torch.linalg.det(J.detach())))))
    assert abs(float(logq[0, 0]) - expected) < 1e-12


def test_flow_init_equals_meanfield_base():
    """Zero-initialized couplings: theta and logq are the mean-field base's,
    bitwise."""
    net = ThetaPosteriorFlowNet()
    net.reset_parameters(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    y = torch.randn((5, 2), generator=g, dtype=torch.float64)
    e = torch.randn((7, 2), generator=g, dtype=torch.float64)
    with torch.no_grad():
        theta, logq = net(y, e)
        mu, log_sig = net.base(y)
    assert torch.equal(theta, mu[:, None, :] + torch.exp(0.5 * log_sig)[:, None, :] * e[None])
    logq_base = (-math.log(2 * math.pi) - 0.5 * torch.sum(e**2, dim=-1)[None, :]
                 - 0.5 * torch.sum(log_sig, dim=-1)[:, None])
    assert torch.equal(logq, logq_base)
    with pytest.raises(ValueError):
        ThetaPosteriorFlowNet(theta_dim=1)


def test_flow_moments_are_the_mc_moments(inputs):
    net = load_flax_params(ThetaPosteriorFlowNet(), _flow_params(scale=0.3))
    y = torch.as_tensor(inputs[0])
    m, v = flow_moments(net, y, torch.Generator().manual_seed(3), n_mc=64)
    e = torch.randn((64, 2), generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    with torch.no_grad():
        theta, _ = net(y, e)
    assert torch.equal(m, theta.mean(1)) and torch.equal(v, theta.var(1, correction=0))


@pytest.mark.parametrize("family", ["fullcov", "flow"])
def test_step1_loss_and_grads_match_jax(fems, inputs, family):
    fh_j, fh, _, cfg = fems
    y, e = inputs[0], inputs[1]
    batch_fj = lambda th: fh_j(th)[0]  # noqa: E731
    if family == "flow":
        params, jnet = _flow_params(), JaxFlowNet()
        loss_j = jax_make_loss_step1_flow(batch_fj, cfg.sig_e)
        obj = lambda p: loss_j(jnp.asarray(y), jnet.apply(p, jnp.asarray(y), jnp.asarray(e)))  # noqa: E731,E501
        net = load_flax_params(ThetaPosteriorFlowNet(), params)
        loss = make_loss_step1_flow(lambda th: fh(th)[0], cfg.sig_e)(
            torch.as_tensor(y), net(torch.as_tensor(y), torch.as_tensor(e)))
    else:
        params, jnet = _fullcov_params(), JaxFullCovNet()
        loss_j = jax_make_loss_step1_fullcov(batch_fj, jnp.asarray(e), cfg.sig_e)
        obj = lambda p: loss_j(jnp.asarray(y), jnet.apply(p, jnp.asarray(y)))  # noqa: E731
        net = load_flax_params(ThetaPosteriorFullCovNet(), params)
        loss = make_loss_step1_fullcov(lambda th: fh(th)[0], torch.as_tensor(e), cfg.sig_e)(
            torch.as_tensor(y), net(torch.as_tensor(y)))
    val_j, grads_j = jax.jit(jax.value_and_grad(obj))(params)
    loss.backward()
    # 1e-11 and 1e-9: float64 through 24 FEM solves and their adjoints
    assert abs(float(loss) - float(val_j)) < 1e-11 * abs(float(val_j))
    _assert_grads_close(net, grads_j, 1e-9)


@pytest.mark.parametrize("family", ["fullcov", "flow"])
def test_step2_loss_and_grads_match_jax(fems, inputs, family):
    fh_j, fh, _, cfg = fems
    y, e, lm, ls = inputs
    alpha = 1e-2  # the terms 4 and 5 large enough to show
    z_params = _perturbed(JaxZNet().init(jax.random.PRNGKey(5), jnp.zeros((1, 2))), 6, 0.05)
    yj = jnp.asarray(y)
    if family == "flow":
        params, jnet = _flow_params(), JaxFlowNet()
        th_j, _ = jnet.apply(params, yj, jnp.asarray(e))
        theta_out_j = (th_j.reshape(-1, 2),)
        net = load_flax_params(ThetaPosteriorFlowNet(), params)
        with torch.no_grad():
            th = net(torch.as_tensor(y), torch.as_tensor(e))[0]
        theta_out = (th.reshape(-1, 2),)
    else:
        params, jnet = _fullcov_params(), JaxFullCovNet()
        theta_out_j = jnet.apply(params, yj)[:2]
        net = load_flax_params(ThetaPosteriorFullCovNet(), params)
        with torch.no_grad():
            theta_out = net(torch.as_tensor(y))[:2]
    kw = dict(fullcov=family == "fullcov", flow=family == "flow")
    loss_j = jax_make_loss_step2(lambda th: fh_j(th)[1], jnp.asarray(e), cfg.sig_eta, alpha,
                                 "per_sample", **kw)
    batch_j = (yj, jnp.asarray(lm), jnp.asarray(ls))
    val_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: loss_j(batch_j, (*theta_out_j, *JaxZNet().apply(p, yj)))))(z_params)
    z_net = load_flax_params(ZPredictiveNet(), z_params)
    loss_fn = make_loss_step2(lambda th: fh(th)[1], torch.as_tensor(e), cfg.sig_eta, alpha,
                              "per_sample", **kw)
    batch = tuple(torch.as_tensor(a) for a in (y, lm, ls))
    loss = loss_fn(batch, (*theta_out, *z_net(batch[0])))
    loss.backward()
    assert abs(float(loss) - float(val_j)) < 1e-11 * abs(float(val_j))
    _assert_grads_close(z_net, grads_j, 1e-9)
    with pytest.raises(ValueError):
        make_loss_step2(lambda th: fh(th)[1], torch.as_tensor(e), cfg.sig_eta, alpha, "cross",
                        flow=True)


@pytest.mark.parametrize("clipped", [True, False], ids=["norm_above_max", "norm_below_max"])
def test_clipped_adam_step_matches_optax(fems, inputs, clipped):
    """One step of ``update_step1`` with ``clip_grad_norm`` against
    ``optax.chain(clip_by_global_norm, adam)``, full covariance."""
    fh_j, fh, model, cfg = fems
    y, e = inputs[0], inputs[1]
    params = _fullcov_params()
    loss_j = jax_make_loss_step1_fullcov(lambda th: fh_j(th)[0], jnp.asarray(e), cfg.sig_e)
    obj = lambda p: loss_j(jnp.asarray(y), JaxFullCovNet().apply(p, jnp.asarray(y)))  # noqa: E731
    grads_j = jax.jit(jax.grad(obj))(params)
    g_norm = float(optax.global_norm(grads_j))
    max_norm = 0.5 * g_norm if clipped else 2.0 * g_norm
    opt = optax.chain(optax.clip_by_global_norm(max_norm),
                      optax.adam(1e-3, b1=0.99, b2=0.999, eps=1e-10))
    updates, _ = opt.update(grads_j, opt.init(params), params)
    want = optax.apply_updates(params, updates)

    tcfg = TrainConfig(posterior="fullcov", pairing="per_sample", clip_grad_norm=max_norm)
    trainer = TwoStepTrainer(model, cfg, tcfg, fh_batch=fh)
    net = load_flax_params(ThetaPosteriorFullCovNet(), params)
    trainer.update_step1(net, trainer.optimizer_step1(net), torch.as_tensor(y),
                         torch.as_tensor(e))
    assert abs(float(trainer.last_grad_norm) - g_norm) < 1e-12 * g_norm
    clipped_norm = math.sqrt(sum(float((p.grad**2).sum()) for p in net.parameters()))
    assert clipped_norm <= max_norm * (1 + 1e-14) if clipped else clipped_norm < max_norm
    ref = want["params"]
    for name in ("theta_mean_net", "theta_sig_net", "theta_offdiag_net"):
        for i, layer in enumerate(getattr(net, name).layers):
            for ours, k in ((layer.weight.detach().numpy().T, "kernel"),
                            (layer.bias.detach().numpy(), "bias")):
                np.testing.assert_allclose(ours, np.asarray(ref[name][f"Dense_{i}"][k]),
                                           rtol=0, atol=1e-14, err_msg=f"{name}/{i}/{k}")


def test_family_predict_and_samples(fems, inputs):
    """predict's fullcov variances are diag(L L^T) of predict_cholesky, the
    flow's the MC moments of its generator; sample_theta is each family's
    reparameterization."""
    _, fh, model, cfg = fems
    y, e = (torch.as_tensor(a) for a in inputs[:2])
    z_net = ZPredictiveNet()
    z_net.reset_parameters(torch.Generator().manual_seed(0))
    fc = TwoStepTrainer(model, cfg, TrainConfig(posterior="fullcov", pairing="per_sample"),
                        fh_batch=fh)
    net = load_flax_params(ThetaPosteriorFullCovNet(), _fullcov_params())
    tm, tsig, _, _ = fc.predict(net, z_net, y)
    mu, L = fc.predict_cholesky(net, y)
    assert torch.equal(tm, mu) and torch.equal(tsig, torch.sum(L**2, dim=-1))
    th = fc.sample_theta(net, y, e)
    assert torch.allclose(th, mu[:, None] + torch.einsum("bij,nj->bni", L, e), rtol=1e-15)
    fl = TwoStepTrainer(model, cfg, TrainConfig(posterior="flow", pairing="per_sample"),
                        fh_batch=fh)
    net = load_flax_params(ThetaPosteriorFlowNet(), _flow_params(scale=0.3))
    tm, tsig, _, _ = fl.predict(net, z_net, y, n_mc=32)
    m, v = flow_moments(net, y, torch.Generator().manual_seed(0), n_mc=32)
    assert torch.equal(tm, m) and torch.equal(tsig, v)
    with torch.no_grad():
        assert torch.equal(fl.sample_theta(net, y, e), net(y, e)[0])
    with pytest.raises(ValueError):
        fl.predict_cholesky(net, y)
    assert fl.theta_sampler(net, y)(torch.Generator().manual_seed(1), 9).shape == (B, 9, 2)


# ---------------------------------------------------------------------------
# statistical gates (tests/test_vi.py, tests/test_vi_fullcov.py,
# tests/test_vi_flow.py), on the port alone
# ---------------------------------------------------------------------------


def _adam_fit(objective, params, n_steps, lr, e_shape, seed):
    """Adam on ``params`` (leaf tensors) with fresh base draws a step."""
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    g = torch.Generator().manual_seed(seed)
    e_all = torch.randn((n_steps, *e_shape), generator=g, dtype=torch.float64)
    for k in range(n_steps):
        opt.zero_grad(set_to_none=True)
        objective(e_all[k]).backward()
        opt.step()
    return [p.detach() for p in params]


def test_resample_e_calibrates_linear_gaussian():
    """Fresh draws every step: the step-1 optimum of f = 2 theta, prior
    N(0, 1), is the exact posterior N(2y/sig_e / (1 + 4/sig_e),
    1/(1 + 4/sig_e)), recovered by optimizing (mu, log_sig) directly."""
    sig_e, yv = 0.1, 1.3
    prec = 1.0 + 4.0 / sig_e
    post_mean, post_var = (2.0 * yv / sig_e) / prec, 1.0 / prec
    loss_fn = make_loss_step1(lambda th: 2.0 * th, torch.zeros(8, 1, dtype=torch.float64),
                              sig_e, "per_sample")
    y = torch.tensor([[yv]], dtype=torch.float64)
    mu = torch.zeros((1, 1), dtype=torch.float64, requires_grad=True)
    lts = torch.zeros((1, 1), dtype=torch.float64, requires_grad=True)
    mu, lts = _adam_fit(lambda e: loss_fn(y, (mu, torch.exp(lts), lts), e), [mu, lts], 4000,
                        2e-2, (8, 1), 0)
    assert abs(float(mu) - post_mean) < 0.05 * abs(post_mean) + 0.02
    got_var = float(torch.exp(lts))
    assert abs(got_var - post_var) < 0.3 * post_var, (got_var, post_var)


def test_fullcov_recovers_correlated_gaussian_exactly():
    """Direct (mu, L) optimization of the full-covariance step-1 ELBO on a
    correlated linear-Gaussian model recovers the exact posterior mean and
    covariance; the mean-field optimum lands on the precision diagonal."""
    A = torch.tensor([[1.0, 1.0], [0.0, 0.15]], dtype=torch.float64)
    sig_e = 0.05
    Y = torch.tensor([[0.9, 0.1]], dtype=torch.float64)
    prec = np.eye(2) + A.numpy().T @ A.numpy() / sig_e
    sigma = np.linalg.inv(prec)
    mu_exact = sigma @ (A.numpy().T @ Y.numpy()[0] / sig_e)
    f = lambda th: th @ A.T  # noqa: E731
    zeros = torch.zeros(16, 2, dtype=torch.float64)
    fc_loss = make_loss_step1_fullcov(f, zeros, sig_e)
    mu, log_diag, off = (torch.zeros(s, dtype=torch.float64, requires_grad=True)
                         for s in ((1, 2), (1, 2), (1,)))

    def fc_obj(e):
        L = torch.diag_embed(torch.exp(0.5 * log_diag))
        L = L + torch.stack([torch.zeros_like(off), torch.zeros_like(off), off,
                             torch.zeros_like(off)], dim=-1).reshape(1, 2, 2)
        return fc_loss(Y, (mu, L, log_diag), e)

    mu, log_diag, off = _adam_fit(fc_obj, [mu, log_diag, off], 6000, 2e-2, (16, 2), 0)
    L = np.diag(np.exp(0.5 * log_diag.numpy()[0]))
    L[1, 0] = float(off[0])
    np.testing.assert_allclose(mu.numpy()[0], mu_exact, atol=0.05)
    np.testing.assert_allclose(L @ L.T, sigma, rtol=0.15, atol=5e-4)

    mf_loss = make_loss_step1(f, zeros, sig_e, "per_sample")
    mu_mf, log_sig = (torch.zeros((1, 2), dtype=torch.float64, requires_grad=True)
                      for _ in range(2))
    _, log_sig = _adam_fit(lambda e: mf_loss(Y, (mu_mf, torch.exp(log_sig), log_sig), e),
                           [mu_mf, log_sig], 6000, 2e-2, (16, 2), 0)
    var_mf = np.exp(log_sig.numpy())[0]
    np.testing.assert_allclose(var_mf, 1.0 / np.diag(prec), rtol=0.3)
    assert sigma[0, 0] > 5.0 * var_mf[0]  # the mean-field gap is real


def test_flow_beats_gaussian_on_banana():
    """On the banana posterior y = theta2 + a*theta1^2 + eps the trained
    flow's full-data ELBO on fresh draws beats the trained full-covariance
    Gaussian's by more than 0.5 nats. Cut from the JAX test's 300 epochs
    (which the JAX package marks slow) to 150, and trained with fresh base
    draws (``resample_e``, as examples/train_flow_vi.py trains): with the
    dataset's eight fixed draws the flow fits those eight points, and its
    fresh-draw ELBO depends on which they are (the JAX test's data and init
    give 5.2 in either package; this file's seeds give 115 and 649)."""
    a, sig_e = 2.0, 0.05**2

    def fh(th):
        return (th[:, 1] + a * th[:, 0] ** 2)[:, None], (torch.exp(0.3 * th[:, 0]) + 0.2)[:, None]

    ds = generate_data_fem(torch.Generator().manual_seed(0), fh, n_sam=512, ne_sam=8,
                           device="cpu", d_y=1, sig_e=sig_e, sig_eta=1e-4)
    ynorm = (ds.y_data.mean(0), ds.y_data.std(0))
    cfg = ProblemConfig(theta_dim=2, y_dim=1, z_dim=1, sig_e=sig_e, sig_eta=1e-4)
    batch_f = lambda th: fh(th)[0]  # noqa: E731
    e_eval = torch.randn((64, 2), generator=torch.Generator().manual_seed(99),
                         dtype=torch.float64)
    y = torch.as_tensor(ds.y_data)
    evals = {}
    for fam in ("fullcov", "flow"):
        tcfg = TrainConfig(batch_size=64, num_epoch1=150, pairing="per_sample", posterior=fam,
                           resample_e=True)
        tr = TwoStepTrainer(None, cfg, tcfg, fh_batch=fh, device="cpu", y_norm=ynorm)
        net, _, _ = tr.train_step1(ds.y_data, ds.e_data, torch.Generator().manual_seed(2))
        with torch.no_grad():
            if fam == "flow":
                evals[fam] = float(make_loss_step1_flow(batch_f, sig_e)(y, net(y, e_eval)))
            else:
                evals[fam] = float(make_loss_step1_fullcov(batch_f, e_eval, sig_e)(y, net(y)))
    assert evals["flow"] < evals["fullcov"] - 0.5, evals
