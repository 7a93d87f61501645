"""The plain reference against the port at tiny meshes on the CPU, through
the port's plain paths: the observation operator and its adjoint, the
step-1 loss, and Adam from a fresh state and from the port's state."""
import json
import os

import numpy as np
import pytest
import torch

from portbench.conftest import tiny_config
from portbench.harness import manifest, system
from portbench.reference import fem, vi


EXACT = {"cg_dtype": "float64", "tol": 1e-13, "maxiter": 2000, "refine_iters": 0}


def _config(name="cooks_160x80", **solver):
    with open(os.path.join(manifest.BENCH_DIR, "configs", name + ".json")) as f:
        cfg = tiny_config(json.load(f))
    cfg["solver"].update(solver)
    return cfg


def _thetas(n, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).normal(size=(n, 2)) * 2.0)


@pytest.mark.parametrize("dense", [False, True])
def test_observation_and_adjoint_match_the_port(dense):
    tol = 1e-9
    cfg = _config(**EXACT)
    fh, _ = system.build_fh(cfg, "cpu")
    problem = fem.build_problem(cfg, "cpu")
    ref = fem.Solver(problem, dense=dense)
    th = _thetas(6).requires_grad_(True)
    y_p, h_p = fh(th)
    th_r = th.detach().clone().requires_grad_(True)
    y_r, h_r = fem.observe(problem, ref, th_r)
    for got, want in ((y_p, y_r), (h_p, h_r)):
        assert float((got - want).detach().abs().max() / want.abs().max()) < tol
    w = torch.as_tensor(np.random.default_rng(1).normal(size=(6, 2)))
    (g_p,) = torch.autograd.grad((y_p * w).sum(), th)
    (g_r,) = torch.autograd.grad((y_r * w).sum(), th_r)
    assert float((g_p - g_r).abs().max() / g_r.abs().max()) < 10 * tol


def _port_trainer(cfg, params0):
    fh, _ = system.build_fh(cfg, "cpu")
    trainer = system.build_trainer(cfg, {"batch": 8}, fh, "cpu")
    net = trainer.new_theta_net(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p, w in zip(net.parameters(), params0, strict=True):
            p.copy_(w)
    return fh, trainer, net


def test_step1_loss_and_adam_match_the_port():
    from vbicm_tpu_torch.vi.elbo import make_loss_step1

    cfg = _config(**EXACT)
    params0 = vi.glorot_params(torch.Generator().manual_seed(3), 2, 20, 3, 2, torch.float64)
    fh, trainer, net = _port_trainer(cfg, params0)
    problem = fem.build_problem(cfg, "cpu")
    ref = fem.Solver(problem)
    y = fem.observe(problem, ref, _thetas(8, 4))[0].detach()
    e = _thetas(3, 5)
    sig_e, pairing = cfg["noise"]["sig_e"], cfg["pairing"]
    with torch.no_grad():
        loss_p = make_loss_step1(lambda t: fh(t)[0], e, sig_e, pairing)(y, net(y))
        loss_r = vi.step1_loss(params0, y, e, lambda t: fem.observe(problem, ref, t)[0],
                               sig_e, pairing)
    assert abs(float(loss_p) - float(loss_r)) < 1e-10 * abs(float(loss_r))
    opt = trainer.optimizer_step1(net)
    losses_p = [float(trainer.update_step1(net, opt, y, e)) for _ in range(2)]
    losses_r, _, params_r = vi.follow_steps(problem, ref, params0, [y, y], e, cfg)
    assert np.allclose(losses_p, losses_r, rtol=1e-10)
    for p, r in zip(net.parameters(), params_r):
        assert torch.allclose(p.detach(), r, rtol=1e-8, atol=1e-11)


def test_a_step_taken_up_from_the_ports_state_matches_the_port():
    """The reference's step from the port's parameters and Adam's moments
    and step count after two steps equals the port's third step: its loss,
    its gradient as the first moment gives it, and its change."""
    from portbench.harness import runners

    cfg = _config(**EXACT)
    params0 = vi.glorot_params(torch.Generator().manual_seed(7), 2, 20, 3, 2, torch.float64)
    _, trainer, net = _port_trainer(cfg, params0)
    problem = fem.build_problem(cfg, "cpu")
    ref = fem.Solver(problem)
    ys = [fem.observe(problem, ref, _thetas(8, 10 + k))[0].detach() for k in range(3)]
    e = _thetas(3, 5)
    opt = trainer.optimizer_step1(net)
    for y in ys[:2]:
        trainer.update_step1(net, opt, y, e)
    p0, m0, v0, t0 = runners._host(runners._adam_state(net, opt))
    assert t0 == 2
    loss_p = float(trainer.update_step1(net, opt, ys[2], e))
    p1, m1, _, _ = runners._host(runners._adam_state(net, opt))
    (loss_r,), grads_r, p1_r = vi.follow_steps(problem, ref, p0, [ys[2]], e, cfg,
                                               state=(m0, v0, t0))
    assert abs(loss_p - loss_r) < 1e-10 * abs(loss_r)
    beta1 = cfg["adam"]["betas"][0]
    grads_p = [(a - beta1 * b) / (1 - beta1) for a, b in zip(m1, m0)]
    assert runners._leaf_gap(grads_p, grads_r) < 1e-8
    assert runners._leaf_gap([a - b for a, b in zip(p1, p0)],
                             [a - b for a, b in zip(p1_r, p0)]) < 1e-8
