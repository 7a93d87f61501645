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
from portbench.reference import fem, fem_box, vi


EXACT = {"cg_dtype": "float64", "tol": 1e-13, "maxiter": 2000, "refine_iters": 0}
BOX_MESHES = [{"nx": 4, "ny": 2, "nz": 2}, {"nx": 6, "ny": 4, "nz": 2}]


def _config(name="cooks_160x80", mesh=None, **solver):
    with open(os.path.join(manifest.BENCH_DIR, "configs", name + ".json")) as f:
        cfg = tiny_config(json.load(f), mesh)
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


# The box reference against the port, both solving to round-off in float64:
# the port's CG stops at 1e-13, so y, h and their adjoint gradients agree to
# a few 1e-12 (1e-9 leaves room for the aspect ratio's conditioning); the
# loss, its gradient and Adam's step follow them (1e-10, 1e-8 as for Cook's).
@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("mesh", BOX_MESHES, ids=["4x2x2", "6x4x2"])
def test_box_observation_and_adjoint_match_the_port(mesh, dense):
    tol = 1e-9
    cfg = _config("box_32x8x8", mesh, **EXACT)
    fh, _ = system.build_fh(cfg, "cpu")
    problem = fem_box.build_problem(cfg, "cpu")
    ref = fem_box.Solver(problem, dense=dense)
    th = _thetas(6).requires_grad_(True)
    y_p, h_p = fh(th)
    th_r = th.detach().clone().requires_grad_(True)
    y_r, h_r = fem_box.observe(problem, ref, th_r)
    assert y_r.shape == (6, 3) and h_r.shape == (6, 2)
    for got, want in ((y_p, y_r), (h_p, h_r)):
        assert float((got - want).detach().abs().max() / want.abs().max()) < tol
    w = torch.as_tensor(np.random.default_rng(1).normal(size=(6, 3)))
    (g_p,) = torch.autograd.grad((y_p * w).sum() + h_p.sum(), th)
    (g_r,) = torch.autograd.grad((y_r * w).sum() + h_r.sum(), th_r)
    assert float((g_p - g_r).abs().max() / g_r.abs().max()) < 10 * tol


@pytest.mark.parametrize("mesh", BOX_MESHES, ids=["4x2x2", "6x4x2"])
def test_box_step1_loss_gradient_and_step_match_the_port(mesh):
    """Per-sample pairing, 3 observed dofs and the nets' inputs standardised
    (``y_norm``): the port's loss, its gradient as Adam's first moment gives
    it, and its step, against the reference's from the same weights."""
    cfg = _config("box_32x8x8", mesh, **EXACT)
    assert cfg["pairing"] == "per_sample" and cfg["y_norm"]
    problem = fem_box.build_problem(cfg, "cpu")
    ref = fem_box.Solver(problem)
    ys = fem_box.observe(problem, ref, _thetas(40, 4))[0].detach()
    ys = ys + 0.3 * torch.as_tensor(np.random.default_rng(6).normal(size=ys.shape))
    mean, std = ys.mean(0), ys.std(0, correction=0)
    y, e = ys[:8], _thetas(3, 5)
    params0 = vi.glorot_params(torch.Generator().manual_seed(3), 3, 20, 3, 2, torch.float64)
    fh, _ = system.build_fh(cfg, "cpu")
    trainer = system.build_trainer(cfg, {"batch": 8}, fh, "cpu",
                                   (mean[None].numpy(), std[None].numpy()))
    net = trainer.new_theta_net(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p, w in zip(net.parameters(), params0, strict=True):
            p.copy_(w)
    opt = trainer.optimizer_step1(net)
    loss_p = float(trainer.update_step1(net, opt, y, e))
    grads_p = [opt.state[p]["exp_avg"] / (1 - cfg["adam"]["betas"][0]) for p in net.parameters()]
    (loss_r,), grads_r, params_r = vi.follow_steps(problem, ref, params0, [y], e, cfg,
                                                   observe=fem_box.observe, y_norm=(mean, std))
    assert abs(loss_p - loss_r) < 1e-10 * abs(loss_r)
    from portbench.harness import runners

    assert runners._leaf_gap(grads_p, grads_r) < 1e-8
    assert runners._leaf_gap([p.detach() - w for p, w in zip(net.parameters(), params0)],
                             [r - w for r, w in zip(params_r, params0)]) < 1e-8
    # without the standardisation the reference's loss is another one
    (loss_raw,), _, _ = vi.follow_steps(problem, ref, params0, [y], e, cfg,
                                        observe=fem_box.observe)
    assert abs(loss_raw - loss_r) > 1e-3 * abs(loss_r)


@pytest.mark.parametrize("mesh", BOX_MESHES, ids=["4x2x2", "6x4x2"])
def test_box_reference_self_checks(mesh):
    """The box reference on its own: the load sums to the tip force on the
    x = lx face; both stiffness parts are symmetric and annihilate the rigid
    translations and rotations of the unclamped box (to round-off of their
    largest entry); the dense and CG solves agree; the adjoint gradient of y and h matches central
    differences (to 1e-6, the differences' own truncation at step 1e-5)."""
    cfg = _config("box_32x8x8", mesh)
    m = cfg["mesh"]
    coords, conn, fixed, f = fem_box.box_mesh(m["nx"], m["ny"], m["nz"], m["lx"], m["ly"],
                                             m["lz"], m["tip_force"])
    f3 = f.reshape(-1, 3)
    assert np.allclose(f3.sum(0), m["tip_force"], rtol=0, atol=1e-15)
    assert np.all(f3[coords[:, 0] < m["lx"]] == 0)
    assert fixed.size == 3 * (m["ny"] + 1) * (m["nz"] + 1)
    B, dvol = fem_box.hex8_b(coords, conn)
    lm = (3 * conn[:, :, None] + np.arange(3)).reshape(conn.shape[0], 24)
    ndof = 3 * coords.shape[0]
    x, yy, z = coords.T
    rigid = np.zeros((ndof, 6))
    for a in range(3):
        rigid[a::3, a] = 1.0
    rigid[0::3, 3], rigid[1::3, 3] = -yy, x  # about z
    rigid[1::3, 4], rigid[2::3, 4] = -z, yy  # about x
    rigid[2::3, 5], rigid[0::3, 5] = -x, z  # about y
    for C in (fem_box.C_LAM, fem_box.C_MU):
        ke = np.einsum("eqai,ab,eqbj,eq->eij", B, C, B, dvol)
        K = np.zeros((ndof, ndof))
        for e in range(conn.shape[0]):
            K[np.ix_(lm[e], lm[e])] += ke[e]
        assert np.allclose(K, K.T, rtol=0, atol=1e-13 * np.abs(K).max())
        assert np.abs(K @ rigid).max() < 1e-12 * np.abs(K).max()
    problem = fem_box.build_problem(cfg, "cpu")
    th = _thetas(4, 8)
    y_d, h_d = fem_box.observe(problem, fem_box.Solver(problem, dense=True), th)
    cg = fem_box.Solver(problem, dense=False)
    y_c, h_c = fem_box.observe(problem, cg, th)
    # CG stops at a relative residual of 100 eps: times the condition of the
    # stiffness (some 1e3 at the elements' 5:1 aspect), under 1e-10
    assert float((y_c - y_d).abs().max() / y_d.abs().max()) < 1e-10
    assert float((h_c - h_d).abs().max() / h_d.abs().max()) < 1e-10
    th_g = th.clone().requires_grad_(True)
    w = torch.as_tensor(np.random.default_rng(2).normal(size=(4, 5)))

    def obj(t):
        a, b = fem_box.observe(problem, cg, t)
        return (torch.cat([a, b], 1) * w).sum()

    (g,) = torch.autograd.grad(obj(th_g), th_g)
    step = 1e-5
    for r in range(th.shape[0]):
        for k in range(2):
            d = torch.zeros_like(th)
            d[r, k] = step
            num = (obj(th + d) - obj(th - d)) / (2 * step)
            assert abs(float(num) - float(g[r, k])) < 1e-6 * float(g.abs().max())


def test_box_is_built_as_the_example_builds_it():
    """``build_fh`` and ``build_trainer`` call the port's entry points for
    the box as ``examples/train_scaled_3d_torch.py`` does at its defaults;
    a solver kind that is not its problem's is refused before any build."""
    from portbench.test_portbench_cooks_pinned import record_calls

    with open(os.path.join(manifest.BENCH_DIR, "configs", "box_32x8x8.json")) as f:
        cfg = json.load(f)
    calls = record_calls(cfg, {"batch": 64})
    by_name = {c[0]: c for c in calls["calls"]}
    box = {"lx": 10.0, "ly": 1.0, "lz": 1.0, "tip_force": [0.0, 0.0, -0.02]}
    assert [c[1:] for c in calls["calls"] if c[0] == "beam_hex8_mesh"] == [
        [[32, 8, 8], box], [[16, 4, 4], box]]
    assert [c[2]["dense"] for c in calls["calls"] if c[0] == "build_fem_model"] == [False, True]
    solve = by_name["solve:make_two_level_solver_box3d"]
    assert solve[1][2:] == [[16, 4, 4], 2]
    assert solve[2] == {"cg_dtype": "torch.float32", "maxiter": 400, "omega": 0.6,
                        "refine_iters": 1, "refine_residual": "f64", "tol": 0.003}
    pc = calls["problem_config"]
    assert (pc["y_dim"], pc["node_id"], pc["ele_id"], pc["nipt_id"]) == (
        3, 33 * 9 * 9, ((8 - 1) * 8 + 8 // 2) * 32 + 2, [1, 5])
    trainer = by_name["TwoStepTrainer"]
    assert trainer[1][2]["pairing"] == "per_sample" and trainer[1][2]["batch_size"] == 64
    bad = json.loads(json.dumps(cfg))
    bad["solver"]["kind"] = "two_level"
    with pytest.raises(ValueError, match="unknown solver kind"):
        system.build_fh(bad, "cpu")
