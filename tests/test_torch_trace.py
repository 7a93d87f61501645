"""The port's spans and counters (``vbicm_tpu_torch.utils.trace``) on a small
two-level Cook's solve, forward and backward (CPU): spans cost nothing when
off, nest as the layers do under the profiler, and leave every result
bitwise as it was; the CG's loop steps and reads derived from its lanes'
iterations agree with the loop. Then the attribution of kernels to spans
(``utils.trace.by_span``) on a synthetic trace."""
import collections
import contextlib
import dataclasses
import functools
import importlib.util
import math
import os

import numpy as np
import pytest
import torch

from vbicm_tpu_torch.config import ProblemConfig, TrainConfig
from vbicm_tpu_torch.mesh import cooks_membrane_mesh
from vbicm_tpu_torch.model import build_fem_model
from vbicm_tpu_torch.ops.element import lame_from_Ev
from vbicm_tpu_torch.ops.solve import make_field_solver, pcg, pcg_lane_use, pcg_loop
from vbicm_tpu_torch.prob.datagen import generate_data_fem
from vbicm_tpu_torch.solver import make_fh_fun, make_two_level_solver
from vbicm_tpu_torch.utils import trace
from vbicm_tpu_torch.vi.train import TwoStepTrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NX, NY, R = 16, 8, 4

# each span's parents as the layers nest them (backward runs on the calling
# thread for CPU tensors, so the adjoint's spans sit in train.backward here)
PARENTS = {
    "train.step": {None},
    "train.loss": {"train.step"}, "train.backward": {"train.step"},
    "train.optimizer": {"train.step"},
    "fh": {None, "train.loss", "datagen.chunk"},
    "solve.forward": {"fh"},
    "solve.adjoint": {"train.backward"}, "solve.cotangent": {"train.backward"},
    "cg.run": {"solve.forward", "solve.adjoint"},
    "refine.residual": {"solve.forward", "solve.adjoint"},
    "cg.matvec": {"cg.run"}, "cg.update": {"cg.run"}, "cg.check": {"cg.run"},
    "prec": {"cg.run"},
    "prec.restrict": {"prec"}, "prec.coarse": {"prec"}, "prec.prolong": {"prec"},
    "datagen.chunk": {None}, "datagen.readback": {"datagen.chunk"},
}


@pytest.fixture(scope="module")
def problem():
    """The observation operator over a 16x8 two-level solve (4x2 coarse,
    float32 CG at tol 1e-4, one float64 refinement), its solver, and a
    step-1 trainer over it."""
    fine = build_fem_model(cooks_membrane_mesh(NX, NY), device="cpu", dense=False)
    coarse = build_fem_model(cooks_membrane_mesh(NX // R, NY // R), device="cpu", dense=True)
    solve = make_two_level_solver(fine, coarse, NX // R, NY // R, R, cg_dtype=torch.float32,
                                  refine_iters=1, tol=1e-4, maxiter=400, use_stencil=True)
    cfg = dataclasses.replace(ProblemConfig(), node_id=fine.nnodes, ele_id=(NY // 2) * NX + 2)
    fh = make_fh_fun(fine, cfg, solve_free=solve)
    trainer = TwoStepTrainer(None, cfg, TrainConfig(batch_size=4), fh_batch=fh, device="cpu")
    return fh, solve.solver, trainer


def _inputs(problem):
    fh, _, _ = problem
    rng = np.random.default_rng(3)
    with torch.no_grad():
        y, _ = fh(torch.as_tensor(rng.normal(size=(4, 2))))
    return y + 0.3 * torch.as_tensor(rng.normal(size=(4, 2))), torch.as_tensor(
        rng.normal(size=(4, 2)))


def _train_step(problem):
    """One update_step1 from fixed weights: its loss and gradients."""
    _, _, trainer = problem
    y, e = _inputs(problem)
    net = trainer.new_theta_net(torch.Generator().manual_seed(0))
    loss = trainer.update_step1(net, trainer.optimizer_step1(net), y, e)
    return [loss] + [p.grad.clone() for p in net.parameters()]


def _fh_grad(problem):
    """fh forward and backward at fixed thetas: y, h and d(sum y + h)/dthetas."""
    fh, _, _ = problem
    thetas = torch.as_tensor(np.random.default_rng(4).normal(size=(6, 2)), dtype=torch.float64)
    thetas.requires_grad_(True)
    y, h = fh(thetas)
    (y.sum() + h.sum()).backward()
    return [y.detach(), h.detach(), thetas.grad]


@functools.lru_cache(maxsize=None)
def _field_solver():
    """Cook's 8x4 and its field solver in grid mode: float32 CG and one
    float64 refinement, the random-field trainer's policy."""
    model = build_fem_model(cooks_membrane_mesh(8, 4), device="cpu", dense=False)
    lam1, mu1 = lame_from_Ev(1.0, 0.3)
    solve = make_field_solver(lam1 * model.ke_lam + mu1 * model.ke_mu, model.lm,
                              model.free_mask, model.ndof, tol=1e-6, cg_dtype=torch.float32,
                              refine_iters=1, grid=(8, 4))
    return model, solve


def _field_grad(problem):
    """A field solve forward and backward on the 8x4 grid at fixed fields:
    u and d(sum w u)/dE."""
    model, solve = _field_solver()
    rng = np.random.default_rng(5)
    E = torch.as_tensor(np.exp(3.0 + 0.3 * rng.normal(size=(3, model.nele))))
    E.requires_grad_(True)
    u = solve(E, model.f_ext.expand(3, -1))
    (torch.as_tensor(rng.normal(size=tuple(u.shape))) * u).sum().backward()
    return [u.detach(), E.grad]


@pytest.fixture(scope="module")
def tool():
    path = os.path.join(ROOT, "tools", "profile_scaled_torch.py")
    spec = importlib.util.spec_from_file_location("profile_scaled_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _delta(before, prefix=""):
    """The counters named ``prefix...`` that moved since the snapshot
    ``before``."""
    return {k: v - before.get(k, 0) for k, v in trace.counters().items()
            if v != before.get(k, 0) and k.startswith(prefix)}


def test_spans_off_never_call_record_function(problem, monkeypatch):
    calls = []

    def counted(name):
        calls.append(name)
        return contextlib.nullcontext()

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    _train_step(problem)
    _fh_grad(problem)
    assert calls == []
    with trace.enabled():
        _train_step(problem)
    assert {"train.step", "solve.adjoint", "cg.matvec", "prec.coarse"} <= set(calls)


def test_enabled_restores_the_flag_and_counters_are_snapshots():
    with pytest.raises(RuntimeError):
        with trace.enabled():
            assert trace.span("x") is not trace.span("y")
            raise RuntimeError
    assert trace.span("x") is trace.span("y")  # the shared no-op
    trace.count("test.counter", 3)
    snap = trace.counters()
    trace.count("test.counter")
    assert snap["test.counter"] + 1 == trace.counters()["test.counter"]


def _parents(events):
    """Each span's parent: the innermost span around it on its thread."""
    out = []
    for tid in {ev[1] for ev in events}:
        stack = []
        for name, _, s, e in sorted((ev for ev in events if ev[1] == tid),
                                    key=lambda ev: (ev[2], -ev[3])):
            while stack and stack[-1][2] <= s:
                stack.pop()
            out.append((name, stack[-1][0] if stack else None))
            stack.append((name, s, e))
    return out


def test_spans_are_recorded_and_nest_under_the_profiler(problem):
    fh, _, _ = problem
    assert set(trace.SPANS) == set(PARENTS)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof, \
            trace.enabled():
        _train_step(problem)
        generate_data_fem(torch.Generator().manual_seed(1), fh, n_sam=6, ne_sam=2,
                          device="cpu", chunk=4)
    events = [(ev.name(), ev.start_thread_id(), ev.start_ns(), ev.end_ns())
              for ev in prof.profiler.kineto_results.events() if ev.name() in PARENTS]
    pairs = _parents(events)
    assert {name for name, _ in pairs} == set(PARENTS)
    wrong = sorted({(n, p) for n, p in pairs if p not in PARENTS[n]})
    assert not wrong, wrong


@pytest.mark.parametrize("run", ["train_step", "fh_grad", "field_grad"])
def test_results_bitwise_with_spans_on_and_off(problem, run):
    """The affine solver (the trainer's and fh's) and the field solver run
    through one autograd Function: the same bits, and its spans, either way."""
    fn = {"train_step": _train_step, "fh_grad": _fh_grad, "field_grad": _field_grad}[run]
    off = fn(problem)
    with trace.enabled():
        on = fn(problem)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof, \
            trace.enabled():
        profiled = fn(problem)
    for a, b, c in zip(off, on, profiled, strict=True):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert {"solve.forward", "solve.adjoint", "solve.cotangent", "cg.run",
            "refine.residual"} <= {ev.key for ev in prof.key_averages()}


def _expected_loop(lane_iters, maxiter, check_every=8):
    """(loop steps, activity checks) of a batched CG whose lanes need these
    iterations, by walking its loop: every lane runs until the last stops;
    the loop looks every ``check_every`` iterations."""
    steps = checks = 0
    for k in range(maxiter):
        if k % check_every == 0:
            checks += 1
            if k >= max(lane_iters):
                break
        steps += 1
    return steps, checks


@contextlib.contextmanager
def _span_calls(monkeypatch):
    """Spans on, each opening counted by name (no profiler)."""
    calls = collections.Counter()

    def counted(name):
        calls[name] += 1
        return contextlib.nullcontext()

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    with trace.enabled():
        yield calls


def test_cg_counters_match_the_solves_loops(problem, tool, monkeypatch):
    """The loop steps and checks ``pcg_loop`` derives from each run's lane
    iterations are the loop's own: one ``cg.matvec`` span a step, one
    ``cg.check`` a look."""
    _, solver, _ = problem
    with tool.lane_iterations(solver) as runs, _span_calls(monkeypatch) as calls:
        _fh_grad(problem)
    assert len(runs) == 4  # forward and adjoint, each a CG run and a refinement
    assert all(int(it.max()) < solver.maxiter for it in runs)
    loops = [pcg_loop(it, solver.maxiter) for it in runs]
    assert loops == [_expected_loop(it.tolist(), solver.maxiter) for it in runs]
    assert calls["cg.matvec"] == sum(s for s, _ in loops)
    assert calls["cg.check"] == sum(c for _, c in loops)
    lanes = sum(len(it) * s for it, (s, _) in zip(runs, loops))
    assert lanes >= sum(int(it.sum()) for it in runs)
    assert pcg_lane_use(runs, solver.maxiter) == 100.0 * sum(int(it.sum()) for it in runs) / lanes


@pytest.mark.parametrize("maxiter", [300, 12])
def test_pcg_counters_at_and_below_maxiter(maxiter, monkeypatch):
    """A batch of SPD systems whose lanes need different iterations, with
    the loop run to convergence or cut at maxiter."""
    rng = np.random.default_rng(0)
    n, B = 40, 5
    Q = torch.as_tensor(np.linalg.qr(rng.normal(size=(n, n)))[0])
    eig = torch.as_tensor(np.stack([np.geomspace(1.0, 10.0 ** (1 + b), n) for b in range(B)]))
    b = torch.as_tensor(rng.normal(size=(B, n)))
    with _span_calls(monkeypatch) as calls:
        _, it, _ = pcg(lambda x: ((x @ Q) * eig) @ Q.T, b, lambda r: r, tol=1e-10,
                       maxiter=maxiter)
    steps, checks = _expected_loop(it.tolist(), maxiter)
    assert (steps == maxiter) == (maxiter == 12)
    assert pcg_loop(it, maxiter) == (steps, checks) == (calls["cg.matvec"], calls["cg.check"])
    assert pcg_lane_use([it], maxiter) == 100.0 * int(it.sum()) / (B * steps)


@pytest.mark.parametrize("lanes", [[0, 0], [8, 3], [9], [16], [15, 2], [400], [396, 1]])
@pytest.mark.parametrize("maxiter", [400, 12, 16, 0])
def test_pcg_loop_is_the_loops_walk(lanes, maxiter):
    lanes = [min(i, maxiter) for i in lanes]
    assert pcg_loop(np.array(lanes), maxiter) == _expected_loop(lanes, maxiter)
    if maxiter % 8 == 0:  # the cut never binds below a look
        assert pcg_loop(np.array(lanes))[0] == _expected_loop(lanes, maxiter)[0]


def test_host_reads_of_datagen_and_epochs_are_counted(problem):
    """The datagen read-backs are counted, two a chunk; the epoch loop's
    loss read is on no benchmark cell's path and counts nothing (the
    solves' CG loop steps count under ``pcg.steps.*``, not as reads)."""
    fh, _, trainer = problem
    before = trace.counters()
    generate_data_fem(torch.Generator().manual_seed(2), fh, n_sam=10, ne_sam=2, device="cpu",
                      chunk=4)
    assert _delta(before, "host.") == {"host.sync.datagen_readback": 2 * math.ceil(10 / 4)}
    assert set(_delta(before)) == {"host.sync.datagen_readback", "pcg.steps.plain",
                                   "prec.calls.plain"}
    y, e = _inputs(problem)
    before = trace.counters()
    trainer.train_step1(y.numpy(), e.numpy(), torch.Generator().manual_seed(0), num_epochs=2)
    assert _delta(before, "host.") == {}
    assert set(_delta(before)) == {"pcg.steps.plain", "prec.calls.plain"}


def test_prec_counters_count_each_call_by_its_form(problem, tool, monkeypatch):
    """``prec.calls.plain`` counts every preconditioner call on CPU tensors,
    one a ``prec`` span: a loop step's and each CG run's first;
    ``prec.calls.fused`` (CUDA tensors on the structured-grid transfers)
    none."""
    _, solver, _ = problem
    before = trace.counters()
    with tool.lane_iterations(solver) as runs, _span_calls(monkeypatch) as calls:
        _fh_grad(problem)
    steps = sum(pcg_loop(it, solver.maxiter)[0] for it in runs)
    assert _delta(before, "prec.") == {"prec.calls.plain": steps + len(runs)}
    assert calls["prec"] == calls["prec.prolong"] == steps + len(runs)


# A synthetic trace. Host events: (name, thread, start, end, correlation id,
# linked correlation id); those with a linked id are runtime calls. Thread 1
# runs a step whose backward (thread 2, autograd's) opens its own spans.
OPS = [
    ("train.step", 1, 0, 100, 1, 0),
    ("train.loss", 1, 1, 40, 2, 0),
    ("cg.run", 1, 2, 30, 3, 0),
    ("cg.update", 1, 5, 10, 4, 0),
    ("aten::mul", 1, 6, 9, 5, 0),
    ("cudaLaunchKernel", 99, 7, 8, 501, 5),
    ("prec", 1, 12, 25, 6, 0),
    ("prec.restrict", 1, 13, 16, 7, 0),
    ("cudaLaunchKernel", 99, 14, 15, 502, 7),  # a kernel of the C path: linked to the span
    ("aten::add", 1, 18, 20, 8, 0),
    ("cudaLaunchKernel", 99, 19, 19.5, 503, 8),  # in prec, outside its sub-spans
    ("train.backward", 1, 50, 90, 9, 0),
    ("solve.adjoint", 2, 52, 70, 10, 0),
    ("aten::mm", 2, 55, 57, 11, 0),
    ("cudaLaunchKernel", 98, 56, 56.5, 504, 11),
    ("aten::mul", 2, 75, 77, 12, 0),  # MLP backward: no span on thread 2
    ("cudaLaunchKernel", 98, 76, 76.5, 505, 12),
    ("aten::zeros", 1, 120, 122, 13, 0),  # after the step: no span at all
    ("cudaLaunchKernel", 99, 121, 121.5, 506, 13),
]
KERNELS = [  # (name, start, end, correlation id, linked correlation id)
    ("mul_kernel", 8, 9, 501, 5),
    ("gemm_restrict", 15, 18, 502, 7),
    ("add_kernel", 20, 21, 503, 8),
    ("gemv2T", 57, 60, 504, 11),
    ("mul_bw", 77, 78, 505, 12),
    ("zeros", 122, 123, 506, 13),
    ("lost", 124, 125, 777, 777),  # neither its call nor its operator recorded
]


def test_tool_gives_each_kernel_its_innermost_span():
    paths = trace.by_span(OPS, KERNELS)
    assert paths == [
        ("train.step", "train.loss", "cg.run", "cg.update"),
        ("train.step", "train.loss", "cg.run", "prec", "prec.restrict"),
        ("train.step", "train.loss", "cg.run", "prec"),
        ("train.step", "train.backward", "solve.adjoint"),  # its own thread's span
        ("train.step", "train.backward"),  # none on its thread: the waiting thread's
        (),
        (),
    ]


def test_tool_attributes_by_the_launching_thread():
    """A span open on another thread at the launch does not take a kernel
    whose own thread has one open, even when it started later."""
    ops = OPS + [("cg.check", 3, 53, 60, 14, 0)]
    assert trace.by_span(ops, KERNELS)[3] == ("train.step", "train.backward", "solve.adjoint")


def test_tool_labels_idle_gaps_by_span():
    idle = trace.span_idle(OPS, KERNELS)
    # gaps 9-15 (middle 12: prec opens at 12, not before), 18-20 (19: prec),
    # 21-57 (39: cg.run closed at 30, train.loss open), 60-77 (68.5:
    # solve.adjoint), 78-122 (100: train.step closes at 100), 123-124
    assert idle == {"cg.run": 6, "prec": 2, "train.loss": 36, "solve.adjoint": 17,
                    "(none)": 45}


def test_tool_span_table_sums_a_step():
    table, layers = trace.span_table(KERNELS, trace.by_span(OPS, KERNELS), steps=2)
    assert table["prec"] == {"self_ms": 0.0005, "total_ms": 0.002, "launches": 0.5}
    assert table["(none)"] == {"self_ms": 0.001, "total_ms": 0.001, "launches": 1.0}
    # the restrict's 3 us; cg.update's 1 us; outside solve.*: all but the
    # adjoint's 3 us of 11 us; 2 us of 11 in no span
    assert layers == {"transfer_ms": 0.0015, "cg_vector_ms": 0.0005,
                      "outside_solve_ms": 0.004, "no_span_share": 2 / 11}
