"""The cells' generators, windows and checks, one runner a traffic ``kind``.

Every runner builds the port's objects from the configuration, makes its
inputs from the seed, warms the cell's own shapes, runs the measured
window as a closed loop (one step or call after another) for the given
seconds, reads the device peak, frees the port's state, and then holds
what the window produced to the plain reference (``portbench.reference``).

- ``train``: ``TwoStepTrainer.update_step1`` on minibatches of a dataset
  that ``generate_data_fem`` makes at set-up, reshuffled each epoch. The
  reference follows the first steps, run in set-up from the seed's
  weights, and takes up steps of the window drawn from the seed (one that
  starts an epoch) from the program's state before each. Beside each
  worst leaf's gap it reads the median leaf's (``<leaf gap>_median``), and
  the checked steps' fh answers lane by lane (``fh_y_gap``); a cell's
  limits say which of them it holds.
- ``datagen``: repeated ``generate_data_fem`` calls; the reference redoes a
  sample of their chunks.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..count import work
from ..reference import fem, fem_box, vi
from . import system
from .trace import Profiled, span

# leaves whose reference gradient is under this share of the median leaf's
# move under Adam by round-off alone, and are left out of the change
FLAT_LEAF = 1e-3
# the plain reference of each problem (``system.problem_kind``)
REFERENCES = {"cooks_membrane": fem, "beam_hex8": fem_box}
# rows a block of the reference's redraw of a whole dataset
REF_ROWS = 500


def sub_seed(seed: int, k: int) -> int:
    """An independent 63-bit seed for the k-th use of the run's seed."""
    return int(np.random.SeedSequence([seed % 2**64, k]).generate_state(1, np.uint64)[0] >> 1)


@dataclasses.dataclass
class Record:
    """What a run produced, before it is formatted."""

    attempted: int
    failed: int
    setup_s: float
    e2e: Dict[str, float]
    checks: Dict[str, float]
    memory_peak_bytes: int = 0
    trace: Optional[object] = None  # Trace of the profiled stretch, device alone
    labelled: Optional[object] = None  # Trace of one unit with the host's events
    ctx: Optional[object] = None  # what the per-layer readers read
    notes: Dict[str, object] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads: the profiled stretch's trace, its
    units (train steps, datagen chunks) and their device or host time, the counted work of those units, the peaks, and the CG
    counts of their solves."""

    trace: object
    units: int
    units_s: float
    works: List[work.Work]
    peaks: Optional[dict]
    cg_solves: List[list]


def verdict(rec: Record, limits: dict):
    """(correct, {name: {"value", "limit"}}): correct when no unit failed and
    every number with a limit is finite and within it (a limit of None is a
    reading kept but not held)."""
    checks = {name: {"value": value, "limit": limits.get(name)}
              for name, value in rec.checks.items()}
    correct = rec.failed == 0 and all(
        c["limit"] is None or (math.isfinite(c["value"]) and c["value"] <= c["limit"])
        for c in checks.values())
    return correct, checks


class Clock:
    """Timestamps after each unit: CUDA events on a CUDA device (no sync a
    unit), the host clock elsewhere."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks = []

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def seconds(self) -> np.ndarray:
        """Each mark's time after the first, once the device is done."""
        self.sync()
        if self.cuda:
            return np.array([self.marks[0].elapsed_time(m) / 1e3 for m in self.marks])
        return np.array(self.marks) - self.marks[0]


class _Stages:
    """Seconds from the process's start at each named point of set-up, for
    the result's notes."""

    def __init__(self, t_start):
        self.t_start, self.marks = t_start, {}

    def __call__(self, name):
        self.marks[name] = round(time.perf_counter() - self.t_start, 3)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _peak(device) -> int:
    return int(torch.cuda.max_memory_allocated()) if torch.device(device).type == "cuda" else 0


def _free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _rel_gap(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))) / np.max(np.abs(np.asarray(b))))


def _leaf_gap(prog, ref, keep=None, reduce=np.max) -> float:
    """The worst leaf's gap of norms, | |p| - |r| |, over the larger of the
    reference leaf's norm and the median reference leaf's (with ``reduce =
    np.median`` the median leaf's)."""
    pn = np.array([float(torch.linalg.vector_norm(p.double())) for p in prog])
    rn = np.array([float(torch.linalg.vector_norm(r.double())) for r in ref])
    keep = np.ones(len(rn), bool) if keep is None else keep
    scale = np.maximum(rn, np.median(rn[keep]))
    return float(reduce((np.abs(pn - rn) / scale)[keep]))


class _FhTap:
    """An fh that keeps the (thetas, y) of its calls while ``on``: the
    answers of the checked steps, which ``fh_y_gap`` holds to the
    reference."""

    def __init__(self, fh):
        self.fh, self.on, self.calls = fh, False, []

    def __call__(self, thetas):
        y, h = self.fh(thetas)
        if self.on:
            self.calls.append((thetas.detach(), y.detach()))
        return y, h


def _draw_dataset_inputs(state, n, ne, config):
    """The draws ``generate_data_fem`` makes from a generator in ``state``,
    in its order: theta (n, 2), the y noise (n, d_y), the z noise, e (ne,
    2)."""
    g = torch.Generator()
    g.set_state(state)
    noise = config["noise"]
    theta = torch.randn((n, 2), generator=g, dtype=torch.float64)
    err = math.sqrt(noise["sig_e"]) * torch.randn((n, system.y_dim(config)), generator=g,
                                                  dtype=torch.float64)
    eta = math.sqrt(noise["sig_eta"]) * torch.randn((n, 2), generator=g, dtype=torch.float64)
    e = torch.randn((ne, 2), generator=g, dtype=torch.float64)
    return theta, err, eta, e


def _geometry(config, problem) -> work.TwoLevel:
    """The two-level shapes of the configuration's grid: 2 dofs a node on
    Cook's (ny, nx) cells, 3 on the box's (nz, ny, nx); the left (x = 0)
    end clamped on both."""
    m, r = config["mesh"], config["solver"]["coarse_ratio"]
    box = system.problem_kind(config) == "beam_hex8"
    cells = (m["nz"], m["ny"], m["nx"]) if box else (m["ny"], m["nx"])
    dofs = len(cells)  # a dof a direction
    coarse = [c // r + 1 for c in cells]
    return work.TwoLevel(ndof=dofs * math.prod(c + 1 for c in cells),
                         nnz_parts=problem.nnz_parts, cells_c=tuple(c // r for c in cells),
                         ratio=r, n_coarse=dofs * (math.prod(coarse) - math.prod(coarse[:-1])),
                         ndof_node=dofs)


def _solve_works(config, problem, solves, adjoint: bool):
    """The counted work of recorded two-level solves (their CG counts); with
    ``adjoint`` every second solve is a backward one and adds the
    coefficient cotangent."""
    g = _geometry(config, problem)
    out = []
    for k, runs in enumerate(solves):
        out += work.two_level_solve(g, runs)
        if adjoint and k % 2 == 1:
            out += work.two_level_coefficient_cotangent(g, len(runs[0]))
    return out


class _Batches:
    """Minibatches of n rows: each epoch a permutation from the generator
    (as the trainer draws it), its full batches in order."""

    def __init__(self, n, bs, generator, device):
        self.n, self.bs, self.g, self.device = n, bs, generator, device
        self.perm, self.b = None, n // bs

    def next(self):
        """(row indices, whether this batch starts an epoch)."""
        new = self.b == self.n // self.bs
        if new:
            self.perm = torch.randperm(self.n, generator=self.g).to(self.device)
            self.b = 0
        idx = self.perm[self.b * self.bs:(self.b + 1) * self.bs]
        self.b += 1
        return idx, new


@dataclasses.dataclass
class _Traced:
    device: object  # Trace of the first ``units`` units, device activity alone
    labelled: object  # Trace of the next unit, with the host's events
    units: int


def _window(seconds, unit, sync, trace, traffic, recorder=None):
    """Run ``unit()`` one after another for ``seconds`` (a closed loop).
    With ``trace`` the window starts with the profiled stretches: units for
    ``trace_seconds`` (at least one, at most ``trace_max_units``) with the
    device's activity alone, the CG counts recorded, then one unit with the
    host's events for the idle gaps' labels. Returns (units run, _Traced or
    None)."""
    done, traced = 0, None
    t0 = time.perf_counter()
    if trace:
        with Profiled(torch, sync, host=False) as p:
            if recorder is not None:
                recorder.on = True
            tp = time.perf_counter()
            while done == 0 or (time.perf_counter() - tp < traffic["trace_seconds"]
                                and done < traffic["trace_max_units"]):
                unit()
                done += 1
            if recorder is not None:
                recorder.on = False
        with Profiled(torch, sync, host=True) as q:
            unit()
        traced = _Traced(p.trace, q.trace, done)
        done += 1
    while time.perf_counter() - t0 < seconds:
        unit()
        done += 1
    return done, traced


def window_picks(traffic, batches_per_epoch, seed):
    """The window's steps (0 the first) that the reference takes up, drawn
    from the seed in ``traffic["window_checks"]`` = [from, to): one that
    starts an epoch, where the range holds one, and one other. None lies in
    the profiled stretch of a traced run."""
    lo, hi = traffic["window_checks"]
    lo = max(lo, traffic["trace_max_units"] + 1)
    rng = np.random.default_rng(sub_seed(seed, 7))
    starts = [w for w in range(lo, hi)
              if (traffic["checked_steps"] + w) % batches_per_epoch == 0]
    first = int(rng.choice(starts)) if starts else lo
    other = int(rng.choice([w for w in range(lo, hi) if w != first]))
    return sorted((first, other))


def _adam_state(net, opt):
    """Device copies of the parameters and of Adam's moments and step count
    (zeros before Adam's first step), taken without a sync."""
    params = [p.detach().clone() for p in net.parameters()]
    m, v, t = [], [], []
    for p in net.parameters():
        st = opt.state.get(p, {})
        m.append(st["exp_avg"].clone() if "exp_avg" in st else torch.zeros_like(p))
        v.append(st["exp_avg_sq"].clone() if "exp_avg_sq" in st else torch.zeros_like(p))
        t.append(st["step"].clone() if "step" in st else torch.zeros(()))
    return params, m, v, t


def _host(state):
    params, m, v, t = state
    return ([p.cpu() for p in params], [x.cpu() for x in m], [x.cpu() for x in v],
            int(max(float(x) for x in t)))


def train(cell, seed, seconds, trace, device, t_start, peaks=None, overrides=None) -> Record:
    from vbicm_tpu_torch.prob.datagen import generate_data_fem

    cfg, tr = system.merged(cell.config, overrides), cell.traffic
    noise, net_cfg = cfg["noise"], cfg["net"]
    stage = _Stages(t_start)
    stage("runner")
    fh, solver = system.build_fh(cfg, device)
    recorder = system.SolveRecorder(solver)
    dtype = system.DTYPES[net_cfg["dtype"]]
    d_y = system.y_dim(cfg)
    stage("built")

    g_data = torch.Generator().manual_seed(sub_seed(seed, 1))
    data_state = g_data.get_state()
    ds = generate_data_fem(g_data, fh, n_sam=cfg["n_data"], ne_sam=tr["ne"], device=device,
                           d_y=d_y, sig_e=noise["sig_e"], sig_eta=noise["sig_eta"],
                           chunk=tr["data_chunk"])
    y = torch.as_tensor(ds.y_data, dtype=dtype, device=device)
    e = torch.as_tensor(ds.e_data, dtype=dtype, device=device)
    tap = _FhTap(fh)  # keeps the checked steps' answers
    trainer = system.build_trainer(cfg, tr, tap, device,
                                   (ds.y_mean, ds.y_std) if cfg.get("y_norm") else None)
    stage("dataset")

    params0 = vi.glorot_params(torch.Generator().manual_seed(sub_seed(seed, 2)), d_y,
                               net_cfg["hidden"], net_cfg["layers"], 2, dtype)
    net = trainer.new_theta_net(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p, w in zip(net.parameters(), params0, strict=True):
            if p.shape != w.shape:
                raise ValueError(f"the port's net has a {tuple(p.shape)} leaf where the "
                                 f"configuration gives {tuple(w.shape)}")
            p.copy_(w)
    opt = trainer.optimizer_step1(net)
    batches = _Batches(cfg["n_data"], tr["batch"], torch.Generator().manual_seed(
        sub_seed(seed, 3)), device)

    # set-up: the first steps, through the window's own call, are the
    # reference's to follow
    checked_rows, checked_losses = [], []
    beta1 = cfg["adam"]["betas"][0]
    tap.on = True
    for k in range(tr["checked_steps"]):
        idx, _ = batches.next()
        checked_rows.append(idx.cpu())
        checked_losses.append(trainer.update_step1(net, opt, y[idx], e))
        if k == 0:
            stage("first_step")
            # the first gradient as Adam got it; none if it never stepped
            first_grads = [opt.state[p].get("exp_avg", torch.zeros_like(p)).detach().cpu()
                           / (1 - beta1) for p in net.parameters()]
    params_after = [p.detach().cpu().clone() for p in net.parameters()]
    checked_losses = [float(v) for v in checked_losses]
    _sync(device)
    setup_s = time.perf_counter() - t_start

    clock = Clock(device)
    losses = []
    picks = window_picks(tr, cfg["n_data"] // tr["batch"], seed)
    taken = {}  # window step -> (rows, state before, state after)

    def step():
        w = len(losses)
        idx, new_epoch = batches.next()
        if new_epoch and losses:
            with span(torch, "portbench.epoch_loss_read"):
                float(losses[-1])  # the trainer reads the epoch's last loss
        before = _adam_state(net, opt) if w in picks else None
        tap.on = before is not None
        with span(torch, "portbench.train_step"):
            losses.append(trainer.update_step1(net, opt, y[idx], e))
        if before is not None:
            taken[w] = (idx, before, _adam_state(net, opt))
        clock.mark()

    clock.mark()
    steps, traced = _window(seconds, step, clock.sync, trace, tr, recorder)
    marks = clock.seconds()
    step_s = np.diff(marks)
    losses = torch.stack(losses).cpu() if losses else torch.zeros(0)
    taken = {w: (idx.cpu(), _host(a), _host(b)) for w, (idx, a, b) in taken.items()}
    peak = _peak(device)
    nonfinite = int((~torch.isfinite(losses)).sum())
    rec_solves = recorder.counts()
    answers = [(t.cpu(), a.cpu()) for t, a in tap.calls]
    del trainer, net, opt, fh, solver, recorder, y, e, ds, batches, step, tap
    _free()

    t_check = time.perf_counter()
    ref = REFERENCES[system.problem_kind(cfg)]
    problem = ref.build_problem(cfg, device)
    ref_solver = ref.Solver(problem, torch.float64)
    theta, err, _, e_ref = _draw_dataset_inputs(data_state, cfg["n_data"], tr["ne"], cfg)

    def ref_y(idx):
        f, _ = ref.observe(problem, ref_solver, theta[idx].to(device), with_h=False)
        return f.detach() + err[idx].to(device)

    def moving(grads):
        gn = np.array([float(torch.linalg.vector_norm(g)) for g in grads])
        return gn >= FLAT_LEAF * np.median(gn)

    y_norm = None
    if cfg.get("y_norm"):
        # the moments of the reference's own redraw of the whole dataset
        y_all = torch.cat([ref_y(torch.arange(i, min(i + REF_ROWS, cfg["n_data"])))
                           for i in range(0, cfg["n_data"], REF_ROWS)])
        y_norm = (y_all.mean(0), y_all.std(0, correction=0))
        del y_all

    def follow(params, batches, state=None):
        return vi.follow_steps(problem, ref_solver, params, batches, e_ref, cfg, state=state,
                               observe=ref.observe, y_norm=y_norm)

    def leaf_gaps(name, prog, ref_leaves, keep=None):
        """The worst leaf's gap and the median leaf's (``<name>_median``)."""
        return {name: _leaf_gap(prog, ref_leaves, keep),
                name + "_median": _leaf_gap(prog, ref_leaves, keep, np.median)}

    ref_losses, ref_grads, ref_params = follow(params0, [ref_y(idx) for idx in checked_rows])
    keep = moving(ref_grads)
    checks = {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(checked_losses, ref_losses)),
        **leaf_gaps("grad_gap", first_grads, ref_grads),
        **leaf_gaps("change_gap", [a - b for a, b in zip(params_after, params0)],
                    [a.cpu() - b for a, b in zip(ref_params, params0)], keep),
    }
    # the window's steps, each from the program's state before it: its loss,
    # its gradient as Adam took it (from the first moment before and after)
    # and its change; a step the window did not reach reads nan
    window = {k: [] for k in ("window_loss_gap", "window_grad_gap", "window_grad_gap_median",
                              "window_step_gap", "window_step_gap_median")}
    left_out = int((~keep).sum())
    for w in picks:
        if w not in taken:
            for v in window.values():
                v.append(float("nan"))
            continue
        idx, (p0, m0, v0, t0), (p1, m1, _, _) = taken[w]
        (loss_r,), grads_r, p1_r = follow(p0, [ref_y(idx)], state=(m0, v0, t0))
        grads_p = [(a - beta1 * b) / (1 - beta1) for a, b in zip(m1, m0)]
        keep_w = moving(grads_r)
        left_out += int((~keep_w).sum())
        gaps = {"window_loss_gap": abs(float(losses[w]) - loss_r) / abs(loss_r),
                **leaf_gaps("window_grad_gap", grads_p, [g.cpu() for g in grads_r]),
                **leaf_gaps("window_step_gap", [a - b for a, b in zip(p1, p0)],
                            [a.cpu() - b for a, b in zip(p1_r, p0)], keep_w)}
        for k, v in gaps.items():
            window[k].append(v)
    checks.update({k: max(v) if not any(map(math.isnan, v)) else float("nan")
                   for k, v in window.items()})
    # the checked steps' answers of fh, lane by lane: the worst lane's
    # largest gap over its largest displacement
    gaps = []
    with torch.no_grad():
        for thetas, y_p in answers:
            y_r = ref.observe(problem, ref_solver, thetas.to(device), with_h=False)[0].cpu()
            gaps.append(float(((y_p - y_r).abs().amax(1) / y_r.abs().amax(1)).max()))
    checks["fh_y_gap"] = max(gaps)
    e2e = {} if steps == 0 else {
        "train_steps_per_s": steps / marks[-1],
        "train_step_p90_ms": float(np.percentile(step_s, 90)) * 1e3}
    rec = Record(attempted=steps, failed=nonfinite, setup_s=setup_s, e2e=e2e, checks=checks,
                 memory_peak_bytes=peak,
                 notes={"steps": steps, "window_steps_checked": sorted(taken),
                        "leaves_left_out": left_out, "setup_stages_s": stage.marks,
                        "check_s": round(time.perf_counter() - t_check, 3)})
    if traced is not None:
        rec.trace, rec.labelled = traced.device, traced.labelled
        rec.ctx = Context(trace=traced.device, units=traced.units,
                          units_s=traced.device.window_s,
                          works=_solve_works(cfg, problem, rec_solves, adjoint=True),
                          peaks=peaks, cg_solves=rec_solves)
    return rec


def datagen(cell, seed, seconds, trace, device, t_start, peaks=None, overrides=None) -> Record:
    from vbicm_tpu_torch.prob.datagen import generate_data_fem

    cfg, tr = system.merged(cell.config, overrides), cell.traffic
    noise = cfg["noise"]
    stage = _Stages(t_start)
    stage("runner")
    fh, solver = system.build_fh(cfg, device)
    recorder = system.SolveRecorder(solver)
    n, chunk, ne = tr["n_sam"], tr["chunk"], tr["ne"]
    stage("built")

    d_y = system.y_dim(cfg)

    def call(gen):
        return generate_data_fem(gen, fh, n_sam=n, ne_sam=ne, device=device, d_y=d_y,
                                 sig_e=noise["sig_e"], sig_eta=noise["sig_eta"], chunk=chunk)

    generate_data_fem(torch.Generator().manual_seed(sub_seed(seed, 9)), fh, n_sam=chunk,
                      ne_sam=ne, device=device, d_y=d_y, sig_e=noise["sig_e"],
                      sig_eta=noise["sig_eta"], chunk=chunk)
    _sync(device)
    setup_s = time.perf_counter() - t_start

    gen = torch.Generator().manual_seed(sub_seed(seed, 1))
    calls = []

    def unit():
        state = gen.get_state()
        with span(torch, "portbench.datagen_call"):
            ds = call(gen)
        calls.append((state, ds.y_data, ds.z_data))

    t0 = time.perf_counter()
    _, traced = _window(seconds, unit, lambda: _sync(device), trace, tr, recorder)
    elapsed = time.perf_counter() - t0
    peak = _peak(device)
    rec_solves = recorder.counts()
    del fh, solver, recorder, call, unit
    _free()
    ys = np.stack([c[1] for c in calls])
    zs = np.stack([c[2] for c in calls])
    bad = int((~np.isfinite(ys).all(-1) | ~np.isfinite(zs).all(-1)).sum())

    t_check = time.perf_counter()
    ref = REFERENCES[system.problem_kind(cfg)]
    problem = ref.build_problem(cfg, device)
    ref_solver = ref.Solver(problem, torch.float64)
    rng = np.random.default_rng(sub_seed(seed, 4))
    n_chunks = -(-n // chunk)
    picks = rng.choice(len(calls) * n_chunks, size=min(tr["checked_chunks"],
                                                       len(calls) * n_chunks), replace=False)
    f_p, f_r, h_p, h_r = [], [], [], []
    for pick in sorted(picks):
        k, j = divmod(int(pick), n_chunks)
        state, y_p, z_p = calls[k]
        theta, err, eta, _ = _draw_dataset_inputs(state, n, ne, cfg)
        rows = slice(j * chunk, min(n, (j + 1) * chunk))
        y_r, hh = ref.observe(problem, ref_solver, theta[rows].to(device))
        y_r, hh = y_r.cpu().numpy(), hh.cpu().numpy()
        f_p.append(y_p[rows] - err[rows].numpy())
        f_r.append(y_r)
        z_r = hh + eta[rows].numpy()
        keep = z_r > 0  # where the noise drove z below 0 the port clamps it
        h_p.append((z_p[rows] - eta[rows].numpy())[keep])
        h_r.append(hh[keep])
    checks = {"y_gap": _rel_gap(np.concatenate(f_p), np.concatenate(f_r)),
              "h_gap": _rel_gap(np.concatenate(h_p), np.concatenate(h_r))}
    rec = Record(attempted=len(calls) * n, failed=bad, setup_s=setup_s,
                 e2e={"fh_solves_per_s": len(calls) * n / elapsed}, checks=checks,
                 memory_peak_bytes=peak,
                 notes={"calls": len(calls), "setup_stages_s": stage.marks,
                        "check_s": round(time.perf_counter() - t_check, 3)})
    if traced is not None:
        rec.trace, rec.labelled = traced.device, traced.labelled
        rec.ctx = Context(trace=traced.device, units=traced.units * n_chunks,
                          units_s=traced.device.window_s,
                          works=_solve_works(cfg, problem, rec_solves, adjoint=False),
                          peaks=peaks, cg_solves=rec_solves)
    return rec


RUNNERS = {"train": train, "datagen": datagen}
