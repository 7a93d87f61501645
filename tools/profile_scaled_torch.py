"""Profile the PyTorch port's scaled work on one GPU. ``--config``:

- ``160x80`` (default): one step-1 training step on Cook's membrane 160x80
  (26,082 dofs), batch 64 x 4 posterior samples = 256 full-order solves
  through the two-level observation operator (float32 CG + one refinement,
  float64 residuals unless --split-f32), the ELBO's adjoint and one Adam
  update;
- ``box3d``: the same step on the 3-D trainer's 32x8x8 hex8 cantilever
  (8,019 dofs, examples/train_scaled_3d_torch.py: box two-level solver,
  input standardization, per-sample pairing);
- ``box3d_fh``: one batch of --batch (256) observation-operator solves on the
  64x16x16 box (56,355 dofs; float32 CG at tol 3e-3 + two float64 refinements);
- ``element_fh`` and ``stencil_fh``: one batch of --batch (256) observation-operator
  solves on Cook's 160x80 through the two-level solver's element path
  (the element kernel, gather transfers) or its stencil path (float32 CG
  at tol 3e-3 + one refinement), as chip_smoke.py times them;
- ``datagen``: one ``generate_data_fem`` call through the stencil path, 10
  chunks of --batch (256) prior draws, as the benchmark's datagen cell
  makes them;
- ``field_fh`` and ``field3d_fh``: one batch of --batch (256) random-field
  observation-operator solves, examples/train_randomfield_torch.py's 80x40
  (16 KL modes) and examples/train_randomfield_3d_torch.py's 32x8x8 (12
  modes): the field solver in grid mode, the mean-field two-level cycle,
  float32 CG at tol 3e-3 + one refinement.

Prints the card's name and power limit, the untraced step time with the
program's spans off and on (``utils.trace``; --repeats alternating runs of
--steps steps each), and from a ``torch.profiler`` trace of --steps steps,
spans on: device time by kernel family, device-busy time (the union of
kernel intervals), the device-idle share of the traced wall time, and
device time and launches a step by program span (each kernel given to the
innermost span open around its launch, ``utils.trace.by_span``), the idle
time by the span open at each gap, the batched CG's loop steps and lane use
(``ops.solve.pcg_loop``, from the lanes' iterations) and the host's reads
(the CG's checks, and the counted ones). Writes the Chrome trace to --trace.

    python tools/profile_scaled_torch.py --steps 3 --trace scaled_step_trace.json
    python tools/profile_scaled_torch.py --steps 12 --repeats 6
    python tools/profile_scaled_torch.py --config box3d --steps 3
    python tools/profile_scaled_torch.py --config element_fh --steps 2
    python tools/profile_scaled_torch.py --config box3d_fh --batch 64 --steps 3
    python tools/profile_scaled_torch.py --config field_fh --steps 2
    python tools/profile_scaled_torch.py --config datagen --steps 2
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
del _os, _sys
import argparse
import collections
import contextlib
import dataclasses
import json
import os
import statistics
import sys
import time

import numpy as np

FAMILIES = (  # (family, substrings of the kernel name), first match wins
    ("element kernel", ("element_affine",)),
    ("stencil3d kernel", ("stencil3d_affine_kernel",)),
    ("stencil kernel", ("stencil_affine_kernel",)),
    ("spectral kernel", ("spectral_apply_kernel", "spectral_combine_kernel")),
    ("transfer kernel", ("hat_prolong_kernel", "hat_restrict_kernel", "hat_prolong_prec_kernel",
                         "hat_restrict_prec_kernel")),
    ("CG update kernel", ("cg_alpha_step_kernel", "cg_beta_step_kernel")),
    ("cuBLAS GEMM", ("gemm", "gemv", "cutlass", "xmma", "Kernel2")),
    ("reduction", ("reduce",)),
    ("index/scatter/gather", ("index", "scatter", "gather")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "where", "fill")),
    ("copy", ("copy", "Memcpy", "Memset", "memcpy", "memset")),
)


def family(name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other"


def kineto_events(prof, torch):
    """(ops, kernels) of a finished ``torch.profiler`` run in the form of
    ``utils.trace.by_span``, times in microseconds; the device's copies of
    the spans left out."""
    ops, kernels = [], []
    for ev in prof.profiler.kineto_results.events():
        t0 = ev.start_ns() / 1e3
        t1 = t0 + ev.duration_ns() / 1e3
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if not ev.is_user_annotation():
                kernels.append((ev.name(), t0, t1, ev.correlation_id(),
                                ev.linked_correlation_id()))
        elif ev.device_type() == torch.autograd.DeviceType.CPU:
            ops.append((ev.name(), ev.start_thread_id(), t0, t1, ev.correlation_id(),
                        ev.linked_correlation_id()))
    return ops, kernels


def cooks_step(torch, dev, residual):
    """One step-1 step at Cook's 160x80 (coarse 40x20)."""
    from vbicm_tpu_torch.config import ProblemConfig, TrainConfig
    from vbicm_tpu_torch.mesh import cooks_membrane_mesh
    from vbicm_tpu_torch.model import build_fem_model
    from vbicm_tpu_torch.solver import make_fh_fun, make_two_level_solver
    from vbicm_tpu_torch.vi.train import TwoStepTrainer

    nx, ny = 160, 80
    model = build_fem_model(cooks_membrane_mesh(nx, ny), device=dev, dense=False)
    coarse = build_fem_model(cooks_membrane_mesh(nx // 4, ny // 4), device=dev, dense=True)
    cfg = dataclasses.replace(ProblemConfig(), node_id=model.nnodes, ele_id=(ny // 2) * nx + 12)
    solve = make_two_level_solver(model, coarse, nx // 4, ny // 4, 4, cg_dtype=torch.float32,
                                  refine_iters=1, tol=3e-3, maxiter=400, use_stencil=True,
                                  refine_residual=residual)
    fh = make_fh_fun(model, cfg, solve_free=solve)
    trainer = TwoStepTrainer(None, cfg, TrainConfig(), fh_batch=fh, device=dev)
    net = trainer.new_theta_net(torch.Generator().manual_seed(0))
    opt = trainer.optimizer_step1(net)
    rng = np.random.default_rng(0)
    y = torch.as_tensor(rng.normal(size=(64, 2)) * 0.3 + np.array([-4.4, 5.8]), device=dev)
    e = torch.as_tensor(rng.normal(size=(4, 2)), device=dev)
    return lambda: trainer.update_step1(net, opt, y, e), solve.solver


def _box3d(torch, dev, cells, ratio, residual, refine_iters, maxiter, **mesh_kw):
    """The 3-D trainer's box, its observation operator and probe config."""
    from vbicm_tpu_torch.config import ProblemConfig, SectionCard
    from vbicm_tpu_torch.mesh import beam_hex8_mesh
    from vbicm_tpu_torch.model import build_fem_model
    from vbicm_tpu_torch.solver import make_fh_fun, make_two_level_solver_box3d

    sec = SectionCard(stype=4)
    nx, ny, nz = cells
    model = build_fem_model(beam_hex8_mesh(*cells, **mesh_kw), sec, device=dev, dense=False)
    cells_c = tuple(c // ratio for c in cells)
    coarse = build_fem_model(beam_hex8_mesh(*cells_c, **mesh_kw), sec, device=dev, dense=True)
    solve = make_two_level_solver_box3d(model, coarse, cells_c, ratio, cg_dtype=torch.float32,
                                        refine_iters=refine_iters, tol=3e-3, maxiter=maxiter,
                                        refine_residual=residual)
    cfg = dataclasses.replace(ProblemConfig(), y_dim=3, node_id=model.nnodes,
                              ele_id=((nz - 1) * ny + ny // 2) * nx + 2, nipt_id=(1, 5))
    return make_fh_fun(model, cfg, solve_free=solve), cfg, solve.solver


def box3d_step(torch, dev, residual):
    """One step-1 step of the 3-D trainer at 32x8x8 (coarse 16x4x4)."""
    from vbicm_tpu_torch.config import TrainConfig
    from vbicm_tpu_torch.vi.train import TwoStepTrainer

    fh, cfg, solver = _box3d(torch, dev, (32, 8, 8), 2, residual, 1, 400,
                             tip_force=(0.0, 0.0, -0.02))
    rng = np.random.default_rng(0)
    with torch.no_grad():
        y, _ = fh(torch.as_tensor(rng.normal(size=(64, 2)), device=dev))
    y = y + np.sqrt(cfg.sig_e) * torch.as_tensor(rng.normal(size=(64, 3)), device=dev)
    y_np = y.cpu().numpy()
    tcfg = TrainConfig(lr_decay_mode="fixed", pairing="per_sample")
    trainer = TwoStepTrainer(None, cfg, tcfg, fh_batch=fh, device=dev,
                             y_norm=(y_np.mean(0, keepdims=True), y_np.std(0, keepdims=True)))
    net = trainer.new_theta_net(torch.Generator().manual_seed(0))
    opt = trainer.optimizer_step1(net)
    e = torch.as_tensor(rng.normal(size=(4, 2)), device=dev)
    return lambda: trainer.update_step1(net, opt, y, e), solver


def box3d_fh(torch, dev, residual, batch):
    """One batch of observation-operator solves at 64x16x16 (coarse 16x4x4,
    ratio 4, lx = 4), as chip_smoke.py times it."""
    fh, _, solver = _box3d(torch, dev, (64, 16, 16), 4, residual, 2, 1500, lx=4.0)
    thetas = torch.as_tensor(np.random.default_rng(5).normal(size=(batch, 2)), device=dev)

    def step():
        with torch.no_grad():
            return fh(thetas)[1].sum()

    return step, solver


def _cooks_fh(torch, dev, residual, use_stencil):
    """The observation operator at Cook's 160x80 (coarse 40x20) through the
    two-level solver's element or stencil path, and its solver."""
    from vbicm_tpu_torch.config import ProblemConfig
    from vbicm_tpu_torch.mesh import cooks_membrane_mesh
    from vbicm_tpu_torch.model import build_fem_model
    from vbicm_tpu_torch.solver import make_fh_fun, make_two_level_solver

    nx, ny = 160, 80
    model = build_fem_model(cooks_membrane_mesh(nx, ny), device=dev, dense=False)
    coarse = build_fem_model(cooks_membrane_mesh(nx // 4, ny // 4), device=dev, dense=True)
    cfg = dataclasses.replace(ProblemConfig(), node_id=model.nnodes, ele_id=(ny // 2) * nx + 12)
    solve = make_two_level_solver(model, coarse, nx // 4, ny // 4, 4, cg_dtype=torch.float32,
                                  refine_iters=1, tol=3e-3, maxiter=400, use_stencil=use_stencil,
                                  refine_residual=residual)
    return make_fh_fun(model, cfg, solve_free=solve), solve.solver


def cooks_fh(torch, dev, residual, batch, use_stencil):
    """One batch of observation-operator solves at Cook's 160x80."""
    fh, solver = _cooks_fh(torch, dev, residual, use_stencil)
    thetas = torch.as_tensor(np.random.default_rng(5).normal(size=(batch, 2)), device=dev)

    def step():
        with torch.no_grad():
            return fh(thetas)[1].sum()

    return step, solver


def datagen_call(torch, dev, residual, batch):
    """One ``generate_data_fem`` call at Cook's 160x80 (stencil path): 10
    chunks of --batch prior draws, 4 base draws, as the benchmark's
    datagen cell makes them."""
    from vbicm_tpu_torch.prob.datagen import generate_data_fem

    fh, solver = _cooks_fh(torch, dev, residual, True)
    gen = torch.Generator().manual_seed(5)

    def step():
        ds = generate_data_fem(gen, fh, n_sam=10 * batch, ne_sam=4, device=dev, chunk=batch)
        return torch.as_tensor(ds.z_data).sum()

    return step, solver


def field_fh(torch, dev, batch, three_d):
    """One batch of the field examples' observation-operator solves at prior
    draws of theta."""
    import importlib.util

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(root, "examples"))
    name = "train_randomfield_3d_torch" if three_d else "train_randomfield_torch"
    spec = importlib.util.spec_from_file_location(name, os.path.join(root, "examples",
                                                                     name + ".py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    _, kl, _, _, fh = example.build(32, 8, 8, device=dev) if three_d else \
        example.build(80, 40, device=dev)
    thetas = torch.as_tensor(np.random.default_rng(5).normal(size=(batch, kl.n_modes)),
                             device=dev)

    def step():
        with torch.no_grad():
            return fh(thetas)[1].sum()

    return step, None  # the field solver is inside the example's fh


@contextlib.contextmanager
def lane_iterations(solver):
    """Yields a list that gathers the per-lane CG counts of every solve the
    solver makes in the block (``last_cg_iters``, device tensors)."""
    runs = []
    if solver is None:
        yield runs
        return
    solve_once = solver.solve_once

    def recorded(coeffs, b):
        x = solve_once(coeffs, b)
        runs.extend(solver.last_cg_iters)
        return x

    solver.solve_once = recorded
    try:
        yield runs
    finally:
        solver.solve_once = solve_once


def timed_steps(torch, step, steps):
    """Seconds a step over ``steps`` closed-loop steps, ending in a read."""
    torch.cuda.synchronize()
    tic = time.perf_counter()
    for _ in range(steps):
        loss = step()
    float(loss)
    return (time.perf_counter() - tic) / steps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--config", choices=("160x80", "box3d", "box3d_fh", "element_fh",
                                         "stencil_fh", "datagen", "field_fh", "field3d_fh"),
                    default="160x80")
    ap.add_argument("--split-f32", action="store_true")
    ap.add_argument("--batch", type=int, default=256,
                    help="solves a batch (the fh configs; datagen's chunk)")
    ap.add_argument("--repeats", type=int, default=1,
                    help="untraced runs of --steps steps with spans off, and as many on")
    ap.add_argument("--trace", type=str, default=None)
    args = ap.parse_args()

    import torch

    from vbicm_tpu_torch.ops.solve import pcg_lane_use, pcg_loop
    from vbicm_tpu_torch.utils import trace
    from vbicm_tpu_torch.utils.timing import card_line, profile_trace

    if not torch.cuda.is_available():
        raise SystemExit("no GPU is available (torch.cuda.is_available() is False)")
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    residual = "split_f32" if args.split_f32 else "f64"
    make = {"160x80": cooks_step, "box3d": box3d_step,
            "box3d_fh": lambda *a: box3d_fh(*a, args.batch),
            "element_fh": lambda *a: cooks_fh(*a, args.batch, use_stencil=False),
            "stencil_fh": lambda *a: cooks_fh(*a, args.batch, use_stencil=True),
            "datagen": lambda *a: datagen_call(*a, args.batch),
            "field_fh": lambda torch, dev, _: field_fh(torch, dev, args.batch, False),
            "field3d_fh": lambda torch, dev, _: field_fh(torch, dev, args.batch, True),
            }[args.config]
    step, solver = make(torch, dev, residual)

    for _ in range(2):
        step()
    untraced = {"off": [], "on": []}
    for r in range(args.repeats):  # alternating which goes first
        for mode in ("off", "on") if r % 2 == 0 else ("on", "off"):
            with trace.enabled(mode == "on"):
                untraced[mode].append(timed_steps(torch, step, args.steps))
    off, on = statistics.median(untraced["off"]), statistics.median(untraced["on"])
    print(f"untraced step: {off * 1e3:.1f} ms ({1 / off:.3f} steps/s); spans on "
          f"{on * 1e3:.1f} ms ({100 * (on / off - 1):+.2f} %)", flush=True)

    before = trace.counters()
    with lane_iterations(solver) as runs, profile_trace(args.trace) as prof:
        wall = timed_steps(torch, step, args.steps) * args.steps
    counts = {k: v - before.get(k, 0) for k, v in trace.counters().items()
              if v != before.get(k, 0)}
    ops, kernels = kineto_events(prof, torch)
    by_family = collections.defaultdict(lambda: [0.0, 0])
    for name, t0, t1, _, _ in kernels:
        fam = by_family[family(name)]
        fam[0] += t1 - t0
        fam[1] += 1
    busy = trace.busy_us([(k[1], k[2]) for k in kernels]) / 1e6
    total = sum(v[0] for v in by_family.values()) / 1e6
    paths = trace.by_span(ops, kernels)
    table, layers = trace.span_table(kernels, paths, args.steps)
    runs = [it.cpu() for it in runs]
    maxiter = solver.maxiter if solver is not None else None
    loops = [pcg_loop(it, maxiter) for it in runs]
    # the host's reads by site: the CG's checks from its loops, the rest counted
    reads = {"cg_check": sum(c for _, c in loops)}
    reads.update({k[len("host.sync."):]: v for k, v in counts.items()
                  if k.startswith("host.sync.")})
    print(json.dumps({
        "card": card, "config": args.config, "steps": args.steps, "residual": residual,
        "batch": args.batch if args.config.endswith("_fh") or args.config == "datagen" else None,
        "traced_wall_s": wall, "untraced_step_s": untraced["off"],
        "untraced_step_spans_on_s": untraced["on"],
        "device_ops": len(kernels), "device_busy_s": busy,
        "device_idle_share": 1.0 - busy / wall,
        "kernel_time_s": total,
        "by_family": {k: {"s": v[0] / 1e6, "share": v[0] / 1e6 / total, "count": v[1]}
                      for k, v in sorted(by_family.items(), key=lambda kv: -kv[1][0])},
        "by_span_a_step": table,
        "idle_by_span_ms_a_step": {k: v / 1e3 / args.steps for k, v in sorted(
            trace.span_idle(ops, kernels).items(), key=lambda kv: -kv[1])},
        "a_step": dict(layers, host_syncs=sum(reads.values()) / args.steps,
                       cg_steps=sum(s for s, _ in loops) / args.steps),
        "cg_lane_util": pcg_lane_use(runs, maxiter),
        "host_syncs_by_site": reads,
        "counters": counts,
    }, indent=1), flush=True)
    # the top kernels, each with the spans that launched it
    top = collections.defaultdict(lambda: collections.defaultdict(float))
    for (name, t0, t1, _, _), path in zip(kernels, paths):
        top[name[:90]][path[-1] if path else "(none)"] += t1 - t0
    for name, where in sorted(top.items(), key=lambda kv: -sum(kv[1].values()))[:12]:
        spans = ", ".join(f"{k} {v / 1e3:.2f}" for k, v in sorted(where.items(),
                                                                key=lambda kv: -kv[1]))
        print(f"  {sum(where.values()) / 1e3:9.2f} ms  {name}  [{spans}]")


if __name__ == "__main__":
    main()
