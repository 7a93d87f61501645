"""Profile the PyTorch port's scaled work on one GPU. ``--config``:

- ``160x80`` (default): one step-1 training step on Cook's membrane 160x80
  (26,082 dofs), batch 64 x 4 posterior samples = 256 full-order solves
  through the two-level observation operator (float32 CG + one refinement,
  float64 residuals unless --split-f32), the ELBO's adjoint and one Adam
  update;
- ``box3d``: the same step on the 3-D trainer's 32x8x8 hex8 cantilever
  (8,019 dofs, examples/train_scaled_3d_torch.py: box two-level solver,
  input standardization, per-sample pairing);
- ``box3d_fh``: one batch of 256 observation-operator solves on the 64x16x16
  box (56,355 dofs; float32 CG at tol 3e-3 + two float64 refinements);
- ``element_fh`` and ``stencil_fh``: one batch of 256 observation-operator
  solves on Cook's 160x80 through the two-level solver's element path
  (the element kernel, gather transfers) or its stencil path (float32 CG
  at tol 3e-3 + one refinement), as chip_smoke.py times them.

Prints the card's name and power limit, the untraced step time, and from a
``torch.profiler`` trace of --steps steps: device time by kernel family,
device-busy time (the union of kernel intervals) and the device-idle share
of the traced wall time. Writes the Chrome trace to --trace.

    python tools/profile_scaled_torch.py --steps 3 --trace scaled_step_trace.json
    python tools/profile_scaled_torch.py --config box3d --steps 3
    python tools/profile_scaled_torch.py --config element_fh --steps 2
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
del _os, _sys
import argparse
import collections
import dataclasses
import json
import time

import numpy as np

FAMILIES = (  # (family, substrings of the kernel name), first match wins
    ("element kernel", ("element_affine_kernel",)),
    ("stencil3d kernel", ("stencil3d_affine_kernel",)),
    ("stencil kernel", ("stencil_affine_kernel",)),
    ("spectral kernel", ("spectral_apply_kernel",)),
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


def busy_us(intervals):
    """Length of the union of [start, end) intervals, in microseconds."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


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
    return lambda: trainer.update_step1(net, opt, y, e)


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
    return make_fh_fun(model, cfg, solve_free=solve), cfg


def box3d_step(torch, dev, residual):
    """One step-1 step of the 3-D trainer at 32x8x8 (coarse 16x4x4)."""
    from vbicm_tpu_torch.config import TrainConfig
    from vbicm_tpu_torch.vi.train import TwoStepTrainer

    fh, cfg = _box3d(torch, dev, (32, 8, 8), 2, residual, 1, 400, tip_force=(0.0, 0.0, -0.02))
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
    return lambda: trainer.update_step1(net, opt, y, e)


def box3d_fh(torch, dev, residual):
    """One batch of 256 observation-operator solves at 64x16x16 (coarse
    16x4x4, ratio 4, lx = 4), as chip_smoke.py times it."""
    fh, _ = _box3d(torch, dev, (64, 16, 16), 4, residual, 2, 1500, lx=4.0)
    thetas = torch.as_tensor(np.random.default_rng(5).normal(size=(256, 2)), device=dev)

    def step():
        with torch.no_grad():
            return fh(thetas)[1].sum()

    return step


def cooks_fh(torch, dev, residual, use_stencil):
    """One batch of 256 observation-operator solves at Cook's 160x80
    (coarse 40x20) through the two-level solver's element or stencil
    path."""
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
    fh = make_fh_fun(model, cfg, solve_free=solve)
    thetas = torch.as_tensor(np.random.default_rng(5).normal(size=(256, 2)), device=dev)

    def step():
        with torch.no_grad():
            return fh(thetas)[1].sum()

    return step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--config", choices=("160x80", "box3d", "box3d_fh", "element_fh",
                                         "stencil_fh"), default="160x80")
    ap.add_argument("--split-f32", action="store_true")
    ap.add_argument("--trace", type=str, default=None)
    args = ap.parse_args()

    import torch

    from vbicm_tpu_torch.utils.timing import card_line, profile_trace

    if not torch.cuda.is_available():
        raise SystemExit("no GPU is available (torch.cuda.is_available() is False)")
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    residual = "split_f32" if args.split_f32 else "f64"
    make = {"160x80": cooks_step, "box3d": box3d_step, "box3d_fh": box3d_fh,
            "element_fh": lambda *a: cooks_fh(*a, use_stencil=False),
            "stencil_fh": lambda *a: cooks_fh(*a, use_stencil=True)}[args.config]
    step = make(torch, dev, residual)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    for _ in range(args.steps):
        loss = step()
    float(loss)
    untraced = (time.perf_counter() - tic) / args.steps
    print(f"untraced step: {untraced * 1e3:.1f} ms ({1 / untraced:.3f} steps/s)", flush=True)

    with profile_trace(args.trace) as prof:
        torch.cuda.synchronize()
        tic = time.perf_counter()
        for _ in range(args.steps):
            loss = step()
        float(loss)
        wall = time.perf_counter() - tic
    # device-side events, less the user annotations the profiler mirrors onto
    # the device timeline (e.g. "Optimizer.step#Adam.step")
    kernels = [ev for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and not ev.is_user_annotation]
    by_family = collections.defaultdict(lambda: [0.0, 0])
    for ev in kernels:
        fam = by_family[family(ev.name)]
        fam[0] += ev.time_range.elapsed_us()
        fam[1] += 1
    busy = busy_us([(ev.time_range.start, ev.time_range.end) for ev in kernels]) / 1e6
    total = sum(v[0] for v in by_family.values()) / 1e6
    print(json.dumps({
        "card": card, "config": args.config, "steps": args.steps, "residual": residual,
        "traced_wall_s": wall, "untraced_step_s": untraced,
        "device_ops": len(kernels), "device_busy_s": busy,
        "device_idle_share": 1.0 - busy / wall,
        "kernel_time_s": total,
        "by_family": {k: {"s": v[0] / 1e6, "share": v[0] / 1e6 / total, "count": v[1]}
                      for k, v in sorted(by_family.items(), key=lambda kv: -kv[1][0])},
    }, indent=1), flush=True)
    top = collections.defaultdict(float)
    for ev in kernels:
        top[ev.name[:90]] += ev.time_range.elapsed_us()
    for name, us in sorted(top.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {us / 1e3:9.2f} ms  {name}")


if __name__ == "__main__":
    main()
