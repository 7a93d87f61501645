"""On-card smoke test of the PyTorch port (``vbicm_tpu_torch``) on one GPU.

Builds the CUDA kernels from the sources in this checkout and holds each
against its plain PyTorch version. Then two paths, each driven through the
entry points a user calls, with the kernels' launch counts set to 0 just
before and read just after:

- Cook's membrane 20x10 (phases 3-7): the spectral solve's adjoint, forward
  parity against the reference golden, the mixed-precision observation
  operator, dataset generation and the two-step VI trainer at the
  reference's widths (3x20 MLPs, 64 observations x 4 posterior samples per
  step, float32 apply plus one float64 refinement);
- the scaled configuration, Cook's membrane 160x80 (26,082 dofs; phases
  8-12): the stencil kernel, the two-level solve against the JAX package's
  float64 golden (tests/fixtures/scaled_160x80_golden.json), its adjoint
  against the dense solve at 40x20, and dataset generation and the two-step
  trainer through the two-level observation operator (float32 CG + one
  float64 refinement, 256 full-order solves per step-1 step);
- the 3-D hex8 box (phases 13-17): the 27-point stencil kernel on grids up
  to 64x16x16 (56,355 dofs), the box two-level solve against the JAX
  package's float64 golden (tests/fixtures/scaled_3d_golden.json) for the
  trainer's 32x8x8 cantilever and the 64x16x16 solve, its adjoint against
  the dense solve at 8x4x4, and dataset generation and the two-step trainer
  at 32x8x8 (8,019 dofs; float32 CG + one float64 refinement, input
  standardization, per-sample pairing).

Prints one line per phase, the card's name and power limit, a JSON line with
the kernels' records and, last, the ok line. Exits non-zero on any failure
and when no GPU is present.

    python3 chip_smoke.py
"""
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# (B, n): the 20x10 solve (n = 440), the 160x80 path's coarse solve (n = 1680
# free dofs of the 40x20 coarse mesh) and the 3-D path's (n = 1200 of the
# 16x4x4 coarse box: B = 256 in the step, 512 in data generation and the
# bridge)
SHAPES = [(256, 440), (4096, 440), (5, 440), (130, 130), (20, 200), (256, 1680), (4096, 1680),
          (256, 1200), (512, 1200)]
MAIN_SHAPE = (256, 440)  # one step-1 batch: 64 observations x 4 samples, 440 free dofs
COARSE_SHAPE = (256, 1680)
REL_TOL = {torch.float64: 1e-12, torch.float32: 2e-5}
STENCIL_GRIDS = [(8, 4), (32, 16), (160, 80)]
STENCIL_BATCHES = [1, 5, 256, 300]
STENCIL_MAIN = (160, 256)  # (nx, B) of the timed case: the step-1 batch at 160x80
# 3-D hex8 box grids (nx, ny, nz) of the kernel check; the trainer's grid
# (32x8x8) at B = 256 is the JSON line's case
BOX_GRIDS = [(4, 2, 2), (32, 8, 8), (64, 16, 16)]
BOX_MAIN = ((32, 8, 8), 256)
BOX_COARSE_SHAPE = (256, 1200)  # the 3-D coarse solve: 16x4x4, 1200 free dofs
BOX_FH_BATCHES = (64, 256)  # the timed 64x16x16 solves (bench.py's B, and B = 256)


def fail(msg):
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def pencil_problem(B, n, seed, dtype, device):
    """An orthonormal eigenbasis, positive eigenvalues and coefficients."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    g = np.abs(rng.normal(size=n)) + 0.1
    coeffs = np.abs(rng.normal(size=(B, 2))) + 1.0
    b = rng.normal(size=(B, n))
    return [torch.as_tensor(x, dtype=dtype, device=device).contiguous() for x in (Q, g, coeffs, b)]


def time_ms(fn, warmup=20, reps=200):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs a GPU",
              file=sys.stderr)
        sys.exit(2)

    from vbicm_tpu_torch import _build  # importing the package turns TF32 off
    from vbicm_tpu_torch.config import MaterialCard, ProblemConfig, TrainConfig
    from vbicm_tpu_torch.mesh import cooks_membrane_mesh
    from vbicm_tpu_torch.model import build_fem_model
    from vbicm_tpu_torch.ops.solve import make_spectral_affine_solver
    from vbicm_tpu_torch.ops.spectral_kernel import (
        spectral_apply_batched,
        spectral_apply_reference,
    )
    from vbicm_tpu_torch.prob.datagen import generate_data_fem
    from vbicm_tpu_torch.solver import fea_solution, make_fh_fun, probe_von_mises
    from vbicm_tpu_torch.vi.train import TwoStepTrainer

    dev = torch.device("cuda", 0)
    card = card_line()
    name = torch.cuda.get_device_name(0)

    # 1. card and build
    _, build_s, build_log = _build.load_library()
    ptxas = [ln.strip() for ln in build_log.splitlines() if "registers" in ln or "spill" in ln]
    print(f"[1 card] {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"kernel build {build_s:.2f}s; ptxas: {' | '.join(ptxas)}", flush=True)

    # 2. kernel against its plain version on the card
    worst = {}
    main_abs_err = None
    pencils = {}
    for dtype in (torch.float32, torch.float64):
        for B, n in SHAPES:
            if (B, n) not in pencils:
                pencils[B, n] = pencil_problem(B, n, seed=B + n, dtype=torch.float64, device=dev)
            V, g, c, b = (t.to(dtype) for t in pencils[B, n])
            x, a = spectral_apply_batched(V, g, c, b, return_coords=True)
            x_only = spectral_apply_batched(V, g, c, b)
            xr, ar = spectral_apply_reference(V, g, c, b, return_coords=True)
            torch.cuda.synchronize()
            errs = (rel_err(x, xr), rel_err(a, ar), rel_err(x_only, xr))
            if not max(errs) <= REL_TOL[dtype]:
                fail(f"kernel vs plain at B={B} n={n} {dtype}: rel err x/a/x-only {errs}")
            worst[str(dtype)] = max(worst.get(str(dtype), 0.0), *errs)
            if dtype == torch.float32 and (B, n) == MAIN_SHAPE:
                main_abs_err = float((x - xr).abs().max())
    print(f"[2 kernel] ok: max rel err vs plain f32 {worst['torch.float32']:.3e} (tol 2e-5), "
          f"f64 {worst['torch.float64']:.3e} (tol 1e-12) over (B, n) in {SHAPES}, x and a",
          flush=True)

    # 3. adjoint through the solver: kernel + custom backward against torch
    #    autograd through the plain version, f64, Cook's pencil
    model = build_fem_model(cooks_membrane_mesh(20, 10), device=dev, dtype=torch.float64)
    solver = make_spectral_affine_solver(torch.stack([model.k_lam_ff, model.k_mu_ff]))
    rng = np.random.default_rng(3)
    lam_mu = np.stack([rng.uniform(8.0, 16.0, 256), rng.uniform(6.0, 9.0, 256)], axis=1)
    c0 = torch.as_tensor(lam_mu, dtype=torch.float64, device=dev)
    f0 = torch.as_tensor(rng.normal(size=(256, model.nfree)), dtype=torch.float64, device=dev)
    w = torch.as_tensor(rng.normal(size=(256, model.nfree)), dtype=torch.float64, device=dev)
    grads = []
    for use_kernel in (True, False):
        c = c0.clone().requires_grad_(True)
        f = f0.clone().requires_grad_(True)
        x = solver(c, f) if use_kernel else spectral_apply_reference(solver.V, solver.g, c, f)
        grads.append(torch.autograd.grad((w * x).sum(), (c, f)))
    adj_err = (rel_err(grads[0][0], grads[1][0]), rel_err(grads[0][1], grads[1][1]))
    if not max(adj_err) <= 1e-10:
        fail(f"adjoint: rel err (coeffs, f) {adj_err} > 1e-10")
    print(f"[3 adjoint] ok: grad rel err coeffs {adj_err[0]:.3e}, f {adj_err[1]:.3e} (tol 1e-10)",
          flush=True)

    # 4. forward parity against the reference golden
    with open(os.path.join(ROOT, "tests", "fixtures", "reference_golden.json")) as fh_:
        gold = json.load(fh_)[0]
    mat = MaterialCard(E=gold["E"], v=gold["v"])
    sol = fea_solution(model, mat)
    vm = probe_von_mises(model, sol.u, torch.tensor(mat.lam, dtype=torch.float64, device=dev),
                         torch.tensor(mat.mu, dtype=torch.float64, device=dev), 12, (1, 3))
    u_err = float(np.abs(sol.u[460:462].cpu().numpy() - gold["u_node231"]).max())
    vm_err = float(np.abs(vm.cpu().numpy() - gold["vm_e12_q13"]).max())
    if not max(u_err, vm_err) <= 1e-9:
        fail(f"golden: u_node231 err {u_err}, vm_e12_q13 err {vm_err} > 1e-9")
    print(f"[4 golden] ok: u_node231 {sol.u[460:462].tolist()} err {u_err:.2e}, "
          f"vm_e12_q13 {vm.tolist()} err {vm_err:.2e} (tol 1e-9)", flush=True)

    # 5. observation operator: f32 apply + 1 refinement against the f64 apply
    cfg = ProblemConfig()
    fh64 = make_fh_fun(model, cfg)
    fh32 = make_fh_fun(model, cfg, factor_dtype=torch.float32, refine_iters=1)
    thetas = torch.randn((256, 2), generator=torch.Generator().manual_seed(5),
                         dtype=torch.float64).to(dev)
    with torch.no_grad():
        y64, h64 = fh64(thetas)
        y32, h32 = fh32(thetas)
    fh_err = (rel_err(y32, y64), rel_err(h32, h64))
    if not max(fh_err) <= 1e-9:
        fail(f"fh f32+1 refinement vs f64: rel err (y, h) {fh_err} > 1e-9")
    print(f"[5 fh] ok: f32 apply + 1 refinement vs f64, rel err y {fh_err[0]:.3e}, "
          f"h {fh_err[1]:.3e} (tol 1e-9), 256 thetas", flush=True)

    # 6. the main path: dataset generation and the two-step trainer
    tcfg = TrainConfig(batch_size=64, num_epoch1=3, num_epoch2=3)
    spectral_apply_batched.launches = 0
    ds = generate_data_fem(torch.Generator().manual_seed(0), fh32, n_sam=1024, ne_sam=4,
                           device=dev, sig_e=cfg.sig_e, sig_eta=cfg.sig_eta, chunk=4096)
    trainer = TwoStepTrainer(model, cfg, tcfg, factor_dtype=torch.float32, refine_iters=1)
    res = trainer.fit(ds.y_data, ds.e_data, torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    launches = spectral_apply_batched.launches
    preds = trainer.predict(res.theta_net, res.z_net, ds.y_data[:8])
    losses = np.concatenate([res.hist_step1, res.hist_step2])
    if not np.all(np.isfinite(losses)):
        fail(f"non-finite losses: step1 {res.hist_step1}, step2 {res.hist_step2}")
    if not all(p.shape == (8, 2) and bool(torch.isfinite(p).all()) for p in preds):
        fail("predict: outputs not finite (8, 2) tensors")
    if launches <= 0:
        fail("the trainer never launched the spectral kernel")
    print(f"[6 trainer] ok: step1 losses {res.hist_step1.tolist()}, step2 losses "
          f"{res.hist_step2.tolist()}, spectral kernel launches {launches}", flush=True)

    # 7. times (records, not a claim), each beside the card's name and limit
    steps_per_epoch = math.ceil(ds.n_sam / tcfg.batch_size)
    steps_per_s = steps_per_epoch * (tcfg.num_epoch1 - 1) / sum(res.epoch_times_step1[1:])
    print(f"[7 times] step-1 train steps/s (B=64x4, f32 apply + 1 refinement, epochs 2-3): "
          f"{steps_per_s:.2f} on {card}", flush=True)
    times = {}
    for shape, reps in ((MAIN_SHAPE, 200), (COARSE_SHAPE, 50)):
        for dtype in (torch.float32, torch.float64):
            V, g, c, b = pencil_problem(*shape, seed=7, dtype=dtype, device=dev)
            Vt = V.T.contiguous()
            saved = spectral_apply_batched.launches
            k_ms = time_ms(lambda: spectral_apply_batched(V, g, c, b, return_coords=True, Vt=Vt),
                           warmup=reps // 10, reps=reps)
            p_ms = time_ms(lambda: spectral_apply_reference(V, g, c, b, return_coords=True),
                           warmup=reps // 10, reps=reps)
            spectral_apply_batched.launches = saved
            times[shape, dtype] = (k_ms, p_ms)
            print(f"[7 times] spectral apply (B, n)={shape} {dtype}: kernel {k_ms:.4f} ms, "
                  f"plain {p_ms:.4f} ms, on {card}", flush=True)

    scaled = scaled_path(dev, card)
    box = box3d_path(dev, card)

    print(card)
    print(json.dumps({"kernels": [{
        "name": "spectral_apply_batched",
        "route": "cuda",
        "source": "vbicm_tpu_torch/csrc/spectral_apply.cu",
        "replaces": "vbicm_tpu/ops/spectral_pallas.py:56",
        "launches": launches + scaled["spectral_launches"] + box["spectral_launches"],
        "launches_by_path": {"cooks_20x10": launches,
                             "scaled_160x80": scaled["spectral_launches"],
                             "box3d_32x8x8": box["spectral_launches"]},
        "max_abs_err": main_abs_err,
        "ms": times[MAIN_SHAPE, torch.float32][0],
        "plain_ms": times[MAIN_SHAPE, torch.float32][1],
        "ms_coarse_256x1680": times[COARSE_SHAPE, torch.float32][0],
        "plain_ms_coarse_256x1680": times[COARSE_SHAPE, torch.float32][1],
        "ms_coarse_256x1200": box["spectral_ms"][0],
        "plain_ms_coarse_256x1200": box["spectral_ms"][1],
    }, {
        "name": "stencil_affine_matvec",
        "route": "cuda",
        "source": "vbicm_tpu_torch/csrc/stencil_affine.cu",
        "replaces": "vbicm_tpu/ops/stencil_pallas.py:71",
        "launches": scaled["stencil_launches"],
        "max_abs_err": scaled["stencil_abs_err"],
        "ms": scaled["stencil_ms"][torch.float32][0],
        "plain_ms": scaled["stencil_ms"][torch.float32][1],
    }, {
        "name": "stencil3d_affine_matvec",
        "route": "cuda",
        "source": "vbicm_tpu_torch/csrc/stencil3d_affine.cu",
        "replaces": "vbicm_tpu/ops/stencil3d_pallas.py:63",
        "launches": box["stencil3d_launches"],
        "max_abs_err": box["stencil3d_abs_err"],
        "ms": box["stencil3d_ms"][(32, 8, 8), torch.float32][0],
        "plain_ms": box["stencil3d_ms"][(32, 8, 8), torch.float32][1],
        "ms_64x16x16": box["stencil3d_ms"][(64, 16, 16), torch.float32][0],
        "plain_ms_64x16x16": box["stencil3d_ms"][(64, 16, 16), torch.float32][1],
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


def scaled_path(dev, card):
    """Phases 8-12: the scaled configuration (Cook's membrane 160x80)."""
    import dataclasses

    from vbicm_tpu_torch.config import ProblemConfig, TrainConfig
    from vbicm_tpu_torch.mesh import cooks_membrane_mesh
    from vbicm_tpu_torch.model import build_fem_model
    from vbicm_tpu_torch.ops.assembly import element_affine_matvec
    from vbicm_tpu_torch.ops.element import lame_from_Ev
    from vbicm_tpu_torch.ops.spectral_kernel import spectral_apply_batched
    from vbicm_tpu_torch.ops.stencil import StencilOperator
    from vbicm_tpu_torch.ops.stencil_kernel import stencil_affine_matvec, stencil_affine_reference
    from vbicm_tpu_torch.prob.datagen import generate_data_fem
    from vbicm_tpu_torch.solver import make_fh_fun, make_solver, make_two_level_solver
    from vbicm_tpu_torch.vi.train import TwoStepTrainer

    out = {}
    # 8. stencil kernel against its plain version, ragged sample tiles
    worst = {}
    saved = stencil_affine_matvec.launches
    for nx, ny in STENCIL_GRIDS:
        op = StencilOperator(build_fem_model(cooks_membrane_mesh(nx, ny), device=dev,
                                             dense=False), nx, ny)
        ndof = 2 * (nx + 1) * (ny + 1)
        for B in STENCIL_BATCHES:
            rng = np.random.default_rng(B + nx)
            u64 = torch.as_tensor(rng.normal(size=(B, ndof)), device=dev)
            c64 = torch.as_tensor(rng.uniform(1.0, 3.0, (B, 2)), device=dev)
            for dtype in (torch.float32, torch.float64):
                u, c = u64.to(dtype), c64.to(dtype)
                q = op.affine(c, u)
                qr = stencil_affine_reference(op.W[dtype], c, u)
                torch.cuda.synchronize()
                err = rel_err(q, qr)
                if not err <= REL_TOL[dtype]:
                    fail(f"stencil kernel vs plain at {nx}x{ny} B={B} {dtype}: rel err {err}")
                worst[dtype] = max(worst.get(dtype, 0.0), err)
                if dtype == torch.float32 and (nx, B) == STENCIL_MAIN:
                    out["stencil_abs_err"] = float((q - qr).abs().max())
                    stencil_case = (op, c64, u64)
    stencil_affine_matvec.launches = saved
    print(f"[8 stencil] ok: max rel err vs plain (of max|q|) f32 {worst[torch.float32]:.3e} "
          f"(tol 2e-5), f64 {worst[torch.float64]:.3e} (tol 1e-12) over grids {STENCIL_GRIDS} "
          f"x B in {STENCIL_BATCHES}", flush=True)

    # 9. the two-level solve at 160x80 against the JAX package's f64 golden
    with open(os.path.join(ROOT, "tests", "fixtures", "scaled_160x80_golden.json")) as f:
        gold = json.load(f)
    nx, ny, r = (gold["mesh"][k] for k in ("nx", "ny", "ratio"))
    model = build_fem_model(cooks_membrane_mesh(nx, ny), device=dev, dense=False)
    coarse = build_fem_model(cooks_membrane_mesh(nx // r, ny // r), device=dev, dense=True)
    probe = gold["probe"]
    cfg = dataclasses.replace(ProblemConfig(), node_id=probe["node_id"], ele_id=probe["ele_id"],
                              nipt_id=tuple(probe["nipt_id"]))
    fhs, solvers = {}, {}
    for residual, tol in (("f64", 1e-6), ("split_f32", 1e-3)):
        solve = make_two_level_solver(model, coarse, nx // r, ny // r, r, cg_dtype=torch.float32,
                                      refine_iters=1, tol=3e-3, maxiter=400, use_stencil=True,
                                      refine_residual=residual)
        fhs[residual], solvers[residual] = make_fh_fun(model, cfg, solve_free=solve), solve
        thetas = torch.as_tensor(gold["thetas"], dtype=torch.float64, device=dev)
        with torch.no_grad():
            y, h = fhs[residual](thetas)
            tm, ts = cfg.theta_map.theta_mean, cfg.theta_map.theta_std
            c0, c1 = lame_from_Ev(torch.exp(ts[0] * thetas[:, 0] + tm[0]),
                                  0.5 * torch.sigmoid(ts[1] * thetas[:, 1] + tm[1]))
            u = solve(c0, c1)
            ke = torch.stack([model.ke_lam, model.ke_mu])
            b = (model.f_ext * model.free_mask).expand(u.shape[0], -1)
            res = (b - element_affine_matvec(ke, model.lm, torch.stack([c0, c1], -1), u,
                                             model.ndof)) * model.free_mask
            rel_res = float((res.norm(dim=-1) / b.norm(dim=-1)).max())
        errs = (rel_err(y, torch.as_tensor(gold["y"], dtype=torch.float64, device=dev)),
                rel_err(h, torch.as_tensor(gold["h"], dtype=torch.float64, device=dev)))
        iters = [it.tolist() for it in solve.solver.last_cg_iters]
        if not max(errs) <= tol:
            fail(f"two-level {residual} vs JAX golden: rel err (y, h) {errs} > {tol}")
        print(f"[9 two-level] ok: 160x80 f32 CG (tol 3e-3) + 1 {residual} refinement vs JAX f64 "
              f"golden, rel err y {errs[0]:.3e}, h {errs[1]:.3e} (tol {tol:g}); max relative "
              f"residual (element matvec, f64) {rel_res:.3e}; CG iterations {iters}", flush=True)

    # 10. adjoint at 40x20 (coarse 10x5) against the dense spectral solve, f64
    fine40 = build_fem_model(cooks_membrane_mesh(40, 20), device=dev, dense=True)
    coarse10 = build_fem_model(cooks_membrane_mesh(10, 5), device=dev, dense=True)
    rng = np.random.default_rng(3)
    lam = torch.as_tensor(rng.uniform(8.0, 16.0, 64), device=dev)
    mu = torch.as_tensor(rng.uniform(6.0, 9.0, 64), device=dev)
    wv = torch.as_tensor(rng.normal(size=(64, fine40.ndof)), device=dev) * fine40.free_mask
    vals, grads = [], []
    for solve in (make_two_level_solver(fine40, coarse10, 10, 5, 4, cg_dtype=torch.float32,
                                        refine_iters=1, tol=3e-3, maxiter=400, use_stencil=True),
                  make_solver(fine40)):
        a, m = lam.clone().requires_grad_(True), mu.clone().requires_grad_(True)
        J = (solve(a, m) * wv).sum(-1)
        vals.append(J.detach())
        grads.append(torch.stack(torch.autograd.grad(J.sum(), (a, m)), -1))
    adj = (rel_err(vals[0], vals[1]), rel_err(grads[0], grads[1]))
    if not (adj[0] <= 1e-7 and adj[1] <= 1e-6):
        fail(f"two-level adjoint vs dense at 40x20: rel err (value, grad) {adj} > (1e-7, 1e-6)")
    print(f"[10 adjoint] ok: 40x20 two-level (f32 CG + 1 f64 refinement) vs dense spectral f64, "
          f"64 probe functionals: value rel err {adj[0]:.3e} (tol 1e-7), d/d(lam, mu) "
          f"{adj[1]:.3e} (tol 1e-6)", flush=True)

    # 11. the scaled main path: dataset generation and the two-step trainer
    #     through the two-level observation operator (f64 refinement)
    cfg = dataclasses.replace(ProblemConfig(), node_id=model.nnodes, ele_id=(ny // 2) * nx + 12)
    fh = make_fh_fun(model, cfg, solve_free=solvers["f64"])
    tcfg = TrainConfig(batch_size=64, num_epoch1=2, num_epoch2=2)
    spectral_apply_batched.launches = 0
    stencil_affine_matvec.launches = 0
    ds = generate_data_fem(torch.Generator().manual_seed(0), fh, n_sam=256, ne_sam=4, device=dev,
                           sig_e=cfg.sig_e, sig_eta=cfg.sig_eta, chunk=2048)
    trainer = TwoStepTrainer(None, cfg, tcfg, fh_batch=fh, device=dev)
    res = trainer.fit(ds.y_data, ds.e_data, torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    out["spectral_launches"] = spectral_apply_batched.launches
    out["stencil_launches"] = stencil_affine_matvec.launches
    preds = trainer.predict(res.theta_net, res.z_net, ds.y_data[:8])
    losses = np.concatenate([res.hist_step1, res.hist_step2])
    if not np.all(np.isfinite(losses)):
        fail(f"scaled trainer: non-finite losses: step1 {res.hist_step1}, step2 {res.hist_step2}")
    if not all(p.shape == (8, 2) and bool(torch.isfinite(p).all()) for p in preds):
        fail("scaled predict: outputs not finite (8, 2) tensors")
    if out["spectral_launches"] <= 0 or out["stencil_launches"] <= 0:
        fail(f"the scaled trainer launched spectral {out['spectral_launches']}, stencil "
             f"{out['stencil_launches']} times; both must be > 0")
    print(f"[11 scaled trainer] ok: 160x80, n=256 x ne_sam 4, 2 + 2 epochs at batch 64; step1 "
          f"losses {res.hist_step1.tolist()}, step2 losses {res.hist_step2.tolist()}; kernel "
          f"launches stencil {out['stencil_launches']}, spectral {out['spectral_launches']}",
          flush=True)

    # 12. times (records, not a claim), each beside the card's name and limit
    steps = math.ceil(ds.n_sam / tcfg.batch_size) * (tcfg.num_epoch1 - 1)
    print(f"[12 times] scaled step-1 train steps/s (160x80, B=64x4, f32 CG + 1 f64 refinement, "
          f"epoch 2): {steps / sum(res.epoch_times_step1[1:]):.3f} on {card}", flush=True)
    op, c64, u64 = stencil_case
    out["stencil_ms"] = {}
    saved = stencil_affine_matvec.launches
    for dtype in (torch.float32, torch.float64):
        u, c = u64.to(dtype), c64.to(dtype)
        k_ms = time_ms(lambda: op.affine(c, u))
        p_ms = time_ms(lambda: stencil_affine_reference(op.W[dtype], c, u), warmup=5, reps=50)
        out["stencil_ms"][dtype] = (k_ms, p_ms)
        print(f"[12 times] stencil matvec (B=256, 160x80) {dtype}: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, on {card}", flush=True)
    stencil_affine_matvec.launches = saved
    thetas = torch.randn((256, 2), generator=torch.Generator().manual_seed(5),
                         dtype=torch.float64).to(dev)
    for residual in ("f64", "split_f32"):
        with torch.no_grad():
            fhs[residual](thetas)
            torch.cuda.synchronize()
            tic = time.perf_counter()
            for _ in range(3):
                fhs[residual](thetas)
            torch.cuda.synchronize()
        dt = (time.perf_counter() - tic) / 3
        its = torch.stack(solvers[residual].solver.last_cg_iters).double()
        print(f"[12 times] two-level fh (160x80, B=256, f32 CG + 1 {residual} refinement): "
              f"{256 / dt:.1f} solves/s ({dt * 1e3:.1f} ms a batch); CG iterations per solve "
              f"(first CG, refinement CG) mean {its.mean(1).tolist()}, max "
              f"{its.max(1).values.tolist()}, on {card}", flush=True)
    return out


def box3d_path(dev, card):
    """Phases 13-17: the 3-D hex8 box (the 32x8x8 trainer and the 64x16x16
    solve)."""
    import dataclasses

    from vbicm_tpu_torch.config import ProblemConfig, SectionCard, TrainConfig
    from vbicm_tpu_torch.mesh import beam_hex8_mesh
    from vbicm_tpu_torch.model import build_fem_model
    from vbicm_tpu_torch.ops.assembly import element_affine_matvec
    from vbicm_tpu_torch.ops.element import lame_from_Ev
    from vbicm_tpu_torch.ops.spectral_kernel import (
        spectral_apply_batched,
        spectral_apply_reference,
    )
    from vbicm_tpu_torch.ops.stencil3d import StencilOperator3d
    from vbicm_tpu_torch.ops.stencil3d_kernel import (
        stencil3d_affine_matvec,
        stencil3d_affine_reference,
    )
    from vbicm_tpu_torch.prob.datagen import generate_data_fem
    from vbicm_tpu_torch.solver import make_fh_fun, make_solver, make_two_level_solver_box3d
    from vbicm_tpu_torch.vi.train import TwoStepTrainer

    sec = SectionCard(stype=4)
    out = {}

    # 13. the 3-D stencil kernel against its plain version, ragged tiles
    worst, ops, cases = {}, {}, {}
    saved = stencil3d_affine_matvec.launches
    for cells in BOX_GRIDS:
        m = build_fem_model(beam_hex8_mesh(*cells), sec, device=dev, dense=False)
        ops[cells] = op = StencilOperator3d(m, *cells)
        W = {dt: op.W.to(dev, dt) for dt in (torch.float32, torch.float64)}  # the plain operand
        for B in STENCIL_BATCHES:
            rng = np.random.default_rng(B + cells[0])
            u64 = torch.as_tensor(rng.normal(size=(B, m.ndof)), device=dev)
            c64 = torch.as_tensor(rng.uniform(1.0, 3.0, (B, 2)), device=dev)
            for dtype in (torch.float32, torch.float64):
                u, c = u64.to(dtype), c64.to(dtype)
                q = op.affine(c, u)
                qr = stencil3d_affine_reference(W[dtype], c, u)
                torch.cuda.synchronize()
                err = rel_err(q, qr)
                if not err <= REL_TOL[dtype]:
                    fail(f"3-D stencil kernel vs plain at {cells} B={B} {dtype}: rel err {err}")
                worst[dtype] = max(worst.get(dtype, 0.0), err)
                if dtype == torch.float32 and (cells, B) == BOX_MAIN:
                    out["stencil3d_abs_err"] = float((q - qr).abs().max())
            if B == 256:
                cases[cells] = (c64, u64)
        del W
    stencil3d_affine_matvec.launches = saved
    print(f"[13 stencil3d] ok: max rel err vs plain (of max|q|) f32 {worst[torch.float32]:.3e} "
          f"(tol 2e-5), f64 {worst[torch.float64]:.3e} (tol 1e-12) over grids {BOX_GRIDS} "
          f"x B in {STENCIL_BATCHES}", flush=True)

    # 14. the box two-level solve against the JAX package's f64 golden. Two
    #     refinements are held to 1e-6 for "train" as for "bench". The
    #     trainer's own solver (one refinement, the fh phase 16 trains
    #     through) leaves ~tol^2 = 9e-6 and is held to 1e-4; the solve
    #     without refinement, which that bound must tell apart from it, is
    #     recorded.
    with open(os.path.join(ROOT, "tests", "fixtures", "scaled_3d_golden.json")) as f:
        gold = json.load(f)
    thetas = torch.as_tensor(gold["thetas"], dtype=torch.float64, device=dev)
    fhs = {}
    bounds = {1: 1e-4, 2: 1e-6}  # by refinements; the solve without one is recorded
    for name, refines, maxiter in (("train", (0, 1, 2), 400), ("bench", (2,), 1500)):
        g = gold[name]["mesh"]
        nx, ny, nz, r = g["nx"], g["ny"], g["nz"], g["ratio"]
        mesh_kw = {"lx": g["lx"], "tip_force": tuple(g["tip_force"])}
        model = build_fem_model(beam_hex8_mesh(nx, ny, nz, **mesh_kw), sec, device=dev,
                                dense=False)
        cells_c = (nx // r, ny // r, nz // r)
        coarse = build_fem_model(beam_hex8_mesh(*cells_c, **mesh_kw), sec, device=dev,
                                 dense=True)
        # the 3-D trainer's probes (examples/train_scaled_3d_torch.py)
        probe = gold[name]["probe"]
        cfg = dataclasses.replace(ProblemConfig(), y_dim=3, node_id=probe["node_id"],
                                  ele_id=probe["ele_id"], nipt_id=tuple(probe["nipt_id"]))
        y_gold, h_gold = (torch.as_tensor(gold[name][k], dtype=torch.float64, device=dev)
                          for k in ("y", "h"))
        for refine in refines:
            solve = make_two_level_solver_box3d(model, coarse, cells_c, r,
                                                cg_dtype=torch.float32, refine_iters=refine,
                                                tol=3e-3, maxiter=maxiter)
            fh = make_fh_fun(model, cfg, solve_free=solve)
            fhs[name, refine] = {"cfg": cfg, "fh": fh, "solve": solve}
            with torch.no_grad():
                y, h = fh(thetas)
                iters = [it.tolist() for it in solve.solver.last_cg_iters]
                tm, ts = cfg.theta_map.theta_mean, cfg.theta_map.theta_std
                c0, c1 = lame_from_Ev(torch.exp(ts[0] * thetas[:, 0] + tm[0]),
                                      0.5 * torch.sigmoid(ts[1] * thetas[:, 1] + tm[1]))
                u = solve(c0, c1)
                ke = torch.stack([model.ke_lam, model.ke_mu])
                b = (model.f_ext * model.free_mask).expand(u.shape[0], -1)
                res = (b - element_affine_matvec(ke, model.lm, torch.stack([c0, c1], -1), u,
                                                 model.ndof)) * model.free_mask
                rel_res = float((res.norm(dim=-1) / b.norm(dim=-1)).max())
            errs = (rel_err(y, y_gold), rel_err(h, h_gold))
            bound = bounds.get(refine)
            if bound is not None and not max(errs) <= bound:
                fail(f"box two-level {name} ({nx}x{ny}x{nz}) vs JAX golden: rel err (y, h) "
                     f"{errs} > {bound:g} with {refine} refinement(s); CG iterations {iters}; "
                     f"max relative residual {rel_res:.3e}")
            print(f"[14 box3d] {'record' if bound is None else 'ok'}: {name} {nx}x{ny}x{nz} "
                  f"({model.ndof} dofs) f32 CG (tol 3e-3) + {refine} f64 refinement(s) vs JAX "
                  f"f64 golden, rel err y {errs[0]:.3e}, h {errs[1]:.3e}"
                  f"{'' if bound is None else f' (tol {bound:g})'}; max relative residual "
                  f"(element matvec, f64) {rel_res:.3e}; CG iterations per lane {iters}",
                  flush=True)

    # 15. adjoint at 8x4x4 (coarse 4x2x2, 675 dofs) against the dense solve,
    #     with two refinements as phase 14's check (one leaves ~tol^2)
    fine8 = build_fem_model(beam_hex8_mesh(8, 4, 4), sec, device=dev, dense=True)
    coarse4 = build_fem_model(beam_hex8_mesh(4, 2, 2), sec, device=dev, dense=True)
    rng = np.random.default_rng(3)
    lam = torch.as_tensor(rng.uniform(8.0, 16.0, 64), device=dev)
    mu = torch.as_tensor(rng.uniform(6.0, 9.0, 64), device=dev)
    wv = torch.as_tensor(rng.normal(size=(64, fine8.ndof)), device=dev) * fine8.free_mask
    vals, grads = [], []
    for solve in (make_two_level_solver_box3d(fine8, coarse4, (4, 2, 2), 2,
                                              cg_dtype=torch.float32, refine_iters=2, tol=3e-3,
                                              maxiter=400),
                  make_solver(fine8)):
        a, m = lam.clone().requires_grad_(True), mu.clone().requires_grad_(True)
        J = (solve(a, m) * wv).sum(-1)
        vals.append(J.detach())
        grads.append(torch.stack(torch.autograd.grad(J.sum(), (a, m)), -1))
    adj = (rel_err(vals[0], vals[1]), rel_err(grads[0], grads[1]))
    if not (adj[0] <= 1e-7 and adj[1] <= 1e-6):
        fail(f"box two-level adjoint vs dense at 8x4x4: rel err (value, grad) {adj} > "
             "(1e-7, 1e-6)")
    print(f"[15 box3d adjoint] ok: 8x4x4 box two-level (f32 CG + 2 f64 refinements) vs dense "
          f"spectral f64, 64 probe functionals: value rel err {adj[0]:.3e} (tol 1e-7), "
          f"d/d(lam, mu) {adj[1]:.3e} (tol 1e-6)", flush=True)

    # 16. the 3-D main path: dataset generation and the two-step trainer at
    #     32x8x8 through the box two-level observation operator
    cfg, fh = fhs["train", 1]["cfg"], fhs["train", 1]["fh"]
    tcfg = TrainConfig(batch_size=64, num_epoch1=2, num_epoch2=2, lr_decay_mode="fixed",
                       pairing="per_sample")
    spectral_apply_batched.launches = 0
    stencil3d_affine_matvec.launches = 0
    ds = generate_data_fem(torch.Generator().manual_seed(0), fh, n_sam=256, ne_sam=4, device=dev,
                           d_y=3, sig_e=cfg.sig_e, sig_eta=cfg.sig_eta, chunk=512)
    trainer = TwoStepTrainer(None, cfg, tcfg, fh_batch=fh, device=dev,
                             y_norm=(ds.y_mean, ds.y_std), bridge_chunk=512)
    res = trainer.fit(ds.y_data, ds.e_data, torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    out["spectral_launches"] = spectral_apply_batched.launches
    out["stencil3d_launches"] = stencil3d_affine_matvec.launches
    preds = trainer.predict(res.theta_net, res.z_net, ds.y_data[:8])
    losses = np.concatenate([res.hist_step1, res.hist_step2])
    if not np.all(np.isfinite(losses)):
        fail(f"3-D trainer: non-finite losses: step1 {res.hist_step1}, step2 {res.hist_step2}")
    if not all(p.shape == (8, 2) and bool(torch.isfinite(p).all()) for p in preds):
        fail("3-D predict: outputs not finite (8, 2) tensors")
    if out["spectral_launches"] <= 0 or out["stencil3d_launches"] <= 0:
        fail(f"the 3-D trainer launched spectral {out['spectral_launches']}, stencil3d "
             f"{out['stencil3d_launches']} times; both must be > 0")
    print(f"[16 box3d trainer] ok: 32x8x8, n=256 x ne_sam 4, 2 + 2 epochs at batch 64, y_norm, "
          f"per-sample pairing; step1 losses {res.hist_step1.tolist()}, step2 losses "
          f"{res.hist_step2.tolist()}; kernel launches stencil3d {out['stencil3d_launches']}, "
          f"spectral {out['spectral_launches']}", flush=True)

    # 17. times (records, not a claim), each beside the card's name and limit
    steps = math.ceil(ds.n_sam / tcfg.batch_size) * (tcfg.num_epoch1 - 1)
    print(f"[17 times] 3-D step-1 train steps/s (32x8x8, B=64x4, f32 CG + 1 f64 refinement, "
          f"epoch 2): {steps / sum(res.epoch_times_step1[1:]):.3f} on {card}", flush=True)
    out["stencil3d_ms"] = {}
    saved = stencil3d_affine_matvec.launches
    for cells in ((32, 8, 8), (64, 16, 16)):
        op = ops[cells]
        c64, u64 = cases[cells]
        for dtype in (torch.float32, torch.float64):
            u, c, W = u64.to(dtype), c64.to(dtype), op.W.to(dev, dtype)
            k_ms = time_ms(lambda: op.affine(c, u), warmup=10, reps=100)
            p_ms = time_ms(lambda: stencil3d_affine_reference(W, c, u), warmup=3, reps=20)
            out["stencil3d_ms"][cells, dtype] = (k_ms, p_ms)
            nbytes = (2 * u.numel() + op.planes[dtype].numel() + c.numel()) * u.element_size()
            print(f"[17 times] 3-D stencil matvec (B=256, {cells[0]}x{cells[1]}x{cells[2]}) "
                  f"{dtype}: kernel {k_ms:.4f} ms ({nbytes / k_ms / 1e9:.3f} TB/s of u, q and "
                  f"planes once), plain {p_ms:.4f} ms, on {card}", flush=True)
    stencil3d_affine_matvec.launches = saved
    saved = spectral_apply_batched.launches
    for dtype in (torch.float32, torch.float64):
        V, g, c, b = pencil_problem(*BOX_COARSE_SHAPE, seed=7, dtype=dtype, device=dev)
        Vt = V.T.contiguous()
        k_ms = time_ms(lambda: spectral_apply_batched(V, g, c, b, return_coords=True, Vt=Vt),
                       warmup=5, reps=50)
        p_ms = time_ms(lambda: spectral_apply_reference(V, g, c, b, return_coords=True),
                       warmup=5, reps=50)
        if dtype == torch.float32:
            out["spectral_ms"] = (k_ms, p_ms)
        print(f"[17 times] spectral apply (B, n)={BOX_COARSE_SHAPE} {dtype}: kernel "
              f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, on {card}", flush=True)
    spectral_apply_batched.launches = saved
    refine = 2
    fh, solve = fhs["bench", refine]["fh"], fhs["bench", refine]["solve"]
    f64_ms = out["stencil3d_ms"][(64, 16, 16), torch.float64][0]
    f32_ms = out["stencil3d_ms"][(64, 16, 16), torch.float32][0]
    for B in BOX_FH_BATCHES:
        th = torch.randn((B, 2), generator=torch.Generator().manual_seed(5),
                         dtype=torch.float64).to(dev)
        with torch.no_grad():
            fh(th)
            torch.cuda.synchronize()
            tic = time.perf_counter()
            for _ in range(3):
                fh(th)
            torch.cuda.synchronize()
        dt = (time.perf_counter() - tic) / 3
        its = torch.stack(solve.solver.last_cg_iters).double()
        share = ""
        if B == BOX_FH_BATCHES[-1]:
            share = (f"; one f64 stencil launch {f64_ms:.4f} ms vs one f32 {f32_ms:.4f} ms, the "
                     f"{refine} f64 residuals {100 * refine * f64_ms / (dt * 1e3):.3f} % of "
                     "the solve")
        print(f"[17 times] box two-level fh (64x16x16, B={B}, f32 CG + {refine} f64 "
              f"refinements): {B / dt:.1f} solves/s ({dt * 1e3:.1f} ms a batch); CG iterations "
              f"per solve (first CG, refinement CGs) mean {its.mean(1).tolist()}, max "
              f"{its.max(1).values.tolist()}{share}, on {card}", flush=True)
    return out


if __name__ == "__main__":
    main()
