"""On-card smoke test of the PyTorch port (``vbicm_tpu_torch``) on one GPU.

Builds the CUDA kernel from the sources in this checkout, holds it against
its plain PyTorch version, checks the adjoint, the forward parity against
the reference golden and the mixed-precision observation operator, then
drives the port's main path once: dataset generation and the two-step VI
trainer on Cook's membrane 20x10 at the reference's widths (3x20 MLPs, 64
observations x 4 posterior samples per step, float32 apply plus one float64
refinement). Prints one line per phase, the card's name and power limit, a
JSON line with the kernel's record and, last, the ok line. Exits non-zero on
any failure and when no GPU is present.

    python3 chip_smoke.py
"""
import json
import math
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

SHAPES = [(256, 440), (4096, 440), (5, 440), (130, 130), (20, 200)]
MAIN_SHAPE = (256, 440)  # one step-1 batch: 64 observations x 4 samples, 440 free dofs
REL_TOL = {torch.float64: 1e-12, torch.float32: 2e-5}


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
    for dtype in (torch.float32, torch.float64):
        for B, n in SHAPES:
            V, g, c, b = pencil_problem(B, n, seed=B + n, dtype=dtype, device=dev)
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
    for dtype in (torch.float32, torch.float64):
        V, g, c, b = pencil_problem(*MAIN_SHAPE, seed=7, dtype=dtype, device=dev)
        Vt = V.T.contiguous()
        saved = spectral_apply_batched.launches
        k_ms = time_ms(lambda: spectral_apply_batched(V, g, c, b, return_coords=True, Vt=Vt))
        p_ms = time_ms(lambda: spectral_apply_reference(V, g, c, b, return_coords=True))
        spectral_apply_batched.launches = saved
        times[dtype] = (k_ms, p_ms)
        print(f"[7 times] spectral apply (B, n)={MAIN_SHAPE} {dtype}: kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms, on {card}", flush=True)

    print(card)
    print(json.dumps({"kernels": [{
        "name": "spectral_apply_batched",
        "route": "cuda",
        "source": "vbicm_tpu_torch/csrc/spectral_apply.cu",
        "replaces": "vbicm_tpu/ops/spectral_pallas.py:56",
        "launches": launches,
        "max_abs_err": main_abs_err,
        "ms": times[torch.float32][0],
        "plain_ms": times[torch.float32][1],
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
