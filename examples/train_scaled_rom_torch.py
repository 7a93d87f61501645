"""Scaled two-step VI training through the certified reduced basis, with the
PyTorch port (``vbicm_tpu_torch``): Cook's membrane refined to 160x80
(12,800 quad4 elements, 26,082 dofs), the reference's 3x20 MLPs, 64
observations x 4 posterior samples per step-1 step.

The counterpart of ``examples/train_scaled_rom.py``. The observation
operator inside the ELBO is the reduced-basis one (``rom.reduced_basis``:
greedy on the host to a true relative residual of 1e-10, then r x r work a
sample on the device). After training, a full-order spot check pushes 16
posterior means through the element-path two-level solver
(``make_two_level_solver(use_stencil=False)``: the element kernel in every
CG iteration, gather transfers, the spectral kernel for the coarse solve;
float32 CG at tol 3e-3 plus one float64 refinement) and requires the ROM's
displacements within 1e-5 of them.

Writes the loss histories and a summary to ``--results``.

    python examples/train_scaled_rom_torch.py --device cuda --n-data 256 --epochs1 2 --epochs2 2
"""
# Allow running directly from a repo checkout without installation.
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
del _os, _sys
import argparse
import dataclasses
import json
import os
import time

import numpy as np

SPOT_TOL = 1e-5  # ROM vs full-order y at the posterior means, relative to max |y|


def build(nx, ny, device):
    """The matrix-free 160x80 model and the scaled configuration's probes
    (the last node; element (ny // 2) * nx + 12)."""
    from vbicm_tpu_torch.config import ProblemConfig
    from vbicm_tpu_torch.mesh import cooks_membrane_mesh
    from vbicm_tpu_torch.model import build_fem_model

    model = build_fem_model(cooks_membrane_mesh(nx, ny), device=device, dense=False)
    cfg = dataclasses.replace(ProblemConfig(), node_id=model.nnodes, ele_id=(ny // 2) * nx + 12)
    return model, cfg


def train_and_check(model, cfg, rb, nx, ny, *, n_data, epochs1, epochs2, seed, device,
                    verbose=True):
    """Dataset generation and two-step training through the ROM observation
    operator, then the full-order spot check. Returns a summary dict with
    the loss histories and ``spot_rel_err``."""
    import torch

    from vbicm_tpu_torch.config import TrainConfig
    from vbicm_tpu_torch.mesh import cooks_membrane_mesh
    from vbicm_tpu_torch.model import build_fem_model
    from vbicm_tpu_torch.prob.datagen import generate_data_fem
    from vbicm_tpu_torch.rom import make_fh_fun_rom
    from vbicm_tpu_torch.solver import make_fh_fun, make_two_level_solver
    from vbicm_tpu_torch.vi.train import TwoStepTrainer

    fh = make_fh_fun_rom(model, rb, cfg)
    summary = {}
    t0 = time.time()
    ds = generate_data_fem(torch.Generator().manual_seed(seed), fh, n_sam=n_data, ne_sam=4,
                           device=device, sig_e=cfg.sig_e, sig_eta=cfg.sig_eta, chunk=8192)
    summary["datagen_s"] = time.time() - t0
    if verbose:
        print(f"{n_data}-point dataset in {summary['datagen_s']:.1f}s")

    tcfg = TrainConfig(batch_size=64, num_epoch1=epochs1, num_epoch2=epochs2)
    trainer = TwoStepTrainer(None, cfg, tcfg, fh_batch=fh, device=device, verbose=verbose)
    t0 = time.time()
    res = trainer.fit(ds.y_data, ds.e_data, torch.Generator().manual_seed(seed + 1))
    summary["train_s"] = time.time() - t0
    summary["hist_step1"] = res.hist_step1.tolist()
    summary["hist_step2"] = res.hist_step2.tolist()
    summary["epoch_times_step1"] = list(res.epoch_times_step1)
    if verbose:
        print(f"two-step training on the {nx}x{ny} mesh: {summary['train_s']:.1f}s")
        print(f"step1 last-batch {res.hist_step1[-1]:.4f}, step2 {res.hist_step2[-1]:.3e}")

    # full-order spot check: posterior means through the element-path
    # two-level solver agree with the ROM observation operator
    coarse = build_fem_model(cooks_membrane_mesh(nx // 4, ny // 4), device=device, dense=True)
    solve2l = make_two_level_solver(model, coarse, nx // 4, ny // 4, 4, cg_dtype=torch.float32,
                                    refine_iters=1, tol=3e-3, maxiter=400)
    fh_full = make_fh_fun(model, cfg, solve_free=solve2l)
    theta_mean = trainer.predict(res.theta_net, res.z_net, ds.y_data[:16])[0]
    with torch.no_grad():
        y_rom, _ = fh(theta_mean)
        y_full, _ = fh_full(theta_mean)
    err = float((y_rom - y_full).abs().max() / y_full.abs().max())
    summary["spot_rel_err"] = err
    summary["spot_cg_iters"] = [it.tolist() for it in solve2l.solver.last_cg_iters]
    if verbose:
        print(f"ROM vs full-order (element path) at 16 posterior means: rel err {err:.2e}")
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=160)
    ap.add_argument("--ny", type=int, default=80)
    ap.add_argument("--n-data", type=int, default=10000)
    ap.add_argument("--epochs1", type=int, default=20)
    ap.add_argument("--epochs2", type=int, default=20)
    ap.add_argument("--results", type=str, default="results_scaled_rom_torch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    import torch

    from vbicm_tpu_torch.rom import build_reduced_basis

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no GPU is available (torch.cuda.is_available() is False)")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {device} ({name})")

    t0 = time.time()
    model, cfg = build(args.nx, args.ny, device)
    rb = build_reduced_basis(model, tol=1e-10)
    build_s = time.time() - t0
    print(f"model ({model.ndof} dofs) + certified ROM (r={rb.r}, residual "
          f"{rb.max_rel_residual:.1e}) in {build_s:.1f}s")
    summary = {"config": vars(args), "device": name, "ndof": model.ndof, "r": rb.r,
               "max_rel_residual": rb.max_rel_residual, "build_s": build_s}
    summary.update(train_and_check(model, cfg, rb, args.nx, args.ny, n_data=args.n_data,
                                   epochs1=args.epochs1, epochs2=args.epochs2, seed=args.seed,
                                   device=device))

    os.makedirs(args.results, exist_ok=True)
    np.savez(os.path.join(args.results, "train_hist.npz"),
             train_loss_step1=np.asarray(summary["hist_step1"]),
             train_loss_step2=np.asarray(summary["hist_step2"]))
    with open(os.path.join(args.results, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"wrote {args.results}/summary.json")
    if not summary["spot_rel_err"] < SPOT_TOL:
        raise SystemExit(f"ROM vs full-order rel err {summary['spot_rel_err']:.3e} >= {SPOT_TOL}")


if __name__ == "__main__":
    main()
