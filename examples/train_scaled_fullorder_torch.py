"""Scaled full-order two-step VI training with the PyTorch port
(``vbicm_tpu_torch``): Cook's membrane refined to 160x80 (12,800 quad4
elements, 26,082 dofs), the observation operator routed through the
two-level stencil solver (the stencil kernel in every CG iteration, the
spectral kernel for the coarse solve; float32 CG plus one refinement),
64 observations x 4 posterior samples = 256 full-order solves per step-1
step, the reference's 3x20 MLPs.

Speed mode (default): split-float32 refinement residuals; ``--exact``
switches to float64 residuals. Writes checkpoints, the dataset cache, the
loss histories and a summary to ``--results``; ``--resume`` goes on from
the checkpoints there, and reuses the cached dataset when it was made for
the same seed, sizes and mesh.

For the accuracy cross-check the same dataset then trains the certified
reduced-basis path (``rom.reduced_basis``, the
``examples/train_scaled_rom_torch.py`` operator) from the same seed, and
the two posteriors and predictives are compared net to net on every
observation (``posterior_vs_rom`` in ``summary.json``); ``--skip-rom-compare``
leaves it out.

    python examples/train_scaled_fullorder_torch.py --device cuda --n-data 256 --epochs1 2 --epochs2 2
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


def rom_compare(model, cfg, tcfg, ds, trainer, res, seed, device):
    """Train the certified ROM path on the same dataset from the same seed
    and compare both runs' posterior and predictive nets on every
    observation: each rmse beside the ROM run's spread across observations."""
    import torch

    from vbicm_tpu_torch.rom import build_reduced_basis, make_fh_fun_rom
    from vbicm_tpu_torch.vi.train import TwoStepTrainer

    t0 = time.time()
    rb = build_reduced_basis(model, tol=1e-10)
    tr_rom = TwoStepTrainer(None, cfg, tcfg, fh_batch=make_fh_fun_rom(model, rb, cfg),
                            device=device)
    res_rom = tr_rom.fit(ds.y_data, ds.e_data, torch.Generator().manual_seed(seed + 1))
    print(f"ROM-path training on the same dataset (r={rb.r}): {time.time() - t0:.1f}s")
    y_all = torch.as_tensor(ds.y_data, device=device)
    with torch.no_grad():
        tm_f, tsg_f, _ = res.theta_net(y_all)
        tm_r, tsg_r, _ = res_rom.theta_net(y_all)
        zm_f, zs_f, _ = res.z_net(y_all)
        zm_r, zs_r, _ = res_rom.z_net(y_all)

    def rmse(a, b):
        return float(torch.sqrt(torch.mean((a - b) ** 2)))

    return dict(
        theta_mean_rmse=rmse(tm_f, tm_r), theta_mean_scale=float(torch.std(tm_r)),
        theta_sig_rmse=rmse(tsg_f, tsg_r), theta_sig_scale=float(torch.std(tsg_r)),
        z_mean_rmse=rmse(zm_f, zm_r), z_mean_scale=float(torch.std(zm_r)),
        z_sig_rmse=rmse(zs_f, zs_r), z_sig_scale=float(torch.std(zs_r)),
        step1_last_rom=float(res_rom.hist_step1[-1]), step2_last_rom=float(res_rom.hist_step2[-1]),
        rom_r=rb.r,
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=160)
    ap.add_argument("--ny", type=int, default=80)
    ap.add_argument("--n-data", type=int, default=10000)
    ap.add_argument("--epochs1", type=int, default=20)
    ap.add_argument("--epochs2", type=int, default=20)
    ap.add_argument("--results", type=str, default="results_scaled_fullorder_torch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--exact", action="store_true",
                    help="float64 refinement residuals instead of split-float32")
    ap.add_argument("--skip-rom-compare", action="store_true")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoints in --results")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args()

    import torch

    from vbicm_tpu_torch.config import ProblemConfig, TrainConfig
    from vbicm_tpu_torch.mesh import cooks_membrane_mesh
    from vbicm_tpu_torch.model import build_fem_model
    from vbicm_tpu_torch.prob.datagen import cached_dataset, generate_data_fem
    from vbicm_tpu_torch.solver import make_fh_fun, make_two_level_solver
    from vbicm_tpu_torch.utils import trace
    from vbicm_tpu_torch.vi.train import TwoStepTrainer

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no GPU is available (torch.cuda.is_available() is False)")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {device} ({name})")
    summary = {"config": vars(args), "device": name}

    t0 = time.time()
    model = build_fem_model(cooks_membrane_mesh(args.nx, args.ny), device=device, dense=False)
    coarse = build_fem_model(cooks_membrane_mesh(args.nx // 4, args.ny // 4), device=device,
                             dense=True)
    cfg = dataclasses.replace(ProblemConfig(), node_id=model.nnodes,
                              ele_id=(args.ny // 2) * args.nx + 12)
    solve2l = make_two_level_solver(
        model, coarse, args.nx // 4, args.ny // 4, 4,
        cg_dtype=torch.float32, refine_iters=1, tol=3e-3, maxiter=400, use_stencil=True,
        refine_residual="f64" if args.exact else "split_f32",
    )
    fh = make_fh_fun(model, cfg, solve_free=solve2l)
    build_s = time.time() - t0
    print(f"model ({model.ndof} dofs) + two-level stencil solver in {build_s:.1f}s")
    summary.update(ndof=model.ndof, build_s=build_s)

    t0 = time.time()
    os.makedirs(args.results, exist_ok=True)
    ds, cached = cached_dataset(
        os.path.join(args.results, "dataset_cache.npz"),
        {"seed": args.seed, "n_data": args.n_data, "ne_sam": 4, "mesh": f"{args.nx}x{args.ny}"},
        lambda: generate_data_fem(torch.Generator().manual_seed(args.seed), fh,
                                  n_sam=args.n_data, ne_sam=4, device=device, sig_e=cfg.sig_e,
                                  sig_eta=cfg.sig_eta, chunk=2048),
        reuse=args.resume)
    summary["datagen_s"] = time.time() - t0
    print(f"{ds.n_sam}-point dataset ({'cached' if cached else 'full-order sweep'}) in "
          f"{summary['datagen_s']:.1f}s")

    tcfg = TrainConfig(batch_size=64, num_epoch1=args.epochs1, num_epoch2=args.epochs2)
    trainer = TwoStepTrainer(None, cfg, tcfg, fh_batch=fh, device=device, verbose=True,
                             results_path=args.results)
    # the kernels' launches in training (utils.trace counters)
    before = trace.counters()
    t0 = time.time()
    res = trainer.fit(ds.y_data, ds.e_data, torch.Generator().manual_seed(args.seed + 1),
                      resume=args.resume)
    train_s = time.time() - t0
    after = trace.counters()
    summary["training_launches"] = {
        k: after.get(f"{k}.launches", 0) - before.get(f"{k}.launches", 0)
        for k in ("spectral_apply", "stencil_affine")}
    # the epochs this run trained (a resumed run skips the banked ones)
    n_epochs = len(res.epoch_times_step1) + len(res.epoch_times_step2)
    n_steps = -(-ds.n_sam // 64) * n_epochs
    print(f"two-step full-order training: {n_epochs} epochs in {train_s:.1f}s "
          f"({n_steps / train_s:.3f} steps/s, 256 full-order solves per step-1 step)")
    print(f"step1 last-batch {res.hist_step1[-1]:.4f}, step2 {res.hist_step2[-1]:.3e}")
    summary.update(train_s=train_s, train_epochs=n_epochs, train_steps_per_sec=n_steps / train_s,
                   step1_last=float(res.hist_step1[-1]), step2_last=float(res.hist_step2[-1]))

    np.savez(os.path.join(args.results, "train_hist.npz"),
             train_loss_step1=res.hist_step1, train_loss_step2=res.hist_step2)
    if not args.skip_rom_compare:
        summary["posterior_vs_rom"] = rom_compare(model, cfg, tcfg, ds, trainer, res, args.seed,
                                                  device)
        print("posterior full-order vs ROM:", json.dumps(summary["posterior_vs_rom"], indent=1))
    with open(os.path.join(args.results, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"wrote {args.results}/summary.json")


if __name__ == "__main__":
    main()
