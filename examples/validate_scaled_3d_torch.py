"""Posterior validation for a finished ``train_scaled_3d_torch.py`` run,
standalone, with the PyTorch port (``vbicm_tpu_torch``).

The counterpart of ``examples/validate_scaled_3d.py``: loads the newest
step-1 and step-2 bundles (``step1/latest.pt``, ``step2/latest.pt``) of the
results directory through the trainer's checkpoint loader
(``TwoStepTrainer.load_ckpt``), takes the same dataset (the keyed
``dataset_cache.npz`` the training run wrote, or generates it again from the
seed), and runs the per-observation refinement probe (``vi.refine``, full
covariance, 16 samples a step, lr 1e-2, waiting for the card every
``--chunk-steps`` steps), so that the training need not run again to
validate its posterior. The solver is the training run's: the box two-level
solver, float32 CG at tol 3e-3 plus one refinement. Its residual is taken in
float64; the JAX example's ``refine_residual="compensated"`` is not ported
(ROADMAP Queue 1 item 12: on the H100 the float64 residual is the cheaper
one).

    python examples/validate_scaled_3d_torch.py --device cuda --results results_scaled_3d_torch --n-data 256
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=32)
    ap.add_argument("--ny", type=int, default=8)
    ap.add_argument("--nz", type=int, default=8)
    ap.add_argument("--ratio", type=int, default=2)
    ap.add_argument("--n-data", type=int, default=2000)
    ap.add_argument("--n-validate", type=int, default=4)
    ap.add_argument("--refine-steps", type=int, default=1500)
    ap.add_argument("--chunk-steps", type=int, default=150)
    ap.add_argument("--results", type=str, default="results_scaled_3d_torch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    import torch

    from vbicm_tpu_torch.config import ProblemConfig, SectionCard, TrainConfig
    from vbicm_tpu_torch.mesh import beam_hex8_mesh
    from vbicm_tpu_torch.model import build_fem_model
    from vbicm_tpu_torch.prob.datagen import cached_dataset, generate_data_fem
    from vbicm_tpu_torch.solver import make_fh_fun, make_two_level_solver_box3d
    from vbicm_tpu_torch.vi.refine import refine_posterior
    from vbicm_tpu_torch.vi.train import TwoStepTrainer

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no GPU is available (torch.cuda.is_available() is False)")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {device} ({name})")

    # the training run's problem (examples/train_scaled_3d_torch.py)
    sec = SectionCard(stype=4)
    tip = (0.0, 0.0, -0.02)
    model = build_fem_model(beam_hex8_mesh(args.nx, args.ny, args.nz, tip_force=tip), sec,
                            device=device, dense=False)
    cells_c = (args.nx // args.ratio, args.ny // args.ratio, args.nz // args.ratio)
    coarse = build_fem_model(beam_hex8_mesh(*cells_c, tip_force=tip), sec, device=device,
                             dense=True)
    solve2l = make_two_level_solver_box3d(model, coarse, cells_c, args.ratio,
                                          cg_dtype=torch.float32, refine_iters=1, tol=3e-3,
                                          maxiter=400, refine_residual="f64")
    cfg = dataclasses.replace(
        ProblemConfig(), y_dim=3, node_id=model.nnodes,
        ele_id=((args.nz - 1) * args.ny + args.ny // 2) * args.nx + 2, nipt_id=(1, 5))
    fh = make_fh_fun(model, cfg, solve_free=solve2l)

    key = {"seed": args.seed, "n_data": args.n_data, "ne_sam": 4,
           "mesh": f"{args.nx}x{args.ny}x{args.nz} ratio {args.ratio}"}
    ds, cached = cached_dataset(
        os.path.join(args.results, "dataset_cache.npz"), key,
        lambda: generate_data_fem(torch.Generator().manual_seed(args.seed), fh,
                                  n_sam=args.n_data, ne_sam=4, device=device, d_y=3,
                                  sig_e=cfg.sig_e, sig_eta=cfg.sig_eta, chunk=512),
        reuse=True)
    print(f"{ds.n_sam}-point dataset ({'cached' if cached else 'generated'})")

    tcfg = TrainConfig(batch_size=64, lr_decay_mode="fixed", pairing="per_sample", ckpt_every=1)
    trainer = TwoStepTrainer(None, cfg, tcfg, fh_batch=fh, device=device,
                             y_norm=(ds.y_mean, ds.y_std), results_path=args.results)
    nets = []
    for subdir, new_net, new_opt in (("step1", trainer.new_theta_net, trainer.optimizer_step1),
                                     ("step2", trainer.new_z_net, trainer.optimizer_step2)):
        net = new_net(torch.Generator().manual_seed(0))
        where = trainer.load_ckpt(subdir, net, new_opt(net))
        if where is None:
            raise SystemExit(f"no checkpoint bundle under {args.results}/{subdir}")
        print(f"loaded {args.results}/{subdir} (epoch {where.epoch - 1} done)")
        nets.append(net)
    theta_net, z_net = nets

    validations = []
    for i in range(args.n_validate):
        y_obs = ds.y_data[i]
        tm, tsg, _, _ = trainer.predict(theta_net, z_net, y_obs[None])
        t0 = time.time()
        mu, L, losses = refine_posterior(
            lambda th: fh(th)[0], y_obs, cfg.sig_e, tm[0], torch.diag(torch.sqrt(tsg[0])),
            generator=torch.Generator().manual_seed(200 + i), steps=args.refine_steps, ne=16,
            lr=1e-2, chunk_steps=args.chunk_steps)
        refine_s = time.time() - t0
        tm, std_a, mu = tm[0].cpu().numpy(), np.sqrt(tsg[0].cpu().numpy()), mu.cpu().numpy()
        std_r = np.sqrt(np.diag((L @ L.T).cpu().numpy()))
        zgap = np.abs(tm - mu) / std_r
        th_true = ds.theta_data[i]
        validations.append({
            "amortized_mean": tm.tolist(),
            "amortized_std": std_a.tolist(),
            "refined_mean": mu.tolist(),
            "refined_std": std_r.tolist(),
            "zgap_amortized": zgap.tolist(),
            # the refined mean within ~2 refined stds of the latent truth says
            # the refinement converged, and any zgap_amortized left is
            # amortization or underfit error
            "true_theta": th_true.tolist(),
            "zgap_refined_to_truth": (np.abs(mu - th_true) / std_r).tolist(),
            "loss_first_last": [float(losses[0]), float(losses[-1])],
            "refine_s": refine_s,
        })
        print(f"obs {i}: amortized {tm} refined {mu} true {th_true} zgap {zgap} "
              f"({args.refine_steps} steps in {refine_s:.1f}s)")

    spath = os.path.join(args.results, "summary.json")
    summary = {}
    if os.path.exists(spath):
        with open(spath) as f:
            summary = json.load(f)
    summary["validation_vs_refined"] = validations
    summary["validation_device"] = name
    with open(spath, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"updated {spath}")


if __name__ == "__main__":
    main()
