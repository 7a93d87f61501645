"""Scaled 3-D full-order two-step VI training with the PyTorch port
(``vbicm_tpu_torch``) on a hex8 cantilever.

The counterpart of ``examples/train_scaled_3d.py``: the two-step amortized VI
scheme with the observation operator routed through the box two-level
solver (``make_two_level_solver_box3d``: the 27-point stencil kernel in every
CG iteration, tensor-product trilinear transfers, the spectral kernel for
the coarse solve; float32 CG at tol 3e-3 plus one float64 refinement),
64 observations x 4 posterior samples = 256 full-order 3-D solves per step-1
step, the reference's 3x20 MLPs, input standardization from the dataset's
y moments, fixed-mode lr decay and per-sample pairing.

Default configuration: 32x8x8 hex8 cantilever (8,019 dofs), lx = 10, tip
force (0, 0, -0.02), coarse 16x4x4, 2,000-point dataset, 10 + 10 epochs.
y = the 3 displacements of the tip-corner node; z = von Mises at two
quadrature points of a root element, top fiber. After training, the training
solver is cross-checked against a tight solver (two refinements, tol 1e-6)
on 16 thetas. Then the posterior probe: per-observation refinement
(``vi.refine.refine_posterior``, full covariance, 16 samples a step, lr
1e-2) from the amortized posterior of the first 4 observations, through the
training solver; ``--refine-steps`` (default 1500) cuts its depth.

Writes checkpoints (every epoch), the dataset cache, the loss histories and
a summary to ``--results``; ``--resume`` goes on from the checkpoints there
along the uninterrupted run's trajectory, and reuses the cached dataset when
it was made for the same seed, sizes and mesh.

    python examples/train_scaled_3d_torch.py --device cuda --n-data 256 --epochs1 2 --epochs2 2
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=32)
    ap.add_argument("--ny", type=int, default=8)
    ap.add_argument("--nz", type=int, default=8)
    ap.add_argument("--ratio", type=int, default=2)
    ap.add_argument("--n-data", type=int, default=2000)
    ap.add_argument("--epochs1", type=int, default=10)
    ap.add_argument("--epochs2", type=int, default=10)
    ap.add_argument("--results", type=str, default="results_scaled_3d_torch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--refine-steps", type=int, default=1500)
    ap.add_argument("--resume", action="store_true",
                    help="continue from the trainer's checkpoints in --results")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args()

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
    if args.nx % args.ratio or args.ny % args.ratio or args.nz % args.ratio:
        raise SystemExit("--nx/--ny/--nz must be divisible by --ratio")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {device} ({name})")
    summary = {"config": vars(args), "device": name}
    sec = SectionCard(stype=4)

    t0 = time.time()
    # tip force sized so the observables sit at the reference problem's
    # scale (tip deflection ~4, root von Mises ~0.5 at E = 20)
    tip = (0.0, 0.0, -0.02)
    model = build_fem_model(beam_hex8_mesh(args.nx, args.ny, args.nz, tip_force=tip), sec,
                            device=device, dense=False)
    cells_c = (args.nx // args.ratio, args.ny // args.ratio, args.nz // args.ratio)
    coarse = build_fem_model(beam_hex8_mesh(*cells_c, tip_force=tip), sec, device=device,
                             dense=True)
    solve2l = make_two_level_solver_box3d(model, coarse, cells_c, args.ratio,
                                          cg_dtype=torch.float32, refine_iters=1, tol=3e-3,
                                          maxiter=400)
    # probes: y = tip-corner displacement (3 dofs); z = von Mises at a root
    # element one cell in from the clamp, top fiber (the mid cross-section
    # is the neutral axis, with no z signal)
    cfg = dataclasses.replace(
        ProblemConfig(), y_dim=3, node_id=model.nnodes,
        ele_id=((args.nz - 1) * args.ny + args.ny // 2) * args.nx + 2, nipt_id=(1, 5))
    fh = make_fh_fun(model, cfg, solve_free=solve2l)
    build_s = time.time() - t0
    print(f"3-D model ({model.ndof} dofs) + box two-level solver in {build_s:.1f}s")
    summary.update(ndof=model.ndof, build_s=build_s)

    t0 = time.time()
    # a resumed run must not pay the dataset's 3-D solves again, nor train on
    # a dataset made for another configuration
    os.makedirs(args.results, exist_ok=True)
    key = {"seed": args.seed, "n_data": args.n_data, "ne_sam": 4,
           "mesh": f"{args.nx}x{args.ny}x{args.nz} ratio {args.ratio}"}
    ds, cached = cached_dataset(
        os.path.join(args.results, "dataset_cache.npz"), key,
        lambda: generate_data_fem(torch.Generator().manual_seed(args.seed), fh,
                                  n_sam=args.n_data, ne_sam=4, device=device, d_y=3,
                                  sig_e=cfg.sig_e, sig_eta=cfg.sig_eta, chunk=512),
        reuse=args.resume)
    summary["datagen_s"] = time.time() - t0
    print(f"{ds.n_sam}-point 3-D dataset ({'cached' if cached else 'generated'}) in "
          f"{summary['datagen_s']:.1f}s")

    # ckpt_every=1: a bundle every epoch, so a crash costs at most one
    tcfg = TrainConfig(batch_size=64, num_epoch1=args.epochs1, num_epoch2=args.epochs2,
                       lr_decay_mode="fixed", pairing="per_sample", ckpt_every=1)
    trainer = TwoStepTrainer(None, cfg, tcfg, fh_batch=fh, device=device, verbose=True,
                             y_norm=(ds.y_mean, ds.y_std), bridge_chunk=512,
                             results_path=args.results)
    t0 = time.time()
    res = trainer.fit(ds.y_data, ds.e_data, torch.Generator().manual_seed(args.seed + 1),
                      resume=args.resume)
    train_s = time.time() - t0
    steps_per_epoch = -(-ds.n_sam // 64)
    # the epochs this run trained (a resumed run skips the banked ones)
    n_steps = steps_per_epoch * (len(res.epoch_times_step1) + len(res.epoch_times_step2))
    print(f"two-step 3-D full-order training: {train_s:.1f}s ({n_steps / train_s:.2f} steps/s "
          f"at 256 3-D solves/step)")
    print(f"step1 last-batch {res.hist_step1[-1]:.4f}, step2 {res.hist_step2[-1]:.3e}")
    summary.update(train_s=train_s, train_steps_per_sec=n_steps / train_s,
                   step1_last=float(res.hist_step1[-1]), step2_last=float(res.hist_step2[-1]))
    et1, et2 = res.epoch_times_step1, res.epoch_times_step2
    if len(et1) > 1 and len(et2) > 1:
        # steady state: epoch 0 of each step carries the one-time set-up
        steady = (len(et1) - 1 + len(et2) - 1) * steps_per_epoch / (sum(et1[1:]) + sum(et2[1:]))
        summary["train_steps_per_sec_steady"] = steady
        # the JAX example's keys: here epoch 0 carries the kernel build and
        # CUDA start-up in place of the compile
        summary["compile_s_step1"] = et1[0] - et1[-1]
        summary["compile_s_step2"] = et2[0] - et2[-1]
        print(f"steady-state training rate: {steady:.2f} steps/s (epoch 0 of each step excluded)")

    # accuracy cross-check: the training solver against a tight one on the
    # same thetas, so the loose-tolerance training solves did not bias the
    # posterior maps
    solve_tight = make_two_level_solver_box3d(model, coarse, cells_c, args.ratio,
                                              cg_dtype=torch.float32, refine_iters=2, tol=1e-6,
                                              maxiter=800)
    fh_tight = make_fh_fun(model, cfg, solve_free=solve_tight)
    th = torch.as_tensor(np.random.default_rng(3).standard_normal((16, 2)), device=device)
    with torch.no_grad():
        y_a, h_a = fh(th)
        y_b, h_b = fh_tight(th)
    y_err = float((y_a - y_b).abs().max() / y_b.abs().max())
    h_err = float((h_a - h_b).abs().max() / h_b.abs().max())
    print(f"train-solver vs tight-solver probe rel err: y {y_err:.2e}, h {h_err:.2e}")
    summary.update(probe_rel_err_y=y_err, probe_rel_err_h=h_err)

    # the training metrics are written before the validation
    np.savez(os.path.join(args.results, "train_hist.npz"),
             train_loss_step1=res.hist_step1, train_loss_step2=res.hist_step2)
    with open(os.path.join(args.results, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)

    # posterior probe: refinement (the exact posterior up to its tolerance)
    # from the amortized posterior of held-in observations; the amortized
    # mean should sit within about a posterior std of the refined one. It
    # refines through the training solver, whose adjoint training ran and
    # which the probe above holds to the tight solver. y_norm standardizes
    # only the nets' inputs: the likelihood lives in raw y units.
    validations = []
    for i in range(4):
        y_obs = ds.y_data[i]
        tm, tsg, _, _ = trainer.predict(res.theta_net, res.z_net, y_obs[None])
        t0 = time.time()
        mu, L, losses = refine_posterior(
            lambda th: fh(th)[0], y_obs, cfg.sig_e, tm[0], torch.diag(torch.sqrt(tsg[0])),
            generator=torch.Generator().manual_seed(200 + i), steps=args.refine_steps, ne=16,
            lr=1e-2, chunk_steps=150)
        refine_s = time.time() - t0
        tm, std_a = tm[0].cpu().numpy(), np.sqrt(tsg[0].cpu().numpy())
        mu = mu.cpu().numpy()
        std_r = np.sqrt(np.diag((L @ L.T).cpu().numpy()))
        zgap = np.abs(tm - mu) / std_r
        th_true = ds.theta_data[i]
        validations.append({
            "amortized_mean": tm.tolist(),
            "amortized_std": std_a.tolist(),
            "refined_mean": mu.tolist(),
            "refined_std": std_r.tolist(),
            "zgap_amortized": zgap.tolist(),
            # the refined mean within ~2 refined stds of the latent truth
            # says the refinement converged, and any zgap_amortized left is
            # amortization or underfit error
            "true_theta": th_true.tolist(),
            "zgap_refined_to_truth": (np.abs(mu - th_true) / std_r).tolist(),
            "loss_first_last": [float(losses[0]), float(losses[-1])],
            "refine_s": refine_s,
        })
        print(f"obs {i}: amortized {tm} refined {mu} true {th_true} zgap {zgap} "
              f"({args.refine_steps} steps in {refine_s:.1f}s)")
    summary["validation_vs_refined"] = validations

    with open(os.path.join(args.results, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"summary -> {args.results}/summary.json")


if __name__ == "__main__":
    main()
