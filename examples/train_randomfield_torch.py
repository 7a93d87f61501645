"""Random-field material inversion with the PyTorch port
(``vbicm_tpu_torch``), end-to-end amortized VI.

The counterpart of ``examples/train_randomfield.py``: a 16-mode KL expansion
of the log-Young's-modulus field on Cook's membrane refined to 80x40,
inferred from 50 displacement probes (y_dim 100) by the two-step amortized
VI of ``vi/train.py``. The observation operator is the per-element field
solver (``ops.solve.make_field_solver``) in structured-grid mode, float32
CG at tol 3e-3 plus one float64 refinement, preconditioned by the
mean-field two-level cycle (``prob.randomfield.
make_mean_field_preconditioner``: the spectral kernel's coarse solve on the
20x10 grid, 440 free dofs, at E0, bilinear transfers, Jacobi on each
field's own diagonal); 64 observations x 4 posterior samples = 256 field
solves a step-1 step. Training: 64-neuron heads, per-sample pairing, fresh
base draws every batch, gradient clipping at 1e5, the full-covariance
posterior, fixed-mode lr decay.

After training: held-out log-field RMSE and z-scores on 256 fresh
observations, then on ``--mcmc-check`` of them MAP + Laplace, HMC in the
VI posterior's coordinates and per-observation refinement, each against
the others. The first held-out observation's true and inferred log-field
(closed-form moments through the KL basis) are written to
``field_cells.npz``; the XDMF export of the JAX example is not ported
(``eval/xdmf.py``, ROADMAP Queue 1 item 10).

    python examples/train_randomfield_torch.py --device cuda --n-data 256 --epochs1 2 --epochs2 2 --mcmc-check 1
"""
# Allow running directly from a repo checkout without installation.
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
del _os, _sys
import argparse
import json
import os
import time

import numpy as np


def add_common_args(ap, *, n_modes, corr_len, results, epochs1, epochs2):
    """The options both field examples share, with the JAX examples'
    defaults; ``--hmc-samples``, ``--hmc-burn`` and ``--refine-steps`` cut
    the checks' depth."""
    ap.add_argument("--n-modes", type=int, default=n_modes)
    ap.add_argument("--corr-len", type=float, default=corr_len)
    ap.add_argument("--sigma", type=float, default=0.3)
    ap.add_argument("--n-data", type=int, default=2048)
    ap.add_argument("--epochs1", type=int, default=epochs1)
    ap.add_argument("--epochs2", type=int, default=epochs2)
    ap.add_argument("--ratio", type=int, default=4,
                    help="fine/coarse cell ratio of the mean-field preconditioner")
    ap.add_argument("--results", type=str, default=results)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mcmc-check", type=int, default=2,
                    help="held-out observations to check with Laplace, HMC and refinement")
    ap.add_argument("--hmc-samples", type=int, default=400)
    ap.add_argument("--hmc-burn", type=int, default=200)
    ap.add_argument("--refine-steps", type=int, default=1500)
    ap.add_argument("--posterior", choices=["meanfield", "fullcov"], default="fullcov",
                    help="q(theta|y) family; fullcov calibrates the posterior stds on this "
                         "correlated target")
    ap.add_argument("--device", type=str, default="cuda")


def open_device(name):
    """The torch device; ``cuda`` without a GPU refuses to run."""
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no GPU is available (torch.cuda.is_available() is False)")
    label = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {device} ({label})")
    return device, label


def build(nx, ny, *, n_modes=16, corr_len=12.0, sigma=0.3, ratio=4, device):
    """The 80x40 field problem: (model, kl, cfg, probes, fh), fh the
    trainer's observation operator (f32 CG at tol 3e-3 + one f64
    refinement, mean-field two-level, grid mode)."""
    import torch

    from vbicm_tpu_torch.config import ProblemConfig
    from vbicm_tpu_torch.mesh import cooks_membrane_mesh
    from vbicm_tpu_torch.model import build_fem_model
    from vbicm_tpu_torch.prob.randomfield import (
        build_kl_expansion,
        make_fh_fun_field,
        make_mean_field_preconditioner,
    )

    if nx % ratio or ny % ratio:
        raise SystemExit(f"--nx/--ny must be divisible by --ratio={ratio} (the mean-field "
                         "preconditioner coarsens the structured grid)")
    model = build_fem_model(cooks_membrane_mesh(nx, ny), device=device, dense=False)
    coarse = build_fem_model(cooks_membrane_mesh(nx // ratio, ny // ratio), device=device,
                             dense=True)
    kl = build_kl_expansion(model, n_modes=n_modes, corr_len=corr_len, sigma=sigma)
    # 50 probe nodes spread over the membrane (a field needs many probes to
    # be identifiable; 2 dofs each -> y_dim = 100)
    rows = np.arange(4, ny + 1, max(1, ny // 5))[:5]
    cols = np.arange(8, nx + 1, max(1, nx // 10))[:10]
    probes = (rows[:, None] * (nx + 1) + cols[None, :] + 1).reshape(-1)
    cfg = ProblemConfig(theta_dim=n_modes, y_dim=2 * len(probes),
                        ele_id=(ny // 2) * nx + nx // 4, sig_e=1e-3, sig_eta=1e-4)
    prec = make_mean_field_preconditioner(coarse, nx // ratio, ny // ratio, ratio,
                                          model.free_mask, nu=0.3,
                                          E0=float(np.exp(kl.mean_log)))
    fh = make_fh_fun_field(model, kl, cfg, probe_nodes=probes, cg_dtype=torch.float32,
                           refine_iters=1, tol=3e-3, preconditioner=prec, grid=(nx, ny))
    return model, kl, cfg, probes, fh


def train(fh, cfg, *, n_data, epochs1, epochs2, posterior, seed, device, results=None,
          verbose=True, chunk=512):
    """Dataset generation through ``fh`` and two-step training with the
    field examples' policy. Returns (trainer, result, dataset, summary)."""
    import torch

    from vbicm_tpu_torch.config import TrainConfig
    from vbicm_tpu_torch.prob.datagen import generate_data_fem
    from vbicm_tpu_torch.utils import trace
    from vbicm_tpu_torch.vi.train import TwoStepTrainer

    summary = {}
    t0 = time.time()
    ds = generate_data_fem(torch.Generator().manual_seed(seed), fh, n_sam=n_data, ne_sam=4,
                           device=device, d_y=cfg.y_dim, d_theta=cfg.theta_dim, sig_e=cfg.sig_e,
                           sig_eta=cfg.sig_eta, chunk=chunk)
    summary["datagen_s"] = time.time() - t0
    if verbose:
        print(f"{n_data}-point dataset (field-solver sweep) in {summary['datagen_s']:.1f}s")
    # per-sample pairing: the cross pairing trains an aggregate posterior,
    # useless for a per-observation field. resample_e: with fixed draws the
    # sharp likelihood (sig_e 1e-3, 100 probe dims) collapses the variances.
    tcfg = TrainConfig(batch_size=64, num_epoch1=epochs1, num_epoch2=epochs2,
                       pairing="per_sample", lr_decay_mode="fixed", num_neuron=64,
                       resample_e=True, clip_grad_norm=1e5, posterior=posterior)
    trainer = TwoStepTrainer(None, cfg, tcfg, fh_batch=fh, device=device, verbose=verbose,
                             results_path=results, y_norm=(ds.y_mean, ds.y_std), bridge_chunk=512)
    launched = trace.counters().get("spectral_apply.launches", 0)
    t0 = time.time()
    res = trainer.fit(ds.y_data, ds.e_data, torch.Generator().manual_seed(seed + 1))
    train_s = time.time() - t0
    launched = trace.counters().get("spectral_apply.launches", 0) - launched
    steps_per_epoch = -(-n_data // 64)
    n_steps = steps_per_epoch * (epochs1 + epochs2)
    summary.update(train_s=train_s, train_steps_per_sec=n_steps / train_s,
                   step1_last=float(res.hist_step1[-1]), step2_last=float(res.hist_step2[-1]),
                   training_launches={"spectral_apply": launched})
    et1 = res.epoch_times_step1
    if len(et1) > 1:
        # epoch 0 carries the kernels' build and the CUDA start-up
        summary["step1_steps_per_sec_steady"] = (len(et1) - 1) * steps_per_epoch / sum(et1[1:])
    if verbose:
        print(f"two-step field-VI training: {train_s:.1f}s ({n_steps / train_s:.2f} steps/s, "
              f"256 field solves a step-1 step); step1 last {res.hist_step1[-1]:.4f}, step2 "
              f"{res.hist_step2[-1]:.3e}")
    return trainer, res, ds, summary


def evaluate(trainer, res, fh, cfg, kl, summary, flush, *, posterior, seed, mcmc_check,
             hmc_samples, hmc_burn, refine_steps, device, results):
    """Held-out log-field errors and z-scores on 256 fresh observations, the
    first one's fields to ``field_cells.npz``, then MAP + Laplace, HMC and
    refinement on ``mcmc_check`` of them; every result into ``summary``,
    written by ``flush()`` after each part."""
    import torch

    from vbicm_tpu_torch.eval import hmc, laplace_posterior, make_fem_logpost
    from vbicm_tpu_torch.prob.randomfield import posterior_field_moments
    from vbicm_tpu_torch.vi.refine import refine_posterior

    d = cfg.theta_dim
    n_test = 256
    gen = torch.Generator().manual_seed(seed + 2)
    t_true = torch.randn((n_test, d), generator=gen, dtype=torch.float64)
    with torch.no_grad():
        y_clean = fh(t_true.to(device))[0].cpu()
    y_obs = y_clean + np.sqrt(cfg.sig_e) * torch.randn(y_clean.shape, generator=gen,
                                                       dtype=torch.float64)
    tm, tsig, _, _ = trainer.predict(res.theta_net, res.z_net, y_obs)
    tm, tsig, t_np = tm.cpu().numpy(), tsig.cpu().numpy(), t_true.numpy()
    logE_err = (tm - t_np) @ kl.modes  # (n_test, nele)
    prior_scale = float(np.sqrt((kl.modes**2).sum(0)).mean())  # prior log-field std
    rmse = float(np.sqrt((logE_err**2).mean()))
    z = (tm - t_np) / np.sqrt(tsig)  # tsig is the posterior variance
    summary.update(test_logfield_rmse=rmse, prior_logfield_std=prior_scale,
                   posterior_contraction=rmse / prior_scale,
                   zscore_rms=float(np.sqrt((z**2).mean())),
                   zscore_median_abs=float(np.median(np.abs(z))))
    print(f"held-out ({n_test}): log-field RMSE {rmse:.4f} (prior std {prior_scale:.4f}, "
          f"contraction {rmse / prior_scale:.3f}), z-score RMS {summary['zscore_rms']:.2f}, "
          f"median |z| {summary['zscore_median_abs']:.2f}")
    flush()

    def chol(i):
        """The VI posterior's factor for observation i: L of the full
        covariance, or diag(std)."""
        if posterior == "fullcov":
            return trainer.predict_cholesky(res.theta_net, y_obs[i:i + 1])[1][0]
        return torch.diag(torch.sqrt(torch.as_tensor(tsig[i], device=device)))

    L0 = chol(0).cpu().numpy()
    log_mean, log_std = (posterior_field_moments(kl, tm[0], L=L0) if posterior == "fullcov"
                         else posterior_field_moments(kl, tm[0], tsig[0]))
    np.savez(os.path.join(results, "field_cells.npz"),
             logE_true=kl.mean_log + t_np[0] @ kl.modes, logE_post_mean=log_mean,
             logE_post_std=log_std)
    print("inferred field of held-out y[0] -> field_cells.npz (XDMF export not ported: "
          "eval/xdmf.py, ROADMAP Queue 1 item 10)")

    lrows, hrows = [], []
    for i in range(mcmc_check):
        y_i = y_obs[i].to(device)
        logpost = make_fem_logpost(fh, y_i, cfg.sig_e)
        mu_i = torch.as_tensor(tm[i], device=device)
        # MAP + Laplace from the VI mean
        t0 = time.time()
        lres = laplace_posterior(logpost, mu_i, tol=1e-6)
        l_std = np.sqrt(np.diag(lres.cov))
        vi_std = np.sqrt(tsig[i])
        lrows.append({"grad_norm": lres.grad_norm, "converged": lres.converged,
                      "map_vs_vi_mean_max": float(np.abs(lres.theta_map - tm[i]).max()),
                      "vi_over_laplace_std_range": [float(np.min(vi_std / l_std)),
                                                    float(np.max(vi_std / l_std))],
                      "laplace_s": time.time() - t0})
        print(f"Laplace check y[{i}]: |MAP - VI mean|_max {lrows[-1]['map_vs_vi_mean_max']:.4f}, "
              f"VI/Laplace std range {lrows[-1]['vi_over_laplace_std_range']}")
        summary["laplace_checks"] = lrows
        flush()

        # HMC in the VI posterior's coordinates theta = mu + C xi (a fixed
        # affine map), so the step size is not held to the sharpest direction
        C_i = chol(i)
        t0 = time.time()
        res_h = hmc(torch.Generator().manual_seed(100 + i),
                    lambda xi: logpost(mu_i + xi @ C_i.T), d=d, n_samples=hmc_samples,
                    burn=hmc_burn, n_chains=8, n_leapfrog=8, device=device)
        hmc_s = time.time() - t0
        flat = tm[i] + res_h.samples.reshape(-1, d) @ C_i.cpu().numpy().T
        mc_mean, mc_std = flat.mean(0), flat.std(0)
        # semi-amortized refinement from the amortized init
        t0 = time.time()
        mu_r, L_r, _ = refine_posterior(lambda th: fh(th)[0], y_i, cfg.sig_e, mu_i, C_i,
                                        generator=torch.Generator().manual_seed(500 + i),
                                        steps=refine_steps, ne=8)
        refine_s = time.time() - t0
        mu_r = mu_r.cpu().numpy()
        r_std = np.sqrt((L_r**2).sum(-1).cpu().numpy())
        hrows.append({
            "accept": res_h.accept_rate, "min_ess": float(res_h.ess.min()),
            "max_rhat": float(res_h.rhat.max()),
            "mean_rmse_vs_mcse": float(np.sqrt(np.mean((tm[i] - mc_mean) ** 2
                                                       / (mc_std**2 + 1e-12)))),
            "std_ratio_range": [float(np.min(vi_std / mc_std)), float(np.max(vi_std / mc_std))],
            "refined_mean_rmse_vs_mcse": float(np.sqrt(np.mean((mu_r - mc_mean) ** 2
                                                               / (mc_std**2 + 1e-12)))),
            "refined_std_ratio_range": [float(np.min(r_std / mc_std)),
                                        float(np.max(r_std / mc_std))],
            "hmc_s": hmc_s, "refine_s": refine_s,
        })
        print(f"HMC check y[{i}]: accept {hrows[-1]['accept']:.3f}, min ESS "
              f"{hrows[-1]['min_ess']:.1f}, mean err/mc-std {hrows[-1]['mean_rmse_vs_mcse']:.3f}, "
              f"VI/MC std ratio {hrows[-1]['std_ratio_range']}; refined err "
              f"{hrows[-1]['refined_mean_rmse_vs_mcse']:.3f}, std ratio "
              f"{hrows[-1]['refined_std_ratio_range']} ({hmc_s:.1f} s HMC, {refine_s:.1f} s "
              f"refinement)")
        summary["hmc_checks"] = hrows
        flush()


def run(args, build_problem, tag):
    """The example: build, train, evaluate, summary.json in ``--results``."""
    device, label = open_device(args.device)
    t0 = time.time()
    model, kl, cfg, probes, fh = build_problem(device)
    build_s = time.time() - t0
    print(f"model ({model.ndof} dofs, {model.nele} elements), {args.n_modes}-mode KL, "
          f"{len(probes)} probes in {build_s:.1f}s")
    summary = {"config": vars(args), "device": label, "ndof": model.ndof,
               "n_probes": int(len(probes)), "build_s": build_s}
    os.makedirs(args.results, exist_ok=True)

    def flush():
        with open(os.path.join(args.results, "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)

    trainer, res, _, s = train(fh, cfg, n_data=args.n_data, epochs1=args.epochs1,
                               epochs2=args.epochs2, posterior=args.posterior, seed=args.seed,
                               device=device, results=args.results)
    summary.update(s)
    np.savez(os.path.join(args.results, "train_hist.npz"),
             train_loss_step1=res.hist_step1, train_loss_step2=res.hist_step2)
    flush()
    evaluate(trainer, res, fh, cfg, kl, summary, flush, posterior=args.posterior,
             seed=args.seed, mcmc_check=args.mcmc_check, hmc_samples=args.hmc_samples,
             hmc_burn=args.hmc_burn, refine_steps=args.refine_steps, device=device,
             results=args.results)
    print(f"{tag} summary -> {args.results}/summary.json")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=80)
    ap.add_argument("--ny", type=int, default=40)
    # 100 step-1 epochs: the variance head converges much more slowly than
    # the mean head under resample_e
    add_common_args(ap, n_modes=16, corr_len=12.0, results="results_randomfield_torch",
                    epochs1=100, epochs2=20)
    args = ap.parse_args(argv)
    run(args, lambda device: build(args.nx, args.ny, n_modes=args.n_modes,
                                   corr_len=args.corr_len, sigma=args.sigma, ratio=args.ratio,
                                   device=device), "field VI")


if __name__ == "__main__":
    main()
