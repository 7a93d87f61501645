"""Normalizing-flow amortized posterior on a non-Gaussian problem, with the
PyTorch port (``vbicm_tpu_torch``): the counterpart of
``examples/train_flow_vi.py``.

The banana observable

    y = theta2 + a * theta1^2 + eps,   theta ~ N(0, I),  a = 2

has a curved posterior ridge that no Gaussian family represents. The
full-covariance Gaussian and the coupling flow (``models.flow``) are trained
on the same data with fresh base draws every batch (``resample_e``), and
each is held against the exact posterior of a few observations, computed by
deterministic quadrature (fh is linear in theta2, which integrates out in
closed form, leaving a 1-D trapezoid over theta1; cross-checked once against
a brute 2-D grid), and against HMC (``eval.mcmc.hmc``) on the observations
whose theta2 split-R-hat is below 1.05 (theta1's R-hat diverges by
construction: the posterior is symmetric in theta1's sign). Then the full
two-step fit of the flow family.

Writes ``--out``/summary.json: both families' full-data ELBO on fresh
draws, per-observation moments and theta2 quantiles against the exact
posterior (and HMC), the std calibration ratios, the flow's step-2 loss.

    python examples/train_flow_vi_torch.py --quick --device cuda
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

A_BANANA = 2.0
SIG_E = 0.05**2
SIG_ETA = 1e-4
FAMILIES = ("fullcov", "flow")


def fh(theta):
    """Batched banana observable: thetas (B, 2) -> (y (B, 1), h (B, 1))."""
    import torch

    y = theta[:, 1] + A_BANANA * theta[:, 0] ** 2
    h = torch.exp(0.3 * theta[:, 0]) + 0.2
    return y[:, None], h[:, None]


def exact_posterior_stats(y, n1=100001, lim=6.0):
    """Exact posterior of theta | y by quadrature: p(theta2 | theta1, y) =
    N(m(theta1), v) with v = 1 / (1/SIG_E + 1), m = v (y - a theta1^2) /
    SIG_E, and p(theta1 | y) ∝ N(theta1; 0, 1) N(y; a theta1^2, SIG_E + 1)
    on a uniform grid over [-lim, lim]. Mean and std per dim, the
    sign-invariant |theta1| moments, theta2's q10 and q90 (by bisection)."""
    from scipy.special import ndtr

    y = float(np.asarray(y).ravel()[0])
    t1 = np.linspace(-lim, lim, n1)
    v = 1.0 / (1.0 / SIG_E + 1.0)
    m = v * (y - A_BANANA * t1**2) / SIG_E
    logw = -0.5 * t1**2 - 0.5 * (y - A_BANANA * t1**2) ** 2 / (SIG_E + 1.0)
    w = np.exp(logw - logw.max())
    w /= w.sum()
    mean1 = float(w @ t1)
    std1 = float(np.sqrt(max(w @ t1**2 - mean1**2, 0.0)))
    # theta1's posterior is symmetric in its sign; a trained family covers
    # one mode, so |theta1| is what compares across families
    mean_abs1 = float(w @ np.abs(t1))
    std_abs1 = float(np.sqrt(max(w @ t1**2 - mean_abs1**2, 0.0)))
    mean2 = float(w @ m)
    std2 = float(np.sqrt(v + max(w @ m**2 - mean2**2, 0.0)))

    def quantile2(p):
        lo, hi = m.min() - 8 * np.sqrt(v), m.max() + 8 * np.sqrt(v)
        for _ in range(80):
            mid = 0.5 * (lo + hi)
            lo, hi = (lo, mid) if float(w @ ndtr((mid - m) / np.sqrt(v))) >= p else (mid, hi)
        return 0.5 * (lo + hi)

    return {"mean": [mean1, mean2], "std": [std1, std2], "mean_abs1": mean_abs1,
            "std_abs1": std_abs1, "q10_theta2": quantile2(0.10), "q90_theta2": quantile2(0.90)}


def exact_check_2d_grid(y, n=3001, lim=6.0):
    """Brute 2-D grid moments of theta2: the check of the closed-form
    theta2 integral in :func:`exact_posterior_stats`."""
    y = float(np.asarray(y).ravel()[0])
    t1 = np.linspace(-lim, lim, n)
    t2 = np.linspace(-lim, lim, n)
    resid = y - t2[None, :] - A_BANANA * (t1**2)[:, None]
    logp = -0.5 * (t1**2)[:, None] - 0.5 * t2[None, :] ** 2 - 0.5 * resid**2 / SIG_E
    p = np.exp(logp - logp.max())
    p /= p.sum()
    m2 = float(p.sum(0) @ t2)
    return {"mean2": m2, "std2": float(np.sqrt(p.sum(0) @ t2**2 - m2**2))}


def agg(fam, ref, rows):
    """Mean distance of family ``fam`` to ``ref`` over ``rows``: theta2's
    mean, std and q10 + q90, and |theta1|'s mean."""
    def mean_of(f):
        return float(np.mean([f(r) for r in rows]))

    return {
        "mean_err": mean_of(lambda r: abs(r[f"{fam}_mean"][1] - r[f"{ref}_mean"][1])),
        "std_err": mean_of(lambda r: abs(r[f"{fam}_std"][1] - r[f"{ref}_std"][1])),
        "q10q90_err": mean_of(lambda r: abs(r[f"{fam}_q10_theta2"] - r[f"{ref}_q10_theta2"])
                              + abs(r[f"{fam}_q90_theta2"] - r[f"{ref}_q90_theta2"])),
        "mean_abs1_err": mean_of(lambda r: abs(r[f"{fam}_mean_abs1"] - r[f"{ref}_mean_abs1"])),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default="results_flow_torch")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args()
    n_sam = 512 if args.quick else 2048
    epochs1 = 300 if args.quick else 600
    epochs2 = 50
    n_hmc_obs = 4 if args.quick else 8

    import torch

    from vbicm_tpu_torch.config import ProblemConfig, TrainConfig
    from vbicm_tpu_torch.eval.mcmc import hmc, make_fem_logpost
    from vbicm_tpu_torch.models.flow import flow_moments
    from vbicm_tpu_torch.prob.datagen import generate_data_fem
    from vbicm_tpu_torch.utils.draws import draw_normal
    from vbicm_tpu_torch.vi.elbo import make_loss_step1_flow, make_loss_step1_fullcov
    from vbicm_tpu_torch.vi.train import TwoStepTrainer

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no GPU is available (torch.cuda.is_available() is False)")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {device} ({name})")
    f64 = torch.float64

    ds = generate_data_fem(torch.Generator().manual_seed(0), fh, n_sam=n_sam, ne_sam=8,
                           device=device, d_y=1, sig_e=SIG_E, sig_eta=SIG_ETA)
    ynorm = (ds.y_data.mean(0), ds.y_data.std(0))
    cfg = ProblemConfig(theta_dim=2, y_dim=1, z_dim=1, sig_e=SIG_E, sig_eta=SIG_ETA)
    batch_f = lambda th: fh(th)[0]  # noqa: E731
    y_all = torch.as_tensor(ds.y_data, dtype=f64, device=device)
    e_eval = draw_normal(torch.Generator().manual_seed(99), (128, 2), f64, device)

    summary = {"config": {"n_sam": n_sam, "epochs1": epochs1, "a": A_BANANA, "sig_e": SIG_E},
               "device": name}
    trainers, nets = {}, {}
    for fam in FAMILIES:
        # fresh base draws every batch: with the dataset's eight fixed draws
        # the flow fits those eight points and its fresh-draw ELBO blows up
        tcfg = TrainConfig(batch_size=64, num_epoch1=epochs1, num_epoch2=epochs2,
                           pairing="per_sample", posterior=fam, resample_e=True)
        tr = TwoStepTrainer(None, cfg, tcfg, fh_batch=fh, device=device, y_norm=ynorm)
        t0 = time.time()
        net, _, _ = tr.train_step1(ds.y_data, ds.e_data, torch.Generator().manual_seed(2))
        wall = time.time() - t0
        with torch.no_grad():
            if fam == "flow":
                elbo = float(make_loss_step1_flow(batch_f, SIG_E)(y_all, net(y_all, e_eval)))
            else:
                elbo = float(make_loss_step1_fullcov(batch_f, e_eval, SIG_E)(y_all, net(y_all)))
        trainers[fam], nets[fam] = tr, net
        summary[fam] = {"full_data_elbo_loss": elbo, "step1_wall_s": wall,
                        "steps_per_sec": epochs1 * -(-n_sam // 64) / wall}
        print(f"[{fam}] full-data ELBO loss {elbo:.4f}  ({wall:.1f}s)", flush=True)

    ex0, gr0 = exact_posterior_stats(ds.y_data[0]), exact_check_2d_grid(ds.y_data[0])
    summary["exact_vs_2dgrid"] = {"mean2_diff": abs(ex0["mean"][1] - gr0["mean2"]),
                                  "std2_reldiff": abs(ex0["std"][1] - gr0["std2"]) / gr0["std2"]}
    print(f"exact-quadrature vs 2-D grid: {summary['exact_vs_2dgrid']}")
    per_obs = []
    for i in range(n_hmc_obs):
        y_obs = ds.y_data[i]
        ex = exact_posterior_stats(y_obs)
        t0 = time.time()
        res = hmc(torch.Generator().manual_seed(100 + i), make_fem_logpost(fh, y_obs, SIG_E),
                  d=2, n_samples=4000, burn=2000, n_chains=8, step_size=0.05, n_leapfrog=32,
                  device=device)
        hmc_s = time.time() - t0
        sam = res.samples.reshape(-1, 2)
        rhat = np.asarray(res.rhat).ravel()
        # theta2's R-hat decides whether the chain is trusted: theta1's
        # chains split between the two mirror modes by construction
        row = {"y": float(y_obs[0]), "exact_mean": ex["mean"], "exact_std": ex["std"],
               "exact_mean_abs1": ex["mean_abs1"], "exact_std_abs1": ex["std_abs1"],
               "exact_q10_theta2": ex["q10_theta2"], "exact_q90_theta2": ex["q90_theta2"],
               "hmc_rhat": rhat.tolist(), "hmc_rhat_theta2": float(rhat[1]),
               "hmc_converged": bool(rhat[1] < 1.05), "hmc_s": hmc_s,
               "hmc_mean": sam.mean(0).tolist(), "hmc_std": sam.std(0).tolist(),
               "hmc_q10_theta2": float(np.quantile(sam[:, 1], 0.1)),
               "hmc_q90_theta2": float(np.quantile(sam[:, 1], 0.9)),
               "hmc_mean_abs1": float(np.mean(np.abs(sam[:, 0]))),
               "hmc_std_abs1": float(np.std(np.abs(sam[:, 0])))}
        y_i = ds.y_data[i:i + 1]
        for fam in FAMILIES:
            tr, net = trainers[fam], nets[fam]
            e = draw_normal(torch.Generator().manual_seed(200 + i), (4096, 2), f64, device)
            with torch.no_grad():
                th = tr.sample_theta(net, y_i, e)[0].cpu().numpy()
            if fam == "flow":
                m, v = flow_moments(net, y_i, torch.Generator().manual_seed(200 + i), n_mc=4096)
            else:
                m, L = tr.predict_cholesky(net, y_i)
                v = torch.sum(L**2, dim=-1)
            row[f"{fam}_mean"] = m[0].cpu().numpy().tolist()
            row[f"{fam}_std"] = np.sqrt(v[0].cpu().numpy()).tolist()
            row[f"{fam}_q10_theta2"] = float(np.quantile(th[:, 1], 0.1))
            row[f"{fam}_q90_theta2"] = float(np.quantile(th[:, 1], 0.9))
            row[f"{fam}_mean_abs1"] = float(np.mean(np.abs(th[:, 0])))
            row[f"{fam}_std_abs1"] = float(np.std(np.abs(th[:, 0])))
        per_obs.append(row)
        print(f"obs {i}: y={row['y']:.2f}  exact mean {row['exact_mean']}  flow "
              f"{row['flow_mean']}  fullcov {row['fullcov_mean']}  rhat2 "
              f"{row['hmc_rhat_theta2']:.3f} (HMC {hmc_s:.1f}s)", flush=True)

    summary["vs_exact"] = {fam: agg(fam, "exact", per_obs) for fam in FAMILIES}
    conv = [r for r in per_obs if r["hmc_converged"]]
    summary["vs_hmc"] = {"n_converged": len(conv), "n_total": len(per_obs),
                         **({fam: agg(fam, "hmc", conv) for fam in FAMILIES} if conv else {})}
    if conv:
        summary["vs_hmc"]["hmc_vs_exact"] = agg("hmc", "exact", conv)
    # family std / exact std: 1 is calibrated, below 1 overconfident
    summary["calibration_std_ratio"] = {
        fam: {"theta1_abs": float(np.mean([r[f"{fam}_std_abs1"] / r["exact_std_abs1"]
                                           for r in per_obs])),
              "theta2": float(np.mean([r[f"{fam}_std"][1] / r["exact_std"][1]
                                       for r in per_obs]))}
        for fam in (*FAMILIES, "hmc")}
    summary["per_obs"] = per_obs

    t0 = time.time()
    res2 = trainers["flow"].fit(ds.y_data, ds.e_data, torch.Generator().manual_seed(5),
                                epochs1=epochs1, epochs2=epochs2)
    summary["flow"]["step2_final_loss"] = float(res2.hist_step2[-1])
    summary["flow"]["two_step_wall_s"] = time.time() - t0

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps({k: summary[k] for k in ("vs_exact", "vs_hmc", "calibration_std_ratio")},
                     indent=2))
    print(f"flow step2 final loss {summary['flow']['step2_final_loss']:.3e}")
    print(f"wrote {args.out}/summary.json")


if __name__ == "__main__":
    main()
