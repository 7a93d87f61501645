"""Postprocess / evaluation script for the PyTorch port (``vbicm_tpu_torch``):
the counterpart of ``examples/postprocess_vi.py``, on the GPU. It quickly
trains a VI model on Cook's membrane 20x10 (float64, per-sample pairing),
then writes

  * the deformed-mesh plot of the forward solve,
  * the VI predictive density against the MCMC posterior-predictive density
    (heatmaps), the MCMC reference being a real Metropolis chain through
    the FEM,
  * KLD(MCMC || VI).

Left out against the JAX example: the XDMF export of the forward solve
(``eval/xdmf.py``, ROADMAP Queue 1 item 10). The plots need matplotlib;
where it is not installed they are skipped, and the density grids are
written to ``densities.npz`` either way.

    python examples/postprocess_vi_torch.py --device cuda
"""
# Allow running directly from a repo checkout without installation.
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
del _os, _sys
import argparse
import importlib.util
import os

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results_postprocess_torch")
    ap.add_argument("--quick-train-epochs", type=int, default=40)
    ap.add_argument("--n-data", type=int, default=512)
    ap.add_argument("--mcmc-samples", type=int, default=2000)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args()

    import torch

    from vbicm_tpu_torch.config import MaterialCard, ProblemConfig, TrainConfig
    from vbicm_tpu_torch.eval.mcmc import make_fem_logpost, metropolis, posterior_predictive_z
    from vbicm_tpu_torch.eval.postprocess import (
        gaussian_kde_pdf,
        kld_gaussian_kde,
        lognormal_pdf_2d,
        plot_deformed_mesh,
    )
    from vbicm_tpu_torch.mesh import cooks_membrane_mesh
    from vbicm_tpu_torch.model import build_fem_model
    from vbicm_tpu_torch.prob.datagen import generate_data_fem
    from vbicm_tpu_torch.solver import fea_solution, make_fh_fun
    from vbicm_tpu_torch.vi.train import TwoStepTrainer

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no GPU is available (torch.cuda.is_available() is False)")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {device} ({name})")

    os.makedirs(args.out, exist_ok=True)
    plots = importlib.util.find_spec("matplotlib") is not None
    if not plots:
        print("matplotlib is not installed: the plots are skipped")
    model = build_fem_model(cooks_membrane_mesh(20, 10), device=device, dtype=torch.float64)
    cfg = ProblemConfig()

    # --- forward postprocess -------------------------------------------
    sol = fea_solution(model, MaterialCard())
    if plots:
        plot_deformed_mesh(model, sol.u, mag=1.0, path=f"{args.out}/deformed_shape.png")
        print(f"wrote {args.out}/deformed_shape.png")

    # --- quick VI train + MCMC comparison -------------------------------
    fh = make_fh_fun(model, cfg)
    ds = generate_data_fem(torch.Generator().manual_seed(0), fh, n_sam=args.n_data, ne_sam=8,
                           device=device, sig_e=cfg.sig_e, sig_eta=cfg.sig_eta)
    tcfg = TrainConfig(batch_size=64, num_epoch1=args.quick_train_epochs,
                       num_epoch2=args.quick_train_epochs, pairing="per_sample")
    trainer = TwoStepTrainer(model, cfg, tcfg, fh_batch=fh)
    res = trainer.fit(ds.y_data, ds.e_data, torch.Generator().manual_seed(1))

    y_test = ds.y_data[1]
    _, _, zm, zs = trainer.predict(res.theta_net, res.z_net, y_test[None])
    zm, zs = zm[0].cpu().numpy(), zs[0].cpu().numpy()

    logpost = make_fem_logpost(fh, y_test, cfg.sig_e)
    mc = metropolis(torch.Generator().manual_seed(2), logpost, d=2,
                    n_samples=args.mcmc_samples // 8, burn=400, n_chains=8, step_size=0.6,
                    device=device)
    theta_s = mc.samples.reshape(-1, 2)
    z_mc = posterior_predictive_z(torch.Generator().manual_seed(3), fh, theta_s, cfg.sig_eta,
                                  device=device)

    # density grids around the VI predictive (the reference's plotting ranges)
    mf = 3.0
    xs = np.linspace(np.exp(zm[0] - mf * np.sqrt(zs[0])), np.exp(zm[0] + mf * np.sqrt(zs[0])), 80)
    ys = np.linspace(np.exp(zm[1] - mf * np.sqrt(zs[1])), np.exp(zm[1] + mf * np.sqrt(zs[1])), 80)
    XG, YG = np.meshgrid(xs, ys)
    pts = np.stack([XG.ravel(), YG.ravel()], axis=1)
    pdf_mcmc = gaussian_kde_pdf(z_mc, pts).reshape(XG.shape)
    pdf_vi = lognormal_pdf_2d(pts, zm, zs).reshape(XG.shape)
    np.savez(f"{args.out}/densities.npz", z1=XG, z2=YG, pdf_mcmc=pdf_mcmc, pdf_vi=pdf_vi)

    if plots:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 2, figsize=(11, 4.5), sharex=True, sharey=True)
        for ax, pdf, title in [
            (axes[0], pdf_mcmc, "MCMC posterior predictive (reference)"),
            (axes[1], pdf_vi, "VI lognormal predictive"),
        ]:
            c = ax.pcolormesh(XG, YG, pdf, shading="gouraud", vmin=0, vmax=pdf_mcmc.max())
            ax.set_xlabel("z1 (von Mises @ qpt 1)")
            ax.set_title(title)
            fig.colorbar(c, ax=ax)
        axes[0].set_ylabel("z2 (von Mises @ qpt 3)")
        fig.savefig(f"{args.out}/prediction_pdf.png", dpi=150, bbox_inches="tight")
        print(f"wrote {args.out}/prediction_pdf.png")

    kld = kld_gaussian_kde(z_mc, lambda p: lognormal_pdf_2d(p, zm, zs))
    print(f"MCMC chain: accept rate {mc.accept_rate:.3f}, R-hat {mc.rhat}, ESS {mc.ess}")
    print(f"VI predictive moments: mean {zm}, var {zs}")
    print(f"MCMC predictive log-z mean: {np.log(z_mc).mean(axis=0)}")
    print(f"KLD(MCMC || VI) = {kld:.4f}")
    print(f"wrote {args.out}/densities.npz")


if __name__ == "__main__":
    main()
