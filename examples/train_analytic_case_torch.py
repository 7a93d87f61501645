"""VI on the reference's analytic validation cases with the PyTorch port
(``vbicm_tpu_torch``), no FEM: the counterpart of
``examples/train_analytic_case.py``.

Case 1 (linear) and case 2 (quadratic observation) fit q(theta|y) by the
step-1 ELBO on closed-form forward maps; case 3 (2-D) runs the full
two-step trainer with the analytic map as its batched observation
operator (``fh_batch=``). Case 1 has a closed-form posterior, so the script
reports the analytic check:

    q(theta | y) = N( 2y / (4 + sig_e), 1 / (1 + 4/sig_e) )

    python examples/train_analytic_case_torch.py --device cuda --case 1
"""
# Allow running directly from a repo checkout without installation.
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
del _os, _sys
import argparse
import math

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--case", type=int, default=1, choices=[1, 2, 3])
    ap.add_argument("--n-data", type=int, default=2048)
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args()

    import torch

    from vbicm_tpu_torch.models.mlp import ThetaPosteriorNet
    from vbicm_tpu_torch.prob.analytic import f_fun_1d_case1, f_fun_1d_case2
    from vbicm_tpu_torch.vi.elbo import make_loss_step1

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no GPU is available (torch.cuda.is_available() is False)")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {device} ({name})")

    if args.case == 3:
        # 2-D case 3: the full two-step pipeline on the analytic forward map
        from vbicm_tpu_torch.config import ProblemConfig, TrainConfig
        from vbicm_tpu_torch.prob.analytic import (
            f_fun_2d_case3,
            generate_data_2d_case3,
            h_fun_2d_case3,
        )
        from vbicm_tpu_torch.vi.train import TwoStepTrainer

        ds = generate_data_2d_case3(torch.Generator().manual_seed(0), args.n_data)

        def fh(theta):
            return f_fun_2d_case3(theta), h_fun_2d_case3(theta)

        # the quartic f2 = x^4 + x + 1 makes the reparameterized gradients
        # explode at the reference lr; at the JAX example's 2e-4 step 1
        # still diverges for some seeds, in both packages alike (their
        # updates agree step for step on the same batches). alpha = 0:
        # case 3's h spans 0.2..2e5, so step 2 trains on the moment-matching
        # loss alone
        tcfg = TrainConfig(batch_size=256, num_epoch1=args.epochs, num_epoch2=args.epochs,
                           pairing="per_sample", lr=2e-4, alpha=0.0)
        trainer = TwoStepTrainer(None, ProblemConfig(), tcfg, fh_batch=fh, device=device,
                                 verbose=True)
        res = trainer.fit(ds.y_data, ds.e_data, torch.Generator().manual_seed(1))
        print(f"case 3 (2-D): step1 {res.hist_step1[-1]:.4f}, step2 {res.hist_step2[-1]:.3e}")
        tm, tsg, zm, zs = (t.cpu().numpy()
                           for t in trainer.predict(res.theta_net, res.z_net, ds.y_data[:3]))
        print("theta posterior @3 test y:", tm.round(3))
        print("z predictive mean        :", np.exp(0.5 * zs + zm).round(3))
        return

    sig_e = 0.1
    f_fun = f_fun_1d_case1 if args.case == 1 else f_fun_1d_case2
    gen = torch.Generator().manual_seed(0)
    dt = torch.float64
    theta = torch.randn((args.n_data, 1), generator=gen, dtype=dt)
    y = (f_fun(theta) + math.sqrt(sig_e) * torch.randn((args.n_data, 1), generator=gen,
                                                       dtype=dt)).to(device)
    e_data = torch.randn((8, 1), generator=gen, dtype=dt).to(device)

    net = ThetaPosteriorNet(y_dim=1, theta_dim=1, dtype=dt, device=device)
    net.reset_parameters(gen)
    loss_fn = make_loss_step1(f_fun, e_data, sig_e, pairing="per_sample")
    opt = torch.optim.Adam(net.parameters(), lr=1e-3, betas=(0.99, 0.999), eps=1e-10)

    n, bs = args.n_data, 256
    for _ in range(args.epochs):
        ys = y[torch.randperm(n, generator=gen).to(device)]
        for b in range(n // bs):
            yb = ys[b * bs:(b + 1) * bs]
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(yb, net(yb))
            loss.backward()
            opt.step()
    print(f"case {args.case}: final ELBO loss {float(loss.detach()):.4f}")

    y_test = torch.tensor([[1.0], [0.0], [-2.0]], dtype=dt, device=device)
    with torch.no_grad():
        tm, tsig, _ = net(y_test)
    tm, tsig, yt = tm.cpu().numpy().ravel(), tsig.cpu().numpy().ravel(), y_test.cpu().numpy().ravel()
    print("y_test        :", yt)
    print("VI mean       :", tm.round(4))
    print("VI std        :", np.sqrt(tsig).round(4))
    if args.case == 1:
        mu_true = 2 * yt / (4 + sig_e)
        sd_true = np.sqrt(1 / (1 + 4 / sig_e))
        print("analytic mean :", mu_true.round(4))
        print(f"analytic std  : {sd_true:.4f}")
        print(f"max |mean error| = {np.abs(tm - mu_true).max():.4f}")


if __name__ == "__main__":
    main()
