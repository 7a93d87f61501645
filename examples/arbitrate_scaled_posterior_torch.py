"""Arbitrate the full-order vs ROM posterior theta-mean gap at 160x80 with
the PyTorch port (``vbicm_tpu_torch``).

The counterpart of ``examples/arbitrate_scaled_posterior.py``. The two-step
nets trained through the full-order two-level stencil solver and through the
certified reduced basis (solve agreement ~1e-7) can disagree on the theta
mean by more than the solves do. One of three explanations holds: (a) the
ROM biases the posterior, (b) the bridge and step 2 amplify tiny fh
differences, (c) training noise (theta is weakly identified, so two trained
nets place the mean anywhere in a noise ball wider than the signal). This
script decides it by measurement:

  1. train both paths on the same dataset from the same seed;
  2. train the ROM path again with another training seed only: the
     seed-to-seed theta-mean rmse is the training-noise floor, and a
     full-vs-ROM gap at that floor is (c);
  3. exact-posterior probes: on the observations where the nets disagree
     most (and evenly spaced ones), per-observation refinement
     (``vi.refine``, full covariance) from a neutral init through the ROM
     and, on the first three, through the full-order operator too; each
     net's distance to the refined mean, in refined stds, says which path
     (if either) is biased.

Writes an ``arbitration`` block into ``--results``/summary.json.
``--resume`` reuses the keyed dataset cache and goes on from each run's
trainer checkpoints. The JAX example's defences against its TPU worker's
crashes (scan chunks, chunk checkpoints, the probe journal) are not ported.

    python examples/arbitrate_scaled_posterior_torch.py --device cuda --n-data 256 --epochs1 2 --epochs2 2 --n-probe 2 --refine-steps 100
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
    ap.add_argument("--nx", type=int, default=160)
    ap.add_argument("--ny", type=int, default=80)
    ap.add_argument("--n-data", type=int, default=10000)
    ap.add_argument("--epochs1", type=int, default=20)
    ap.add_argument("--epochs2", type=int, default=20)
    ap.add_argument("--n-probe", type=int, default=16,
                    help="observations probed with exact-posterior refinement")
    ap.add_argument("--refine-steps", type=int, default=2000)
    ap.add_argument("--results", type=str, default="results_scaled_fullorder_torch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", action="store_true",
                    help="reuse the dataset cache and the trainers' checkpoints in --results")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    import torch

    from vbicm_tpu_torch.config import ProblemConfig, TrainConfig
    from vbicm_tpu_torch.mesh import cooks_membrane_mesh
    from vbicm_tpu_torch.model import build_fem_model
    from vbicm_tpu_torch.prob.datagen import cached_dataset, generate_data_fem
    from vbicm_tpu_torch.rom import build_reduced_basis, make_fh_fun_rom
    from vbicm_tpu_torch.solver import make_fh_fun, make_two_level_solver
    from vbicm_tpu_torch.vi.refine import refine_posterior
    from vbicm_tpu_torch.vi.train import TwoStepTrainer

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no GPU is available (torch.cuda.is_available() is False)")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {device} ({name})")

    t0 = time.time()
    model = build_fem_model(cooks_membrane_mesh(args.nx, args.ny), device=device, dense=False)
    coarse = build_fem_model(cooks_membrane_mesh(args.nx // 4, args.ny // 4), device=device,
                             dense=True)
    cfg = dataclasses.replace(ProblemConfig(), node_id=model.nnodes,
                              ele_id=(args.ny // 2) * args.nx + 12)
    solve2l = make_two_level_solver(model, coarse, args.nx // 4, args.ny // 4, 4,
                                    cg_dtype=torch.float32, refine_iters=1, tol=3e-3, maxiter=400,
                                    use_stencil=True, refine_residual="split_f32")
    fh = make_fh_fun(model, cfg, solve_free=solve2l)
    rb = build_reduced_basis(model, tol=1e-10)
    fh_rom = make_fh_fun_rom(model, rb, cfg)
    print(f"model + solver + ROM (r={rb.r}) in {time.time() - t0:.1f}s")

    # the same dataset as train_scaled_fullorder_torch.py (same seed, sizes)
    t0 = time.time()
    os.makedirs(args.results, exist_ok=True)
    ds, cached = cached_dataset(
        os.path.join(args.results, "dataset_cache.npz"),
        {"seed": args.seed, "n_data": args.n_data, "ne_sam": 4, "mesh": f"{args.nx}x{args.ny}"},
        lambda: generate_data_fem(torch.Generator().manual_seed(args.seed), fh,
                                  n_sam=args.n_data, ne_sam=4, device=device, sig_e=cfg.sig_e,
                                  sig_eta=cfg.sig_eta, chunk=2048),
        reuse=args.resume)
    print(f"dataset ({'cached' if cached else 'full-order sweep'}) in {time.time() - t0:.1f}s")

    tcfg = TrainConfig(batch_size=64, num_epoch1=args.epochs1, num_epoch2=args.epochs2,
                       ckpt_every=1)

    def train(fh_used, train_seed, tag):
        t0 = time.time()
        tr = TwoStepTrainer(None, cfg, tcfg, fh_batch=fh_used, device=device,
                            results_path=os.path.join(args.results, "arb_ckpt", tag))
        res = tr.fit(ds.y_data, ds.e_data, torch.Generator().manual_seed(train_seed),
                     resume=args.resume)
        print(f"[{tag}] trained in {time.time() - t0:.1f}s (step1 {res.hist_step1[-1]:.4f}, "
              f"step2 {res.hist_step2[-1]:.3e})")
        return res

    res_f = train(fh, args.seed + 1, "fullorder")
    res_r = train(fh_rom, args.seed + 1, "rom")
    res_r2 = train(fh_rom, args.seed + 101, "rom_reseeded")

    y_all = torch.as_tensor(ds.y_data, device=device)
    with torch.no_grad():
        tm_f = res_f.theta_net(y_all)[0]
        tm_r = res_r.theta_net(y_all)[0]
        tm_r2 = res_r2.theta_net(y_all)[0]

    def rmse(a, b):
        return float(torch.sqrt(torch.mean((a - b) ** 2)))

    gap_paths = rmse(tm_f, tm_r)  # full-order vs ROM, same seed
    noise_floor = rmse(tm_r, tm_r2)  # ROM vs ROM, seeds differ only
    scale = float(torch.std(tm_r))
    print(f"theta-mean gap full-vs-ROM (same seed): {gap_paths:.5f}; training-noise floor "
          f"(ROM reseeded): {noise_floor:.5f}; scale across observations: {scale:.5f}")

    # exact-posterior probes where the nets disagree most, plus evenly
    # spaced observations
    dis = torch.linalg.norm(tm_f - tm_r, dim=1).cpu().numpy()
    n_half = args.n_probe // 2
    idx = np.unique(np.concatenate([
        np.argsort(-dis)[:n_half],
        np.linspace(0, ds.n_sam - 1, args.n_probe - n_half).astype(int)]))
    tm_f, tm_r, tm_r2 = (t.cpu().numpy() for t in (tm_f, tm_r, tm_r2))
    zeros = torch.zeros(2, dtype=torch.float64, device=device)
    L_init = 0.3 * torch.eye(2, dtype=torch.float64, device=device)
    probes = []
    t0 = time.time()
    for n, i in enumerate(idx):
        y_obs = y_all[i]
        refine_kw = dict(generator=torch.Generator().manual_seed(1000 + int(i)),
                         steps=args.refine_steps, ne=16, lr=1e-2, chunk_steps=250)
        mu_x, L_x, _ = refine_posterior(lambda th: fh_rom(th)[0], y_obs, cfg.sig_e, zeros,
                                        L_init, **refine_kw)
        mu_x = mu_x.cpu().numpy()
        std_x = np.sqrt(np.diag((L_x @ L_x.T).cpu().numpy()))
        rec = {
            "obs": int(i),
            "exact_mean": mu_x.tolist(),
            "exact_std": std_x.tolist(),
            "zgap_fullorder": (np.abs(tm_f[i] - mu_x) / std_x).tolist(),
            "zgap_rom": (np.abs(tm_r[i] - mu_x) / std_x).tolist(),
            "zgap_rom_reseeded": (np.abs(tm_r2[i] - mu_x) / std_x).tolist(),
        }
        if n < 3:
            # the solve-level check: refinement through the full-order
            # operator from the same init lands on the same exact mean
            refine_kw["generator"] = torch.Generator().manual_seed(1000 + int(i))
            mu_xf, _, _ = refine_posterior(lambda th: fh(th)[0], y_obs, cfg.sig_e, zeros, L_init,
                                           **refine_kw)
            mu_xf = mu_xf.cpu().numpy()
            rec["exact_mean_fullorder_op"] = mu_xf.tolist()
            rec["operator_mean_gap_in_std"] = (np.abs(mu_xf - mu_x) / std_x).tolist()
        probes.append(rec)
        print(f"probe {n}/{len(idx)} obs {i}: zgap_full {rec['zgap_fullorder']} zgap_rom "
              f"{rec['zgap_rom']}")
    probe_s = time.time() - t0
    print(f"probes in {probe_s:.1f}s")

    def agg(key):
        v = np.asarray([p[key] for p in probes])
        return {"mean": float(v.mean()), "max": float(v.max())}

    arb = {
        "theta_mean_gap_full_vs_rom": gap_paths,
        "theta_mean_noise_floor_rom_reseeded": noise_floor,
        "theta_mean_scale": scale,
        "gap_over_noise_floor": gap_paths / max(noise_floor, 1e-30),
        "zgap_fullorder": agg("zgap_fullorder"),
        "zgap_rom": agg("zgap_rom"),
        "zgap_rom_reseeded": agg("zgap_rom_reseeded"),
        "probes": probes,
        "probe_s": probe_s,
        "step1_last": {"fullorder": float(res_f.hist_step1[-1]), "rom": float(res_r.hist_step1[-1]),
                       "rom_reseeded": float(res_r2.hist_step1[-1])},
        "step2_last": {"fullorder": float(res_f.hist_step2[-1]), "rom": float(res_r.hist_step2[-1]),
                       "rom_reseeded": float(res_r2.hist_step2[-1])},
        "device": name,
    }
    if arb["gap_over_noise_floor"] < 2.0:
        arb["verdict"] = ("training noise: the full-vs-ROM gap is within 2x the seed-to-seed "
                          "noise floor of a single path; neither operator biases the posterior")
    elif arb["zgap_fullorder"]["mean"] < arb["zgap_rom"]["mean"]:
        arb["verdict"] = "full-order posterior is closer to exact; ROM path biased"
    else:
        arb["verdict"] = "ROM posterior is closer to exact; full-order path biased"
    print("ARBITRATION:", arb["verdict"])

    spath = os.path.join(args.results, "summary.json")
    summary = {}
    if os.path.exists(spath):
        with open(spath) as f:
            summary = json.load(f)
    summary["arbitration"] = arb
    with open(spath, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"wrote the arbitration block to {spath}")


if __name__ == "__main__":
    main()
