"""Two-step VI training script for the PyTorch port (``vbicm_tpu_torch``):
generate (or load, ``--dataset``) the dataset through the FEM, fit
q(theta|y), bridge, fit p(z|y), and save checkpoints and the loss histories
in ``--results``. The generated dataset is written to
``data_fem_generated.h5`` and the histories to ``train_hist.h5``, as the JAX
example writes them, when h5py imports; else to ``.npz`` files of the same
fields.

    python examples/train_vi_torch.py --device cuda --n-data 1024 --epochs1 3 --epochs2 3
"""
# Allow running directly from a repo checkout without installation.
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
del _os, _sys
import argparse
import os
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-data", type=int, default=1000)
    ap.add_argument("--ne-sam", type=int, default=4)
    ap.add_argument("--epochs1", type=int, default=20)
    ap.add_argument("--epochs2", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--dataset", type=str, default=None,
                    help="dataset to load instead of generating (.h5, or .npz)")
    ap.add_argument("--results", type=str, default="results_vi_torch")
    ap.add_argument("--x64", action="store_true", default=True)
    ap.add_argument("--f32", dest="x64", action="store_false")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args()

    import torch

    from vbicm_tpu_torch.config import ProblemConfig, TrainConfig
    from vbicm_tpu_torch.mesh import cooks_membrane_mesh
    from vbicm_tpu_torch.model import build_fem_model
    from vbicm_tpu_torch.prob.datagen import generate_data_fem, load_dataset, save_dataset
    from vbicm_tpu_torch.solver import make_fh_fun
    from vbicm_tpu_torch.vi.train import TwoStepTrainer

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no GPU is available (torch.cuda.is_available() is False)")
    dtype = torch.float64 if args.x64 else torch.float32
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {device} ({name})")

    model = build_fem_model(cooks_membrane_mesh(20, 10), device=device, dtype=dtype)
    cfg = ProblemConfig()
    fh = make_fh_fun(model, cfg, factor_dtype=torch.float32, refine_iters=1)
    try:
        import h5py  # noqa: F401

        suffix = ".h5"
    except ImportError:
        suffix = ".npz"
    if args.dataset:
        ds = load_dataset(args.dataset)
        print(f"loaded {ds.n_sam} samples, {ds.ne_sam} reparam seeds from {args.dataset}")
    else:
        t0 = time.time()
        ds = generate_data_fem(
            torch.Generator().manual_seed(args.seed), fh,
            n_sam=args.n_data, ne_sam=args.ne_sam, device=device,
            sig_e=cfg.sig_e, sig_eta=cfg.sig_eta, chunk=4096, dtype=dtype,
        )
        print(f"generated {args.n_data} data points in {time.time()-t0:.1f}s")
        save_dataset(ds, "data_fem_generated" + suffix)

    tcfg = TrainConfig(batch_size=args.batch_size, num_epoch1=args.epochs1,
                       num_epoch2=args.epochs2)
    trainer = TwoStepTrainer(model, cfg, tcfg, fh_batch=fh, dtype=dtype,
                             results_path=args.results, verbose=True)
    t0 = time.time()
    res = trainer.fit(ds.y_data, ds.e_data, torch.Generator().manual_seed(args.seed + 1))
    print(f"total training time: {time.time()-t0:.1f}s")
    print(f"final step1 loss: {res.hist_step1[-1]:.6f}  (reference @20 epochs: 3.8168)")
    print(f"final step2 loss: {res.hist_step2[-1]:.3e}  (reference @20 epochs: 2.247e-05)")

    hist_path = os.path.join(args.results, "train_hist" + suffix)
    if suffix == ".h5":
        import h5py

        with h5py.File(hist_path, "w") as f:
            f["train_loss_step1"] = res.hist_step1
            f["train_loss_step2"] = res.hist_step2
    else:
        np.savez(hist_path, train_loss_step1=res.hist_step1, train_loss_step2=res.hist_step2)


if __name__ == "__main__":
    main()
