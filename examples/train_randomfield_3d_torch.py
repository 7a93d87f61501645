"""3-D random-field material inversion with the PyTorch port
(``vbicm_tpu_torch``), end-to-end amortized VI.

The counterpart of ``examples/train_randomfield_3d.py``: a 12-mode KL
log-modulus field (corr_len 3) on the 32x8x8 hex8 cantilever (8,019 dofs),
inferred from the displacements of 24 nodes over the free half of the beam
(y_dim 72) through the field solver in structured-grid mode (``grid=(nx,
ny, nz)``: reshapes, 8 shifted slices and padded adds, no index tables),
float32 CG at tol 3e-3 plus one float64 refinement, preconditioned by the
mean-field two-level box cycle (``prob.randomfield.
make_mean_field_preconditioner_box3d``: the spectral kernel's coarse solve
on the 8x2x2 box, 216 free dofs, at E0, trilinear transfers). Training and
the checks after it are those of ``examples/train_randomfield_torch.py``
(its ``train`` and ``evaluate``); the XDMF export is not ported.

    python examples/train_randomfield_3d_torch.py --device cuda --n-data 256 --epochs1 2 --epochs2 2 --mcmc-check 1
"""
# Allow running directly from a repo checkout without installation.
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
_sys.path.insert(0, _os.path.dirname(_os.path.abspath(__file__)))
del _os, _sys
import argparse

import numpy as np

import train_randomfield_torch as field_example


def build(nx, ny, nz, *, n_modes=12, corr_len=3.0, sigma=0.3, ratio=4, device):
    """The 32x8x8 field problem: (model, kl, cfg, probes, fh), fh the
    trainer's observation operator."""
    import torch

    from vbicm_tpu_torch.config import ProblemConfig, SectionCard
    from vbicm_tpu_torch.mesh import beam_hex8_mesh
    from vbicm_tpu_torch.model import build_fem_model
    from vbicm_tpu_torch.prob.randomfield import (
        build_kl_expansion,
        make_fh_fun_field,
        make_mean_field_preconditioner_box3d,
    )

    if nx % ratio or ny % ratio or nz % ratio:
        raise SystemExit(f"--nx/--ny/--nz must be divisible by --ratio={ratio} (the mean-field "
                         "preconditioner coarsens the structured grid)")
    lx = float(nx) / 4.0
    sec = SectionCard(stype=4)
    model = build_fem_model(beam_hex8_mesh(nx, ny, nz, lx=lx), sec, device=device, dense=False)
    coarse = build_fem_model(beam_hex8_mesh(nx // ratio, ny // ratio, nz // ratio, lx=lx), sec,
                             device=device, dense=True)
    kl = build_kl_expansion(model, n_modes=n_modes, corr_len=corr_len, sigma=sigma)
    # probe nodes over the free half of the beam (the fixed face carries no
    # signal); 3 dofs each
    NX, NY, NZ = nx + 1, ny + 1, nz + 1
    iis = np.linspace(NX // 2, NX - 1, 6).astype(int)
    probes = np.array([(k * NY + j) * NX + i + 1 for k in (0, NZ - 1) for j in (0, NY - 1)
                       for i in iis])
    cfg = ProblemConfig(theta_dim=n_modes, y_dim=3 * len(probes),
                        ele_id=(nz // 2 * ny + ny // 2) * nx + nx // 4, nipt_id=(1, 5),
                        sig_e=1e-3, sig_eta=1e-4)
    prec = make_mean_field_preconditioner_box3d(
        coarse, (nx // ratio, ny // ratio, nz // ratio), ratio, model.free_mask, nu=0.3,
        E0=float(np.exp(kl.mean_log)))
    fh = make_fh_fun_field(model, kl, cfg, probe_nodes=probes, cg_dtype=torch.float32,
                           refine_iters=1, tol=3e-3, preconditioner=prec, grid=(nx, ny, nz))
    return model, kl, cfg, probes, fh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=32)
    ap.add_argument("--ny", type=int, default=8)
    ap.add_argument("--nz", type=int, default=8)
    field_example.add_common_args(ap, n_modes=12, corr_len=3.0,
                                  results="results_randomfield_3d_torch", epochs1=60, epochs2=20)
    args = ap.parse_args(argv)
    field_example.run(args, lambda device: build(args.nx, args.ny, args.nz, n_modes=args.n_modes,
                                                 corr_len=args.corr_len, sigma=args.sigma,
                                                 ratio=args.ratio, device=device),
                      "3-D field VI")


if __name__ == "__main__":
    main()
