"""Forward Cook's-membrane analysis through the PyTorch port's public API
(the counterpart of ``examples/cooks_forward.py``): build the 20x10 model in
float64, solve, and report the tip displacement, the von Mises probe
(element 12, quadrature points 1 and 3) and the vertical reaction balance.
The reference's values: ux = -4.079366248, uy = +5.541032680, von Mises
[0.25636391 0.23271123].

    python examples/cooks_forward_torch.py --device cuda
"""
# Allow running directly from a repo checkout without installation.
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
del _os, _sys
import argparse


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args()

    import torch

    from vbicm_tpu_torch import MaterialCard, build_fem_model, fea_solution
    from vbicm_tpu_torch.mesh import cooks_membrane_mesh
    from vbicm_tpu_torch.ops.element import lame_from_Ev
    from vbicm_tpu_torch.solver import probe_von_mises

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no GPU is available (torch.cuda.is_available() is False)")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {device} ({name})")

    model = build_fem_model(cooks_membrane_mesh(20, 10), device=device, dtype=torch.float64)
    mat = MaterialCard(E=20.0, v=0.3)
    sol = fea_solution(model, mat)
    u = sol.u.cpu().numpy()
    print(f"tip (node 231) displacement: ux={u[460]:+.9f}  uy={u[461]:+.9f}")
    lam, mu = (torch.tensor(c, dtype=torch.float64, device=device)
               for c in lame_from_Ev(mat.E, mat.v))
    vm = probe_von_mises(model, sol.u, lam, mu, 12, (1, 3))
    print(f"von Mises @ elem 12, qpts (1,3): {vm.cpu().numpy()}")
    print(f"reaction balance (sum Ry): {sol.reactions.cpu().numpy()[1::2].sum():+.6f}")


if __name__ == "__main__":
    main()
