"""Hash and time the element kernel's outputs of the package at --root, to
compare two trees bit for bit in one call on one GPU.

At Cook's 160x80 (B = 8, 16, 256; float32 and float64) and a renumbered
160x80 (B = 256, float32), the inputs made from a seed as chip_smoke.py's
phase 18 makes them: prints one JSON line with the card, and for each case
the first 16 hex digits of q's sha256 and the kernel's device time (CUDA-
graph replay, the best of three). Run it once per tree, in alternation:

    python tools/element_parity.py --root build/parent   # an earlier commit, unpacked
    python tools/element_parity.py --root .
"""
import argparse
import hashlib
import json
import os
import sys

import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="checkout whose vbicm_tpu_torch is timed")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    import vbicm_tpu_torch
    from vbicm_tpu_torch import mesh as meshes
    from vbicm_tpu_torch.model import build_fem_model
    from vbicm_tpu_torch.ops.element_kernel import ElementOperator
    from vbicm_tpu_torch.utils.timing import card_line, graph_time_s

    if not torch.cuda.is_available():
        sys.exit("element_parity: needs a GPU")
    if not os.path.abspath(vbicm_tpu_torch.__file__).startswith(root):
        sys.exit(f"element_parity: imported {vbicm_tpu_torch.__file__}, not the tree at {root}")
    dev = torch.device("cuda", 0)
    out = {"root": args.root, "card": card_line()}
    f32, f64 = torch.float32, torch.float64
    for name, mesh, batches, dtypes in (
            ("160x80", meshes.cooks_membrane_mesh(160, 80), (8, 16, 256), (f32, f64)),
            ("160x80 renumbered",
             meshes.renumber_mesh(meshes.cooks_membrane_mesh(160, 80), seed=3), (256,), (f32,))):
        m = build_fem_model(mesh, device=dev, dense=False)
        op = ElementOperator(torch.stack([m.ke_lam, m.ke_mu]), m.lm, m.ndof)
        for B in batches:
            rng = np.random.default_rng(B + m.ndof)
            u64 = torch.as_tensor(rng.normal(size=(B, m.ndof)), device=dev)
            c64 = torch.as_tensor(rng.uniform(1.0, 3.0, (B, 2)), device=dev)
            for dtype in dtypes:
                u, c = u64.to(dtype), c64.to(dtype)
                q = op.affine(c, u).cpu().numpy()
                ms = min(graph_time_s(lambda: op.affine(c, u)) for _ in range(3)) * 1e3
                out[f"{name} B={B} {str(dtype)[6:]}"] = {
                    "sha256": hashlib.sha256(q.tobytes()).hexdigest()[:16], "ms": ms}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
