"""Hash and time the banded tensor-core stencil's outputs of the package at
--root, to compare two trees bit for bit in one call on one GPU.

At chip_smoke.py's phase 25 grids (Cook's 8x4, 32x16, 160x80) and batches
(1, 5, 64, 128, 256, 300), in both modes (bf16x3 and f32), the inputs made
from a seed as phase 25 makes them: prints one JSON line with the card, and
for each case the first 16 hex digits of q's sha256 and the kernel's device
time (CUDA-graph replay, the best of three). Run it once per tree, in
alternation:

    python tools/mxu_parity.py --root build/parent   # an earlier commit, unpacked
    python tools/mxu_parity.py --root .
"""
import argparse
import hashlib
import json
import os
import sys

import numpy as np

GRIDS = [(8, 4), (32, 16), (160, 80)]
BATCHES = [1, 5, 64, 128, 256, 300]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="checkout whose vbicm_tpu_torch is timed")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    import vbicm_tpu_torch
    from vbicm_tpu_torch.mesh import cooks_membrane_mesh
    from vbicm_tpu_torch.model import build_fem_model
    from vbicm_tpu_torch.ops import stencil_mxu
    from vbicm_tpu_torch.ops.stencil import build_stencil_tables
    from vbicm_tpu_torch.utils.timing import card_line, graph_time_s

    if not torch.cuda.is_available():
        sys.exit("mxu_parity: needs a GPU")
    if not os.path.abspath(vbicm_tpu_torch.__file__).startswith(root):
        sys.exit(f"mxu_parity: imported {vbicm_tpu_torch.__file__}, not the tree at {root}")
    dev = torch.device("cuda", 0)
    out = {"root": args.root, "card": card_line()}
    kernel = stencil_mxu.stencil_affine_matvec_mxu
    for nx, ny in GRIDS:
        NY, NX = ny + 1, nx + 1
        model = build_fem_model(cooks_membrane_mesh(nx, ny), device=dev, dense=False)
        W = build_stencil_tables(model, nx, ny)
        tables = {"f32": stencil_mxu.pack_w_bands(W, "f32").to(dev),
                  "bf16x3": tuple(m.to(dev) for m in stencil_mxu.pack_w_bands(W, "bf16x3"))}
        for B in BATCHES:
            rng = np.random.default_rng(B + nx + 25)
            u = torch.as_tensor(rng.normal(size=(B, 2 * NY * NX)), device=dev).float()
            c = torch.as_tensor(rng.uniform(1.0, 3.0, (B, 2)), device=dev).float()
            for mode, mb in tables.items():
                q = kernel(mb, c, u, NY, NX, mode)
                sha = hashlib.sha256(q.cpu().numpy().tobytes()).hexdigest()[:16]
                ms = min(graph_time_s(lambda: kernel(mb, c, u, NY, NX, mode))
                         for _ in range(3)) * 1e3
                out[f"{nx}x{ny} B={B} {mode}"] = {"sha256": sha, "ms": ms}
        del tables
    print(json.dumps(out))


if __name__ == "__main__":
    main()
