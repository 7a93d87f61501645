"""Time the hat-transfer kernels (csrc/hat_transfer.cu) at every tile of a
sweep, on the card: the restriction's (tz, ty) coarse tiles and the
prolongation's fine lines a block, at the benchmark cells' 160x80 grid and
the 3-D boxes 32x8x8 and 64x16x16 (B = 256, ratio 4), float32 and float64.
Each line gives device ms (CUDA graphs) by tile, fastest first, beside the
byte bound and the tile ``ops/hat_transfer_kernel.py::launch_plan`` picks.

    python3 tools/hat_tiles.py
"""
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (B, coarse cells, ratio, dofs a node), restriction tiles (tz, ty), lines
SWEEP = [
    ((256, (20, 40), 4, 2), [(1, ty) for ty in (1, 2, 3, 4, 5, 6, 7, 11, 21)],
     (1, 2, 4, 6, 8, 12, 16, 27, 81)),
    ((256, (2, 2, 8), 4, 3), [(1, 1), (1, 3), (3, 1), (3, 3)], (1, 4, 9, 20, 27)),
    ((256, (4, 4, 16), 4, 3), [(1, 1), (1, 2), (1, 3), (2, 1), (1, 5), (2, 5)],
     (1, 4, 8, 10, 17, 21, 34)),
]


def main():
    if not torch.cuda.is_available():
        sys.exit("hat_tiles: no GPU")
    import chip_smoke as cs
    from vbicm_tpu_torch.ops.hat_transfer_kernel import SMEM_MAX, hat_transfer, launch_plan
    from vbicm_tpu_torch.utils.timing import card_line

    dev = torch.device("cuda", 0)
    print(card_line(), flush=True)
    for (B, cells, ratio, ndof), tiles, lines_set in SWEEP:
        nf = [c * ratio + 1 for c in cells]
        nc = [c + 1 for c in cells]
        for dtype in (torch.float32, torch.float64):
            g = torch.Generator(device=dev).manual_seed(0)
            u = torch.randn((B, ndof * int(np.prod(nc))), generator=g, device=dev, dtype=dtype)
            r = torch.randn((B, ndof * int(np.prod(nf))), generator=g, device=dev, dtype=dtype)
            itemsize = u.element_size()
            bound = cs.hat_least_time(B, cells, ratio, ndof, dtype)[0]
            picked = launch_plan(B, cells, ratio, ndof, itemsize)
            res = []
            for tz, ty in tiles:
                plan = launch_plan(B, cells, ratio, ndof, itemsize,
                                   **({"ty": ty} if len(cells) == 2 else {"tz": tz, "ty": ty}))
                if plan.restrict_smem > SMEM_MAX:
                    continue
                ms = cs.graph_ms(lambda: hat_transfer(r, None, cells, ratio, ndof, adjoint=True,
                                                      plan=plan))
                res.append((ms, f"({tz}, {ty}) {plan.restrict_smem} B"))
            print(f"restrict {B} {cells} r{ratio} {dtype}, bound {bound:.4f} ms, picked "
                  f"({picked.tz}, {picked.ty}): "
                  + "; ".join(f"{tile} {ms:.4f}" for ms, tile in sorted(res)), flush=True)
            res = []
            for lines in lines_set:
                plan = launch_plan(B, cells, ratio, ndof, itemsize, lines=lines)
                ms = cs.graph_ms(lambda: hat_transfer(u, None, cells, ratio, ndof, adjoint=False,
                                                      plan=plan))
                res.append((ms, lines))
            print(f"prolong {B} {cells} r{ratio} {dtype}, bound {bound:.4f} ms, picked "
                  f"{picked.lines}: " + "; ".join(f"{n} {ms:.4f}" for ms, n in sorted(res)),
                  flush=True)


if __name__ == "__main__":
    main()
