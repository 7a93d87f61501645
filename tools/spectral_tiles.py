"""Time the spectral kernel (csrc/spectral_apply.cu) at every compiled
output tile and k-range split, at the shapes its paths run, on one GPU.

Each configuration is launched through the library's C entry point (the
wrapper always takes ops/spectral_kernel.py's launch plan), held against the
plain PyTorch version (float32 2e-5, float64 1e-12 of max|x|, x and a), and
timed by CUDA-graph replay (device time, no host time). Prints the card's
name and power limit, one JSON line per (shape, dtype) with the time of
each configuration and of the plain version, and the plan's choice. The
launch plan's rules rest on these times.

    python tools/spectral_tiles.py
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
del _os, _sys
import json

import numpy as np

SHAPES = [(256, 1680), (256, 1200), (256, 440), (4096, 1680), (512, 1200), (16, 1680)]
SPLITS = (1, 2, 3, 4)
REL_TOL = {"float32": 2e-5, "float64": 1e-12}


def main():
    import torch

    from vbicm_tpu_torch import _build
    from vbicm_tpu_torch.ops.spectral_kernel import TILES, launch_plan, spectral_apply_reference
    from vbicm_tpu_torch.utils.timing import card_line, graph_time_s

    if not torch.cuda.is_available():
        raise SystemExit("no GPU is available (torch.cuda.is_available() is False)")
    dev = torch.device("cuda", 0)
    print(card_line(), flush=True)
    lib, _, _ = _build.load_library()
    bad = 0
    for dtype in (torch.float32, torch.float64):
        fn = {torch.float32: lib.vbicm_spectral_apply_f32,
              torch.float64: lib.vbicm_spectral_apply_f64}[dtype]
        for B, n in SHAPES:
            rng = np.random.default_rng(7)
            Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
            V, g, c, b = (torch.as_tensor(x, dtype=dtype, device=dev).contiguous() for x in
                          (Q, np.abs(rng.normal(size=n)) + 0.1,
                           np.abs(rng.normal(size=(B, 2))) + 1.0, rng.normal(size=(B, n))))
            x, a = torch.empty_like(b), torch.empty_like(b)
            ws = torch.empty((max(SPLITS), B, n), dtype=dtype, device=dev)
            plan = launch_plan(B, n, V.element_size())
            xr, ar = spectral_apply_reference(V, g, c, b, return_coords=True)

            def run(bm, bn, split):
                err = fn(V.data_ptr(), g.data_ptr(), c.data_ptr(), b.data_ptr(), x.data_ptr(),
                         a.data_ptr(), ws.data_ptr(), B, n, bm, bn, split, int(plan.vec),
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed with CUDA error {err}")

            row = {"plain_ms": graph_time_s(
                lambda: spectral_apply_reference(V, g, c, b, return_coords=True)) * 1e3}
            for bm, bn in TILES:
                for split in SPLITS:
                    run(bm, bn, split)
                    torch.cuda.synchronize()
                    err = max(float((x - xr).abs().max() / xr.abs().max()),
                              float((a - ar).abs().max() / ar.abs().max()))
                    if not err <= REL_TOL[str(dtype)[6:]]:
                        print(f"BAD {dtype} {(B, n)} tile {bm}x{bn} split {split}: rel err {err}")
                        bad += 1
                    row[f"{bm}x{bn}/{split}"] = graph_time_s(lambda: run(bm, bn, split)) * 1e3
            best = min((v, k) for k, v in row.items() if k != "plain_ms")
            print(json.dumps({"shape": [B, n], "dtype": str(dtype)[6:],
                              "plan": f"{plan.bm}x{plan.bn}/{plan.split}", "best": best[1],
                              **{k: round(v, 4) for k, v in row.items()}}), flush=True)
    if bad:
        raise SystemExit(f"{bad} configurations disagree with the plain version")


if __name__ == "__main__":
    main()
