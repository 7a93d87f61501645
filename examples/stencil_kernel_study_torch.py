"""Stencil-matvec kernel study with the PyTorch port (``vbicm_tpu_torch``)
on one GPU: every implementation of the batched affine matvec q = K(c) u of
Cook's membrane 160x80 (26,082 dofs) at B = 256, and the card's FMA ceiling.

1. Times each implementation with CUDA events (best of 5 runs of ``--reps``
   calls, after warm-up) and checks it against the float64 plain stencil
   (relative error of norms): the plain float32 stencil, the one-row kernel,
   its rows-per-block option at each of ``ROWS_PER_BLOCK``, and the banded
   tensor-core kernel in ``f32`` (3xTF32) and ``bf16x3`` mode.
2. Runs the FMA-ceiling probe at the study's depth ``NFMA`` = 42, where it
   is bound by bytes on an H100, and at ``--nfma-peak``, where the FMAs
   bound it, in float32 and float64: the CUDA cores' FMA ceilings this card
   reaches.
3. States the roofline with this card's numbers: the ridge point (flops a
   byte), the stencil's intensity (band flops over its least bytes), and
   each kernel's share of its bytes bound and of the measured FP32 FMA
   ceiling. A share above 1 is written as null with ``*_implausible``.

Least bytes count the port's own operands once (u in, q out, and the
implementation's table: the plain stencil's float32 block tables, the
kernels' unpadded (NY, 42, 2NX) planes, the banded tables); band flops are
2 * B * NY * 42 * 2NX. Writes ``summary.json`` under ``--results`` with the
card's name and power limit.

    python examples/stencil_kernel_study_torch.py --device cuda
"""
# Allow running directly from a repo checkout without installation.
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
del _os, _sys
import argparse
import json
import os

import numpy as np

ROWS_PER_BLOCK = (3, 8)  # the JAX study's multirow3, and a deeper block
NFMA = 42  # the JAX study's probe depth
SEED = 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nx", type=int, default=160)
    ap.add_argument("--ny", type=int, default=80)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--reps", type=int, default=30, help="calls a timed run (5 runs)")
    ap.add_argument("--nfma-peak", type=int, default=4096,
                    help="probe depth at which the FMAs, not the bytes, bound it")
    ap.add_argument("--results", type=str, default="results_stencil_study_torch")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    import torch

    from vbicm_tpu_torch.mesh import cooks_membrane_mesh
    from vbicm_tpu_torch.model import build_fem_model
    from vbicm_tpu_torch.ops.peak_probe import fma_peak_probe, fma_probe_flops
    from vbicm_tpu_torch.ops.stencil import StencilOperator, build_stencil_tables
    from vbicm_tpu_torch.ops.stencil_kernel import stencil_affine_reference
    from vbicm_tpu_torch.ops.stencil_mxu import (
        KDIM,
        n_tiles,
        pack_w_bands,
        stencil_affine_matvec_mxu,
    )
    from vbicm_tpu_torch.utils.roofline import (
        device_peaks,
        least_time_s,
        mfu_fields,
        share_fields,
    )
    from vbicm_tpu_torch.utils.timing import benchmark_fn, card_line

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no GPU is available (torch.cuda.is_available() is False)")
    name, power_limit = ((s.strip() for s in card_line().split(",", 1))
                         if device.type == "cuda" else ("cpu", None))
    print(f"device: {device} ({name}, power limit {power_limit})", flush=True)
    f32, f64 = torch.float32, torch.float64

    nx, ny, B = args.nx, args.ny, args.batch
    NY, NX = ny + 1, nx + 1
    NX2 = 2 * NX
    model = build_fem_model(cooks_membrane_mesh(nx, ny), device=device, dense=False)
    W = build_stencil_tables(model, nx, ny)
    op = StencilOperator(model, nx, ny, W=W)
    mf32 = pack_w_bands(W, "f32").to(device)
    mh, ml = (m.to(device) for m in pack_w_bands(W, "bf16x3"))

    rng = np.random.default_rng(SEED)
    c64 = torch.as_tensor(rng.uniform(1.0, 2.0, (B, 2)), device=device)
    u64 = torch.as_tensor(rng.normal(size=(B, model.ndof)), device=device)
    c32, u32 = c64.to(f32), u64.to(f32)
    q_exact = stencil_affine_reference(op.W[f64], c64, u64)
    scale = float(q_exact.norm())

    impls = {"plain_stencil_f32": lambda: stencil_affine_reference(op.W[f32], c32, u32),
             "stencil_onerow": lambda: op.affine(c32, u32)}
    for r in ROWS_PER_BLOCK:
        impls[f"stencil_rows{r}"] = lambda r=r: op.affine(c32, u32, rows_per_block=r)
    impls["mxu_f32"] = lambda: stencil_affine_matvec_mxu(mf32, c32, u32, NY, NX, "f32")
    impls["mxu_bf16x3"] = lambda: stencil_affine_matvec_mxu((mh, ml), c32, u32, NY, NX, "bf16x3")

    uq_bytes = 2 * 4.0 * B * model.ndof
    planes_bytes = op.planes[f32].numel() * 4.0
    table_bytes = {"plain_stencil_f32": op.W[f32].numel() * 4.0, "mxu_f32": mf32.numel() * 4.0,
                   "mxu_bf16x3": (mh.numel() + ml.numel()) * 2.0}
    band_flops = 2.0 * B * NY * 42 * NX2
    dense_flops = 3 * 2.0 * B * KDIM * 256 * NY * n_tiles(NX)  # three products either mode
    peaks = device_peaks(device)

    out = {"mesh": f"{nx}x{ny}", "ndof": model.ndof, "batch": B, "device": name,
           "device_type": device.type, "power_limit": power_limit,
           "peaks": peaks, "band_flops_per_matvec": band_flops,
           "densified_flops_per_matvec": dense_flops, "impls": {}}
    for key, fn in impls.items():
        dt = benchmark_fn(fn, iters=args.reps, warmup=2, repeats=5, device=device)["mean_s"]
        q = fn()
        rel = float((q.to(f64) - q_exact).norm()) / scale
        nbytes = uq_bytes + table_bytes.get(key, planes_bytes)
        bytes_s, _ = least_time_s(nbytes, 0.0, "fp32", device)
        rec = {"ms": dt * 1e3, "rel_err_vs_f64": rel, "min_bytes": nbytes,
               "bandwidth_sol_ms": bytes_s * 1e3,
               "band_tflops": band_flops / dt / 1e12,
               **mfu_fields(band_flops, nbytes, 1.0 / dt, device, unit="fp32")}
        if key.startswith("mxu"):
            unit = "bf16_tc" if key == "mxu_bf16x3" else "tf32_tc"
            own_s, own_by = least_time_s(nbytes, dense_flops, unit, device)
            rec.update(densified_bound_ms=own_s * 1e3, densified_bound_by=own_by,
                       **{f"densified_{k}": v for k, v in
                          mfu_fields(dense_flops, None, 1.0 / dt, device, unit=unit).items()})
        out["impls"][key] = rec
        print(f"{key:18s} {rec['ms']:8.4f} ms  rel {rel:.2e}  bytes-bound {rec['bandwidth_sol_ms']:.4f} "
              f"ms  hbm share {rec.get('hbm_utilization')}  band {rec['band_tflops']:.3f} TFLOP/s",
              flush=True)

    # the FMA-ceiling probe: the study's shape, XLP the TPU kernel's padded row
    XLP = -(-(NX2 + 8) // 128) * 128
    a64 = rng.uniform(-0.9, 0.9, (B, NY * XLP))
    b64 = rng.uniform(-0.9, 0.9, (B, XLP))
    out["probe"] = {}
    for dtype, nfma in ((f32, NFMA), (f32, args.nfma_peak), (f64, NFMA), (f64, args.nfma_peak)):
        a = torch.as_tensor(a64, dtype=dtype, device=device)
        b = torch.as_tensor(b64, dtype=dtype, device=device)
        dt = benchmark_fn(fma_peak_probe, a, b, nfma, iters=args.reps, warmup=2, repeats=5,
                          device=device)["mean_s"]
        flops = fma_probe_flops(B, NY, XLP, nfma)
        nbytes = (2 * a.numel() + b.numel()) * a.element_size()
        unit = "fp32" if dtype == f32 else "fp64"
        bound_s, bound_by = least_time_s(nbytes, flops, unit, device)
        rec = {"ms": dt * 1e3, "tflops": flops / dt / 1e12, "flops": flops, "bytes": nbytes,
               "bound_ms": bound_s * 1e3, "bound_by": bound_by,
               **share_fields("fraction_of_bound", bound_s / dt)}
        key = f"{unit}_nfma{nfma}"
        out["probe"][key] = rec
        print(f"probe {key:14s} {rec['ms']:8.4f} ms  {rec['tflops']:.3f} TFLOP/s  bound "
              f"{rec['bound_ms']:.4f} ms ({bound_by})", flush=True)
    ceil32 = out["probe"][f"fp32_nfma{args.nfma_peak}"]["tflops"] * 1e12
    ceil64 = out["probe"][f"fp64_nfma{args.nfma_peak}"]["tflops"] * 1e12
    out["fma_ceiling_tflops"] = {"fp32": ceil32 / 1e12, "fp64": ceil64 / 1e12}

    one = out["impls"]["stencil_onerow"]
    verdict = {
        "ridge_flops_per_byte_datasheet_fp32": peaks["fp32"] / peaks["hbm_bytes_per_s"],
        "ridge_flops_per_byte_measured_fp32": ceil32 / peaks["hbm_bytes_per_s"],
        "stencil_band_intensity_flops_per_byte": band_flops / one["min_bytes"],
        "fastest": min(out["impls"], key=lambda k: out["impls"][k]["ms"]),
        "banded_beats_onerow": min(out["impls"]["mxu_f32"]["ms"],
                                   out["impls"]["mxu_bf16x3"]["ms"]) < one["ms"],
        "impls": {},
    }
    verdict["stencil_bound_by"] = (
        "bytes" if verdict["stencil_band_intensity_flops_per_byte"]
        < verdict["ridge_flops_per_byte_measured_fp32"] else "operations")
    for key, rec in out["impls"].items():
        verdict["impls"][key] = {
            **share_fields("fraction_of_bytes_bound", rec["bandwidth_sol_ms"] / rec["ms"]),
            **share_fields("fraction_of_fp32_fma_ceiling", band_flops / (rec["ms"] / 1e3) / ceil32)}
    out["verdict"] = verdict
    print(json.dumps(out["fma_ceiling_tflops"]))
    print(json.dumps(verdict, indent=1))

    os.makedirs(args.results, exist_ok=True)
    path = os.path.join(args.results, "summary.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}")
    return out


if __name__ == "__main__":
    main()
