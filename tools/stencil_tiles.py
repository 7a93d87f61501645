"""Time the 2-D and 3-D affine stencil kernels (csrc/stencil_affine.cu,
csrc/stencil3d_affine.cu) at every tiling candidate, at the shapes their
paths run, on one GPU: the launch plans' evidence.

The candidates: rows a band, rows at once and blocks a launch of the 2-D
kernel, sample groups a block of the 3-D kernel, each for the kernel as
built and for variants built by nvcc from edited copies of its source under
build/stencil_tiles/ (two nodes a thread in 2-D float32; 4 and 16 samples a
thread in 3-D). Each candidate is launched through its library's C entry
point (the wrappers always take ops/stencil_kernel.py's and
ops/stencil3d_kernel.py's launch plans), held against the plain PyTorch
version (float32 2e-5, float64 1e-12 of max|q|) and bitwise against the
plan's output (every tiling computes each output with the same FMAs in the
same order), and timed by CUDA-graph replay (device time, no host time).
Prints the card's name and power limit and one JSON line per (kernel,
shape, dtype) with the time of each candidate and of the plain version, the
plan's choice and the fastest.

    python tools/stencil_tiles.py [--only 2d|3d]

``--parity [--root DIR]`` instead runs the wrappers of the package found at
DIR (default: this checkout; an unpacked earlier commit is another) on
seeded inputs at the same shapes and prints, per (kernel, shape, dtype), the
sha256 of q's bytes and the device time of one call, so that two trees are
compared in one run on one card:

    python tools/stencil_tiles.py --parity --root parent_tree
"""
import argparse
import hashlib
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "stencil_tiles")
CSRC = os.path.join(ROOT, "vbicm_tpu_torch", "csrc")
# (nx, ny, B): the 160x80 paths' batches (256 in the step and fh, 8 in the
# golden's solve, 16 in the ROM example's spot check) and the tests' 32x16
SHAPES_2D = [(160, 80, 256), (160, 80, 8), (160, 80, 16), (32, 16, 256)]
# (cells, B): the 3-D trainer's box and the 64x16x16 solve at bench.py's B
# and the step's
SHAPES_3D = [((32, 8, 8), 256), ((64, 16, 16), 256), ((64, 16, 16), 64)]
REL_TOL = {"float32": 2e-5, "float64": 1e-12}
ROWS_2D = (1, 2, 3, 4, 6, 8)
WAVES_2D = (1, 2, 3, 4, 8)  # blocks a launch, in multiples of the card's SMs
GROUPS_3D = (1, 2, 3, 4, 6, 7, 8)
# (kernel, label): the compile-time edit of a variant; () is the kernel as built
NPT = "constexpr int kNpt = 1;"
SAMPLES = "constexpr int kSamples = 8;"
VARIANTS = {("2d", "npt1"): (), ("2d", "npt2"): ((NPT, NPT.replace("1", "2")),),
            ("3d", "S8"): (), ("3d", "S4"): ((SAMPLES, SAMPLES.replace("8", "4")),),
            ("3d", "S16"): ((SAMPLES, SAMPLES.replace("8", "16")),)}


def _inputs(torch, B, ndof, seed, dtype, dev):
    rng = np.random.default_rng(seed)
    c = torch.as_tensor(rng.uniform(1.0, 3.0, (B, 2)), dtype=dtype, device=dev)
    u = torch.as_tensor(rng.normal(size=(B, ndof)), dtype=dtype, device=dev)
    return c.contiguous(), u.contiguous()


def _operators(torch, dev):
    """{("2d" | "3d", grid): (operator, plain(dtype, c, u), ndof)} at every
    shape."""
    from vbicm_tpu_torch.config import SectionCard
    from vbicm_tpu_torch.mesh import beam_hex8_mesh, cooks_membrane_mesh
    from vbicm_tpu_torch.model import build_fem_model
    from vbicm_tpu_torch.ops.stencil import StencilOperator
    from vbicm_tpu_torch.ops.stencil3d import StencilOperator3d
    from vbicm_tpu_torch.ops.stencil3d_kernel import stencil3d_affine_reference
    from vbicm_tpu_torch.ops.stencil_kernel import stencil_affine_reference

    ops = {}
    for nx, ny, _ in SHAPES_2D:
        if ("2d", (nx, ny)) not in ops:
            op = StencilOperator(build_fem_model(cooks_membrane_mesh(nx, ny), device=dev,
                                                 dense=False), nx, ny)
            ops["2d", (nx, ny)] = (op, lambda dt, c, u, op=op: stencil_affine_reference(
                op.W[dt], c, u), 2 * (nx + 1) * (ny + 1))
    for cells, _ in SHAPES_3D:
        if ("3d", cells) not in ops:
            m = build_fem_model(beam_hex8_mesh(*cells), SectionCard(stype=4), device=dev,
                                dense=False)
            op = StencilOperator3d(m, *cells)
            W = {}

            def plain(dt, c, u, op=op, W=W):
                if dt not in W:
                    W[dt] = op.W.to(dev, dt)
                return stencil3d_affine_reference(W[dt], c, u)

            ops["3d", cells] = (op, plain, m.ndof)
    return ops


def parity(args):
    """sha256 of q and the device time of one wrapper call, per shape and
    dtype, through the package at --root."""
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from vbicm_tpu_torch.utils.timing import card_line, graph_time_s

    if not torch.cuda.is_available():
        raise SystemExit("no GPU is available (torch.cuda.is_available() is False)")
    import vbicm_tpu_torch

    dev = torch.device("cuda", 0)
    print(card_line(), flush=True)
    print(f"package: {os.path.dirname(os.path.abspath(vbicm_tpu_torch.__file__))}", flush=True)
    ops = _operators(torch, dev)
    cases = [("2d", (nx, ny), B) for nx, ny, B in SHAPES_2D] + \
        [("3d", cells, B) for cells, B in SHAPES_3D]
    for kind, grid, B in cases:
        op, _, ndof = ops[kind, grid]
        for dtype in (torch.float32, torch.float64):
            c, u = _inputs(torch, B, ndof, 7 + B, dtype, dev)
            q = op.affine(c, u)
            torch.cuda.synchronize()
            digest = hashlib.sha256(q.cpu().numpy().tobytes()).hexdigest()
            ms = graph_time_s(lambda: op.affine(c, u)) * 1e3
            print(json.dumps({"kernel": kind, "grid": "x".join(map(str, grid)), "B": B,
                              "dtype": str(dtype)[6:], "sha256": digest, "ms": ms}),
                  flush=True)


def sweep(args):
    import torch

    from stencil_breakdown import build_variants, edited
    from vbicm_tpu_torch import _build
    from vbicm_tpu_torch.ops.stencil3d_kernel import launch_plan_3d, plan_tiling_3d
    from vbicm_tpu_torch.ops.stencil_kernel import launch_plan, plan_tiling
    from vbicm_tpu_torch.utils.timing import card_line, graph_time_s

    if not torch.cuda.is_available():
        raise SystemExit("no GPU is available (torch.cuda.is_available() is False)")
    dev = torch.device("cuda", 0)
    print(card_line(), flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sources = {}
    for kind in ("2d", "3d"):
        with open(os.path.join(CSRC, f"stencil{'' if kind == '2d' else '3d'}_affine.cu")) as f:
            sources[kind] = f.read()
    libs = build_variants({key: edited(sources[key[0]], pairs, str(key))
                           for key, pairs in VARIANTS.items()}, OUT)
    ops = _operators(torch, dev)
    bad = 0
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def check(q, qp, q_plan, label, dtype):
        nonlocal bad
        err = float((q - qp).abs().max() / qp.abs().max())
        if not err <= REL_TOL[str(dtype)[6:]] or not torch.equal(q, q_plan):
            print(f"BAD {label}: rel err {err}, bitwise equal to the plan's "
                  f"{torch.equal(q, q_plan)}", flush=True)
            bad += 1

    def timed(row, label, launch, q, qp, q_plan, dtype):
        err = launch()
        if err:
            raise RuntimeError(f"launch failed with CUDA error {err}: {label}")
        torch.cuda.synchronize()
        check(q, qp, q_plan, label, dtype)
        row[label.split(": ")[-1]] = graph_time_s(launch) * 1e3

    for dtype in (torch.float32, torch.float64):
        sfx = "f32" if dtype == torch.float32 else "f64"
        name = str(dtype)[6:]
        if args.only in (None, "2d"):
            for nx, ny, B in SHAPES_2D:
                op, plain, _ = ops["2d", (nx, ny)]
                w = op.planes[dtype]
                NY, _, NX2 = w.shape
                c, u = _inputs(torch, B, NY * NX2, 7 + B, dtype, dev)
                q, qp, q_plan = torch.empty_like(u), plain(dtype, c, u), op.affine(c, u)
                plan = launch_plan(B, NY, NX2, dtype, dev)
                row = {"plain_ms": graph_time_s(lambda: plain(dtype, c, u)) * 1e3}
                for (kind, var), lib in libs.items():
                    if kind != "2d" or (var != "npt1" and dtype != torch.float32):
                        continue
                    fn = getattr(lib, f"vbicm_stencil_affine_{sfx}")
                    fit_fn = getattr(lib, f"vbicm_stencil_affine_fit_{sfx}")

                    def fit(rt):
                        return _build.kernel_fit(fit_fn, 3, NX2, rt)

                    for rows in ROWS_2D:
                        try:
                            p = plan_tiling(B, NY, NX2, fit, sms, rows)
                        except ValueError:
                            continue
                        pairs = -(-NY // p.rows) * B
                        for waves in WAVES_2D:
                            run = -(-pairs // (waves * sms))
                            label = f"R{p.rows}/{p.rows_at_once} W{run} {var}"
                            if label in row:
                                continue
                            timed(row, f"2d {nx}x{ny} B={B} {name}: {label}", lambda: fn(
                                w.data_ptr(), c.data_ptr(), u.data_ptr(), q.data_ptr(), B, NY,
                                NX2, p.rows, p.rows_at_once, run, stream()), q, qp, q_plan, dtype)
                best = min((v, k) for k, v in row.items() if k != "plain_ms")
                print(json.dumps({
                    "kernel": "2d", "grid": f"{nx}x{ny}", "B": B, "dtype": name,
                    "plan": f"R{plan.rows}/{plan.rows_at_once} W{plan.run} npt1",
                    "best": best[1], **{k: round(v, 4) for k, v in row.items()}}), flush=True)
        if args.only in (None, "3d"):
            for cells, B in SHAPES_3D:
                op, plain, _ = ops["3d", cells]
                w = op.planes[dtype]
                NX, NY, NZ = (n + 1 for n in cells)
                NX3 = 3 * NX
                c, u = _inputs(torch, B, NZ * NY * NX3, 7 + B, dtype, dev)
                q, qp, q_plan = torch.empty_like(u), plain(dtype, c, u), op.affine(c, u)
                plan = launch_plan_3d(B, NZ, NY, NX3, dtype, dev)
                row = {"plain_ms": graph_time_s(lambda: plain(dtype, c, u)) * 1e3}
                for (kind, var), lib in libs.items():
                    if kind != "3d":
                        continue
                    fn = getattr(lib, f"vbicm_stencil3d_affine_{sfx}")
                    fit_fn = getattr(lib, f"vbicm_stencil3d_affine_fit_{sfx}")
                    groups = [plan_tiling_3d(B, NZ, NY, NX3, lambda g: _build.kernel_fit(
                        fit_fn, 5, NX3, g)).groups] + list(GROUPS_3D)
                    for g in dict.fromkeys(groups):
                        if _build.kernel_fit(fit_fn, 5, NX3, g) is None:
                            continue
                        timed(row, f"3d {cells} B={B} {name}: {var} G{g}", lambda: fn(
                            w.data_ptr(), c.data_ptr(), u.data_ptr(), q.data_ptr(), B, NZ, NY,
                            NX3, g, stream()), q, qp, q_plan, dtype)
                best = min((v, k) for k, v in row.items() if k != "plain_ms")
                print(json.dumps({
                    "kernel": "3d", "grid": "x".join(map(str, cells)), "B": B, "dtype": name,
                    "plan": f"S{plan.samples} G{plan.groups}", "best": best[1],
                    **{k: round(v, 4) for k, v in row.items()}}), flush=True)
    if bad:
        raise SystemExit(f"{bad} candidates disagree with the plain version or the plan's bits")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("2d", "3d"), help="one kernel's sweep")
    ap.add_argument("--parity", action="store_true",
                    help="sha256 and device time of the wrappers' q at every shape")
    ap.add_argument("--root", default=ROOT, help="the checkout whose package --parity runs")
    args = ap.parse_args()
    if args.parity:
        parity(args)
    else:
        sys.path.insert(0, ROOT)
        sweep(args)


if __name__ == "__main__":
    main()
