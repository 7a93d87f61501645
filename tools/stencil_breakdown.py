"""What bounds the 2-D and 3-D stencil kernels and the banded tensor-core
stencil: each timed on one GPU as built, with its global-to-shared copies
removed ("compute": the arithmetic on whatever the shared memory holds) and
with its arithmetic removed ("copies": the staging alone), at the launch
plan's tiling; the banded kernel also without its u copies alone ("no_u"),
without its table copies alone ("no_table"), "compute" without its q
stores ("compute_no_store") and with each MMA replaced by one integer
operation on its operands ("compute_no_mma"), and with two u buffers and
two blocks an SM ("two_stages", and its "two_stages_compute") in place of
one buffer and four blocks, at 160x80 in both modes.

The variants are built from this checkout's kernel sources, edited as text,
by nvcc into libraries under build/stencil_breakdown/ and launched through
the same C entry points as the package's; their outputs are not checked
(two of them compute on stale data). If the two parts' times add up to the
whole, the copies and the arithmetic do not overlap. Prints the card's name
and power limit and one JSON line per (kernel, shape, dtype).

    python tools/stencil_breakdown.py
"""
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "build", "stencil_breakdown")
CSRC = os.path.join(ROOT, "vbicm_tpu_torch", "csrc")


def _variants():
    """{(kernel, variant): source text}; raises if an edit no longer applies."""
    with open(os.path.join(CSRC, "stencil_affine.cu")) as f:
        src2 = f.read()
    with open(os.path.join(CSRC, "stencil3d_affine.cu")) as f:
        src3 = f.read()
    with open(os.path.join(CSRC, "stencil_mxu.cu")) as f:
        srcm = f.read()
    no_u = ("m < kBM; m += 2)", "m < 0; m += 2)")
    no_table = ("e < kCopies; e += kThreads)", "e < 0; e += kThreads)")

    def stages(n, blocks):
        line = srcm[srcm.index("constexpr int kStages"):srcm.index("constexpr int kMinBlocks")]
        line += srcm[srcm.index("constexpr int kMinBlocks"):].split(";")[0] + ";"
        return line, f"constexpr int kStages = {n};\nconstexpr int kMinBlocks = {blocks};"
    edits = {
        ("2d", "compute"): [("if (dst[j] >= 0) cp_async_node", "if (false) cp_async_node")],
        ("2d", "copies"): [("if (!active) continue;", "continue;")],
        ("3d", "compute"): [("i < NX3; i += 32) cp_async_value", "i < 0; i += 32) cp_async_value"),
                            ("c < cplane / kVec; c += nthreads)", "c < 0; c += nthreads)")],
        ("3d", "copies"): [("if (!active) continue;", "continue;")],
        ("mxu", "compute"): [no_u, no_table],
        ("mxu", "copies"): [("      tile_mma<true>(Mode{}, a_row, Tab, live, lane, acc);\n    else\n"
                             "      tile_mma<false>(Mode{}, a_row, Tab, live, lane, acc);",
                             "      ;")],
        ("mxu", "no_u"): [no_u],
        ("mxu", "no_table"): [no_table],
        ("mxu", "compute_no_store"): [no_u, no_table, (
            "        *reinterpret_cast<float2*>(q + b * ndof",
            "        if (v.x == 1234.5f) *reinterpret_cast<float2*>(q + b * ndof")],
        ("mxu", "compute_no_mma"): [no_u, no_table, (
            "mma_bf16(acc[j][h], p == 1 ? al : ah, b[0], b[1]);",
            "acc[j][h][p] += __uint_as_float((p == 1 ? al : ah)[p] ^ b[0] ^ b[1]);"), (
            "mma_tf32(acc[j][h], p == 0 ? asl : ab, b[0], b[1]);",
            "acc[j][h][p] += __uint_as_float((p == 0 ? asl : ab)[p] ^ b[0] ^ b[1]);")],
        ("mxu", "two_stages"): [stages(2, 2)],
        ("mxu", "two_stages_compute"): [stages(2, 2), no_u, no_table],
    }
    sources = {"2d": src2, "3d": src3, "mxu": srcm}
    out = {(kind, "whole"): text for kind, text in sources.items()}
    for (kind, name), pairs in edits.items():
        out[kind, name] = edited(sources[kind], pairs, f"{kind} {name}")
    return out


def edited(text, pairs, label):
    """``text`` with each (old, new) of ``pairs`` replaced; raises if an
    ``old`` does not occur exactly once."""
    for old, new in pairs:
        if text.count(old) != 1:
            raise RuntimeError(f"{label}: the edit {old!r} does not apply to the source")
        text = text.replace(old, new)
    return text


def build_variants(variants, out_dir):
    """{key: source text} -> {key: ctypes library}: each text built by nvcc
    for sm_90a into a shared library under ``out_dir``, all at once, with the
    stencil kernels' C entry points typed as in vbicm_tpu_torch/_build.py."""
    from vbicm_tpu_torch import _build as build

    nvcc = build._nvcc()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for key, text in variants.items():
        path = os.path.join(out_dir, "_".join(map(str, key)) + ".cu")
        with open(path, "w") as f:
            f.write(text)
        procs[key] = (path, subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-shared", "-I", CSRC, "-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {key}:\n{log}")
        lib = ctypes.CDLL(path[:-3] + ".so")
        for name, argtypes in build._SIGNATURES.items():
            if name.startswith("vbicm_stencil") and hasattr(lib, name):
                getattr(lib, name).argtypes = argtypes
                getattr(lib, name).restype = ctypes.c_int
        libs[key] = lib
    return libs


def main():
    import torch

    from vbicm_tpu_torch.config import SectionCard
    from vbicm_tpu_torch.mesh import beam_hex8_mesh, cooks_membrane_mesh
    from vbicm_tpu_torch.model import build_fem_model
    from vbicm_tpu_torch.ops.stencil import StencilOperator
    from vbicm_tpu_torch.ops.stencil3d import StencilOperator3d
    from vbicm_tpu_torch.ops.stencil3d_kernel import launch_plan_3d
    from vbicm_tpu_torch.ops.stencil_kernel import launch_plan
    from vbicm_tpu_torch.utils.timing import card_line, graph_time_s

    if not torch.cuda.is_available():
        raise SystemExit("no GPU is available (torch.cuda.is_available() is False)")
    dev = torch.device("cuda", 0)
    print(card_line(), flush=True)
    variants = _variants()
    libs = build_variants(variants, OUT)
    rng = np.random.default_rng(0)
    B = 256

    def report(kind, grid, dtype, plan, launch):
        row = {}
        names = ("whole", "compute", "copies")
        if kind == "mxu":
            names += ("no_u", "no_table", "compute_no_store", "compute_no_mma", "two_stages",
                      "two_stages_compute")
        for name in names:
            if kind == "mxu":
                entry = f"vbicm_stencil_mxu_{dtype}"
            else:
                entry = (f"vbicm_stencil{'' if kind == '2d' else '3d'}_affine_"
                         f"{'f32' if dtype == torch.float32 else 'f64'}")
            fn = getattr(libs[kind, name], entry)
            err = launch(fn)
            if err:
                raise RuntimeError(f"{kind} {name} launch failed with CUDA error {err}")
            row[f"{name}_ms"] = graph_time_s(lambda: launch(fn)) * 1e3
        print(json.dumps({"kernel": kind, "grid": grid, "B": B,
                          "dtype": dtype if isinstance(dtype, str) else str(dtype)[6:],
                          "plan": str(plan), **row}), flush=True)

    from vbicm_tpu_torch.ops.stencil import build_stencil_tables
    from vbicm_tpu_torch.ops.stencil_mxu import launch_plan as mxu_plan
    from vbicm_tpu_torch.ops.stencil_mxu import pack_w_bands

    model = build_fem_model(cooks_membrane_mesh(160, 80), device=dev, dense=False)
    W = build_stencil_tables(model, 160, 80)
    u = torch.as_tensor(rng.normal(size=(B, model.ndof)), dtype=torch.float32, device=dev)
    c = torch.ones((B, 2), dtype=torch.float32, device=dev)
    q = torch.empty_like(u)
    for mode in ("bf16x3", "f32"):
        tables = pack_w_bands(W, mode)
        hi, lo = (t.to(dev) for t in tables) if mode == "bf16x3" else (tables.to(dev), None)
        p = mxu_plan(B, 81, 161, mode)
        report("mxu", "160x80", mode, p, lambda fn: fn(
            hi.data_ptr(), hi.data_ptr() if lo is None else lo.data_ptr(), c.data_ptr(),
            u.data_ptr(), q.data_ptr(), B, 81, 322, torch.cuda.current_stream().cuda_stream))
        del tables, hi, lo

    op = StencilOperator(build_fem_model(cooks_membrane_mesh(160, 80), device=dev,
                                         dense=False), 160, 80)
    for dtype in (torch.float32, torch.float64):
        w = op.planes[dtype]
        NY, _, NX2 = w.shape
        u = torch.as_tensor(rng.normal(size=(B, NY * NX2)), dtype=dtype, device=dev)
        c = torch.ones((B, 2), dtype=dtype, device=dev)
        q = torch.empty_like(u)
        p = launch_plan(B, NY, NX2, dtype, dev)
        report("2d", "160x80", dtype, p, lambda fn: fn(
            w.data_ptr(), c.data_ptr(), u.data_ptr(), q.data_ptr(), B, NY, NX2, p.rows,
            p.rows_at_once, p.run, torch.cuda.current_stream().cuda_stream))
    for cells in ((32, 8, 8), (64, 16, 16)):
        m = build_fem_model(beam_hex8_mesh(*cells), SectionCard(stype=4), device=dev, dense=False)
        op = StencilOperator3d(m, *cells)
        NX, NY, NZ = (n + 1 for n in cells)
        for dtype in (torch.float32, torch.float64):
            w = op.planes[dtype]
            u = torch.as_tensor(rng.normal(size=(B, m.ndof)), dtype=dtype, device=dev)
            c = torch.ones((B, 2), dtype=dtype, device=dev)
            q = torch.empty_like(u)
            p = launch_plan_3d(B, NZ, NY, 3 * NX, dtype, dev)
            report("3d", "x".join(map(str, cells)), dtype, p, lambda fn: fn(
                w.data_ptr(), c.data_ptr(), u.data_ptr(), q.data_ptr(), B, NZ, NY, 3 * NX,
                p.groups, torch.cuda.current_stream().cuda_stream))


if __name__ == "__main__":
    main()
