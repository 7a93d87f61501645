"""What bounds the 2-D and 3-D stencil kernels: each timed on one GPU as
built, with its global-to-shared copies removed ("compute": the arithmetic
on whatever the shared memory holds) and with its arithmetic removed
("copies": the staging alone), at the launch plan's tiling.

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
    edits = {
        ("2d", "compute"): [("if (dst[j] >= 0) cp_async_node", "if (false) cp_async_node")],
        ("2d", "copies"): [("if (!active) continue;", "continue;")],
        ("3d", "compute"): [("i < NX3; i += 32) cp_async_value", "i < 0; i += 32) cp_async_value"),
                            ("c < cplane / kVec; c += nthreads)", "c < 0; c += nthreads)")],
        ("3d", "copies"): [("if (!active) continue;", "continue;")],
    }
    out = {("2d", "whole"): src2, ("3d", "whole"): src3}
    for (kind, name), pairs in edits.items():
        out[kind, name] = edited(src2 if kind == "2d" else src3, pairs, f"{kind} {name}")
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
        for name in ("whole", "compute", "copies"):
            fn = getattr(libs[kind, name], f"vbicm_stencil{'' if kind == '2d' else '3d'}_affine_"
                         f"{'f32' if dtype == torch.float32 else 'f64'}")
            err = launch(fn)
            if err:
                raise RuntimeError(f"{kind} {name} launch failed with CUDA error {err}")
            row[f"{name}_ms"] = graph_time_s(lambda: launch(fn)) * 1e3
        print(json.dumps({"kernel": kind, "grid": grid, "B": B, "dtype": str(dtype)[6:],
                          "plan": str(plan), **row}), flush=True)

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
