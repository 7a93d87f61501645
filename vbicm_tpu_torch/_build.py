"""Build and load the package's CUDA kernels.

The sources under ``csrc/`` (the spectral apply, the 2-D stencil matvec
with its rows-per-block option, the banded tensor-core stencil, the 3-D
stencil matvec, the element matvec and the FMA-ceiling probe) have a plain
C interface. At first use each
is compiled with ``nvcc`` for ``sm_90a``, all at once in parallel
processes, and the objects are linked into one shared library under
``build/vbicm_tpu_torch/`` at the root of the checkout, loaded with
``ctypes``. The library's file name carries a hash of
the sources and flags, so an edited source builds anew and a stale library
is never loaded. Nothing is fetched; a failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "vbicm_tpu_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_SIGNATURES = {
    # (V, Vt, g, coeffs, b, x, a, B, n, tile, stream) -> cudaError_t
    "vbicm_spectral_apply_f32": [_PTR] * 7 + [_INT] * 3 + [_PTR],
    "vbicm_spectral_apply_f64": [_PTR] * 7 + [_INT] * 3 + [_PTR],
    # (w, coeffs, u, q, B, NY, NX2, TS, threads, stream) -> cudaError_t
    "vbicm_stencil_affine_f32": [_PTR] * 4 + [_INT] * 5 + [_PTR],
    "vbicm_stencil_affine_f64": [_PTR] * 4 + [_INT] * 5 + [_PTR],
    # (w, coeffs, u, q, B, NY, NX2, TS, RPP, threads, stream) -> cudaError_t
    "vbicm_stencil_affine_rows_f32": [_PTR] * 4 + [_INT] * 6 + [_PTR],
    "vbicm_stencil_affine_rows_f64": [_PTR] * 4 + [_INT] * 6 + [_PTR],
    # (m_hi, m_lo, coeffs, u, q, B, NY, NX2, stream) -> cudaError_t; the
    # float32 table's entry point takes its one table as m_hi
    "vbicm_stencil_mxu_bf16x3": [_PTR] * 5 + [_INT] * 3 + [_PTR],
    "vbicm_stencil_mxu_f32": [_PTR] * 5 + [_INT] * 3 + [_PTR],
    # (a, b, out, B, NY, XLP, nfma, stream) -> cudaError_t
    "vbicm_fma_probe_f32": [_PTR] * 3 + [_INT] * 4 + [_PTR],
    "vbicm_fma_probe_f64": [_PTR] * 3 + [_INT] * 4 + [_PTR],
    # (w, coeffs, u, q, B, NZ, NY, NX3, stream) -> cudaError_t
    "vbicm_stencil3d_affine_f32": [_PTR] * 4 + [_INT] * 4 + [_PTR],
    "vbicm_stencil3d_affine_f64": [_PTR] * 4 + [_INT] * 4 + [_PTR],
    # (ke, lm, row_ptr, ent, coeffs, u, q, B, ndof, nele, edof, stream) -> cudaError_t
    "vbicm_element_affine_f32": [_PTR] * 7 + [_INT] * 4 + [_PTR],
    "vbicm_element_affine_f64": [_PTR] * 7 + [_INT] * 4 + [_PTR],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; cannot build the CUDA kernels")


@functools.lru_cache(maxsize=None)
def load_library():
    """Compile (if needed) and load the kernels' shared library.

    Returns ``(lib, build_seconds, compiler_log)``; ``build_seconds`` is 0.0
    when a library built from the same sources was already on disk.
    """
    sources = sorted(glob.glob(os.path.join(_PKG_DIR, "csrc", "*.cu")))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        with open(path, "rb") as f:
            digest.update(f.read())
    lib_path = os.path.join(BUILD_DIR, f"libvbicm_kernels_{digest.hexdigest()[:16]}.so")
    log_path = lib_path[:-3] + ".log"

    seconds, log = 0.0, ""
    if not os.path.exists(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        nvcc = _nvcc()
        objs = [f"{tmp}.{os.path.basename(src)}.o" for src in sources]
        tic = time.perf_counter()
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src], text=True,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                 for src, obj in zip(sources, objs)]
        outs = [p.communicate()[0] for p in procs]
        log = "".join(outs)
        for p, src in zip(procs, sources):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}) on {src}:\n{log}")
        cmd = [nvcc, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - tic
        log += proc.stdout + proc.stderr
        for obj in objs:
            os.remove(obj)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
        with open(log_path, "w") as f:
            f.write(log)
        os.replace(tmp, lib_path)  # atomic: a concurrent build never sees half a file
    elif os.path.exists(log_path):
        with open(log_path) as f:
            log = f.read()

    lib = ctypes.CDLL(lib_path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, seconds, log
