"""Build and load the package's CUDA kernels.

The sources under ``csrc/`` (the spectral apply, the 2-D stencil matvec,
the banded tensor-core stencil, the 3-D stencil matvec, the element matvec,
the hat transfers, CG's vector updates and the FMA-ceiling probe) have a plain C interface;
shared device code sits in ``csrc/*.cuh`` headers. At first use each source is compiled with
``nvcc`` for ``sm_90a``, all at once in parallel processes, and the
objects are linked into one shared library under ``build/vbicm_tpu_torch/``
at the root of the checkout, loaded with ``ctypes``. The library's file name carries a hash of the sources, headers
and flags, so an edited source or header builds anew and a stale library is
never loaded. Nothing is fetched; a failed build raises.

The kernels' wrappers (``ops/*_kernel.py``, ``ops/stencil_mxu.py``,
``ops/peak_probe.py``) check their CUDA operands with :func:`check_operands`
and launch through :func:`launch`, which counts each call in the
``utils.trace`` counter ``<entry>.launches``.
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

import torch

from .utils.trace import count

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "vbicm_tpu_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_DBL = ctypes.c_double
_INTS = ctypes.POINTER(ctypes.c_int)
CUDA_ERROR_INVALID_VALUE = 1  # cudaErrorInvalidValue
_SIGNATURES = {
    # (V, g, coeffs, b, x, a, ws, B, n, bm, bn, split, vec, stream) -> cudaError_t
    "vbicm_spectral_apply_f32": [_PTR] * 7 + [_INT] * 6 + [_PTR],
    "vbicm_spectral_apply_f64": [_PTR] * 7 + [_INT] * 6 + [_PTR],
    # (w, coeffs, u, q, B, NY, NX2, R, RT, W, stream) -> cudaError_t
    "vbicm_stencil_affine_f32": [_PTR] * 4 + [_INT] * 6 + [_PTR],
    "vbicm_stencil_affine_f64": [_PTR] * 4 + [_INT] * 6 + [_PTR],
    # (NX2, RT, out[3]) -> cudaError_t
    "vbicm_stencil_affine_fit_f32": [_INT, _INT, _INTS],
    "vbicm_stencil_affine_fit_f64": [_INT, _INT, _INTS],
    # (m_hi, m_lo, coeffs, u, q, B, NY, NX2, stream) -> cudaError_t; the
    # float32 table's entry point takes its one table as m_hi
    "vbicm_stencil_mxu_bf16x3": [_PTR] * 5 + [_INT] * 3 + [_PTR],
    "vbicm_stencil_mxu_f32": [_PTR] * 5 + [_INT] * 3 + [_PTR],
    # (B, NY, NX2, out[3]) -> cudaError_t
    "vbicm_stencil_mxu_plan_bf16x3": [_INT, _INT, _INT, _INTS],
    "vbicm_stencil_mxu_plan_f32": [_INT, _INT, _INT, _INTS],
    # (a, b, out, B, NY, XLP, nfma, stream) -> cudaError_t
    "vbicm_fma_probe_f32": [_PTR] * 3 + [_INT] * 4 + [_PTR],
    "vbicm_fma_probe_f64": [_PTR] * 3 + [_INT] * 4 + [_PTR],
    # (w, coeffs, u, q, B, NZ, NY, NX3, G, stream) -> cudaError_t
    "vbicm_stencil3d_affine_f32": [_PTR] * 4 + [_INT] * 5 + [_PTR],
    "vbicm_stencil3d_affine_f64": [_PTR] * 4 + [_INT] * 5 + [_PTR],
    # (NX3, G, out[5]) -> cudaError_t
    "vbicm_stencil3d_affine_fit_f32": [_INT, _INT, _INTS],
    "vbicm_stencil3d_affine_fit_f64": [_INT, _INT, _INTS],
    # (ke, lm, row_ptr, ent, coeffs, u, q, B, ndof, nele, edof, stream) -> cudaError_t
    "vbicm_element_affine_f32": [_PTR] * 7 + [_INT] * 4 + [_PTR],
    "vbicm_element_affine_f64": [_PTR] * 7 + [_INT] * 4 + [_PTR],
    # (B, ndof, edof, out[3]) -> cudaError_t
    "vbicm_element_affine_plan_f32": [_INT, _INT, _INT, _INTS],
    "vbicm_element_affine_plan_f64": [_INT, _INT, _INT, _INTS],
    # (fine, coarse, B, naxes, ndof, r, cz, cy, cx, tz, ty, stream) -> cudaError_t
    "vbicm_hat_restrict_f32": [_PTR] * 2 + [_INT] * 9 + [_PTR],
    "vbicm_hat_restrict_f64": [_PTR] * 2 + [_INT] * 9 + [_PTR],
    # (coarse, fine, B, naxes, ndof, r, cz, cy, cx, lines, stream) -> cudaError_t
    "vbicm_hat_prolong_f32": [_PTR] * 2 + [_INT] * 8 + [_PTR],
    "vbicm_hat_prolong_f64": [_PTR] * 2 + [_INT] * 8 + [_PTR],
    # (fine, mask, slots, coarse, nfree, B, naxes, ndof, r, cz, cy, cx, tz, ty, stream)
    "vbicm_hat_restrict_prec_f32": [_PTR] * 4 + [_INT] * 10 + [_PTR],
    "vbicm_hat_restrict_prec_f64": [_PTR] * 4 + [_INT] * 10 + [_PTR],
    # (coarse, slots, res, dinv, mask, omega, z, nfree, B, naxes, ndof, r, cz, cy, cx, lines,
    #  stream)
    "vbicm_hat_prolong_prec_f32": [_PTR] * 5 + [_DBL, _PTR] + [_INT] * 9 + [_PTR],
    "vbicm_hat_prolong_prec_f64": [_PTR] * 5 + [_DBL, _PTR] + [_INT] * 9 + [_PTR],
    # (state, kp or z, vec, stream) -> cudaError_t
    "vbicm_cg_alpha_step_f32": [_PTR, _PTR, _INT, _PTR],
    "vbicm_cg_alpha_step_f64": [_PTR, _PTR, _INT, _PTR],
    "vbicm_cg_beta_step_f32": [_PTR, _PTR, _INT, _PTR],
    "vbicm_cg_beta_step_f64": [_PTR, _PTR, _INT, _PTR],
    # (beta, cluster, out[3]) -> cudaError_t
    "vbicm_cg_fit_f32": [_INT, _INT, _INTS],
    "vbicm_cg_fit_f64": [_INT, _INT, _INTS],
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
    headers = sorted(glob.glob(os.path.join(_PKG_DIR, "csrc", "*.cuh")))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources + headers:
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


def kernel_fit(fn, n, *args):
    """What a ``*_fit_*`` entry point reports for a launch on the current
    device, as a tuple of its ``n`` ints; None where the kernel cannot take
    that launch (the entry point returns cudaErrorInvalidValue). Raises
    ``RuntimeError`` on any other CUDA error."""
    out = (ctypes.c_int * n)()
    err = fn(*args, out)
    if err == CUDA_ERROR_INVALID_VALUE:
        return None
    if err != 0:
        raise RuntimeError(f"{fn.__name__}{args} failed with CUDA error {err}")
    return tuple(out)


_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_ENTRIES = {}


def entry(name: str, kind):
    """The library's entry point ``vbicm_<name>_<suffix>``, the suffix
    ``f32`` or ``f64`` for a dtype ``kind``, else ``kind`` itself (a mode);
    resolved once."""
    fn = _ENTRIES.get((name, kind))
    if fn is None:
        lib, _, _ = load_library()
        fn = _ENTRIES[name, kind] = getattr(lib, f"vbicm_{name}_{_SUFFIX.get(kind, kind)}")
    return fn


def check_operands(who: str, names, tensors, floats: int = 0, align=()):
    """Check the operands of the wrapper ``who`` before it launches a kernel.
    ``names`` and ``tensors`` pair up: the first ``floats`` tensors all
    float32 or all float64 (else ``TypeError``); every tensor contiguous and
    the i-th starting on an ``align[i]``-byte boundary (0 or past the end:
    any); all on one CUDA device (else ``ValueError``). Returns the device."""
    if floats:
        dtype = tensors[0].dtype
        if dtype not in _SUFFIX or any(t.dtype != dtype for t in tensors[1:floats]):
            raise TypeError(f"{who}: dtypes {[t.dtype for t in tensors[:floats]]}; "
                            "all must be float32 or all float64")
    for i, t in enumerate(tensors):
        if not t.is_contiguous():
            raise ValueError(f"{who}: {names[i]} must be contiguous")
        if i < len(align) and align[i] and t.data_ptr() % align[i]:
            raise ValueError(f"{who}: {names[i]} must be {align[i]}-byte aligned")
    device = tensors[0].device
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError(f"{who}: tensors on {[str(t.device) for t in tensors]}; all must be "
                         "on one CUDA device (or on the CPU)")
    return device


def launch(name: str, kind, device, args, detail, counter=None):
    """Launch :func:`entry` ``(name, kind)`` with ``args`` and the current
    stream of the CUDA ``device``, under a device guard only where the device
    is not the current one; count the call in ``<counter or name>.launches``.
    A nonzero CUDA error raises ``RuntimeError`` with ``detail()``, the
    wrapper's account of the launch."""
    fn = _ENTRIES.get((name, kind)) or entry(name, kind)
    index = device.index
    if index == torch._C._cuda_getDevice():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err} {detail()}")
    count(f"{counter or name}.launches")
