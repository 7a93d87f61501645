"""Batched spectral solve-apply: the CUDA kernel's wrapper and its plain
PyTorch version (counterpart of ``vbicm_tpu/ops/spectral_pallas.py``).

For a batch of samples s,

    a[s] = (b[s] V) / d[s],   d[s] = c0[s] * g + c1[s]
    x[s] = a[s] V^T            (= K(c_s)^-1 b[s] for the pencil's V, g)

The kernel (``csrc/spectral_apply.cu``) keeps the (B, n) intermediate on
chip and stores it only when ``return_coords=True``. It takes float32 and
float64. On CPU tensors the wrapper runs the plain version; on CUDA tensors
it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from .. import _build

# Shared memory one block may use on Hopper (227 KB); the kernel stages two
# (tile, n) arrays: the tile's rows of b and its eigen-coordinates.
_SMEM_BYTES = 232448
_TILES = (8, 4, 2, 1)


def sample_tile(n: int, itemsize: int) -> int:
    """Samples per block: the largest tile whose two (tile, n) shared-memory
    arrays fit in a Hopper block's shared memory."""
    for tile in _TILES:
        if 2 * tile * n * itemsize <= _SMEM_BYTES:
            return tile
    raise ValueError(
        f"n={n} is too large for the spectral kernel: two rows of {n} "
        f"{itemsize}-byte values exceed {_SMEM_BYTES} bytes of shared memory"
    )


def spectral_apply_reference(V, g, coeffs, b, *, return_coords=False):
    """Plain PyTorch version: two matmuls and a divide, in the inputs' dtype."""
    d = coeffs[:, :1] * g[None, :] + coeffs[:, 1:2]
    a = (b @ V) / d
    x = a @ V.T
    return (x, a) if return_coords else x


def spectral_apply_batched(V, g, coeffs, b, *, return_coords=False, Vt=None):
    """Batched spectral apply through the CUDA kernel.

    V: (n, n) eigenbasis; g: (n,) eigenvalues; coeffs: (B, 2) per-sample
    (c0, c1); b: (B, n) right-hand sides, all one dtype (float32 or float64)
    on one device. ``Vt`` is ``V.T`` made contiguous; pass it when calling
    repeatedly with one V, or it is made here. Returns x (B, n), or (x, a)
    with the eigen-coordinates a when ``return_coords``.

    ``spectral_apply_batched.launches`` counts the kernel's launches.
    """
    tensors = (V, g, coeffs, b)
    if all(t.device.type == "cpu" for t in tensors):
        return spectral_apply_reference(V, g, coeffs, b, return_coords=return_coords)
    device = V.device
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError(f"spectral_apply_batched: tensors on {[str(t.device) for t in tensors]}; "
                         "all must be on one CUDA device (or all on the CPU)")
    dtype = V.dtype
    if dtype not in (torch.float32, torch.float64) or any(t.dtype != dtype for t in tensors):
        raise TypeError(f"spectral_apply_batched: dtypes {[t.dtype for t in tensors]}; "
                        "all must be float32 or all float64")
    n = V.shape[0]
    B = b.shape[0]
    if V.shape != (n, n) or g.shape != (n,) or coeffs.shape != (B, 2) or b.shape != (B, n):
        raise ValueError(f"spectral_apply_batched: shapes V {tuple(V.shape)}, g {tuple(g.shape)}, "
                         f"coeffs {tuple(coeffs.shape)}, b {tuple(b.shape)}")
    if Vt is None:
        Vt = V.T.contiguous()
    elif Vt.shape != (n, n) or Vt.dtype != dtype or Vt.device != device:
        raise ValueError("spectral_apply_batched: Vt must be V.T with V's dtype and device")
    for name, t in (("V", V), ("Vt", Vt), ("g", g), ("coeffs", coeffs), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"spectral_apply_batched: {name} must be contiguous")

    x = torch.empty((B, n), dtype=dtype, device=device)
    a = torch.empty((B, n), dtype=dtype, device=device) if return_coords else None
    if B > 0:
        lib, _, _ = _build.load_library()
        fn = lib.vbicm_spectral_apply_f32 if dtype == torch.float32 else lib.vbicm_spectral_apply_f64
        tile = sample_tile(n, V.element_size())
        with torch.cuda.device(device):
            err = fn(V.data_ptr(), Vt.data_ptr(), g.data_ptr(), coeffs.data_ptr(), b.data_ptr(),
                     x.data_ptr(), a.data_ptr() if a is not None else None,
                     B, n, tile, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"spectral_apply kernel launch failed with CUDA error {err} "
                               f"(B={B}, n={n}, tile={tile}, {dtype})")
        spectral_apply_batched.launches += 1
    return (x, a) if return_coords else x


spectral_apply_batched.launches = 0
