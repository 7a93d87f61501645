"""Batched structured-grid affine stencil matvec: the CUDA kernel's wrapper
and its plain PyTorch version (counterpart of
``vbicm_tpu/ops/stencil_pallas.py``).

For a batch of samples s on the (NY, NX) node grid of a structured quad4
mesh, ``q[s] = (c0[s] K_lam + c1[s] K_mu) u[s]``. The kernel
(``csrc/stencil_affine.cu``) reads the operator as 42 dof-interleaved
coefficient planes (:func:`pack_w_interleaved`); the plain version reads the
unpacked block tables W (2, NY, NX, 3, 3, 2, 2) of ``ops.stencil``, so a
fault in the packing cannot hide in both. On CPU tensors the wrapper runs the
plain version; on CUDA tensors it launches the kernel or raises.

``rows_per_block`` > 1 selects the kernel's rows-per-block option (the
counterpart of ``stencil_affine_matvec_pallas_mr``): a block stages its
rows + 2 u rows once and overlaps the next row's copy with the current row's
arithmetic. Its result is bitwise equal to the one-row kernel's.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _build

# Shared memory one block may use on Hopper (227 KB); the kernel stages
# TS * (rows_per_block + 2) rows of 2NX + 6 values and TS coefficient pairs.
_SMEM_BYTES = 232448
_SAMPLE_TILE = 8
_MAX_THREADS = 512


def pack_w_interleaved(W) -> np.ndarray:
    """(2, NY, NX, 3, 3, 2, 2) block tables -> (NY, 42, 2NX) planes: plane
    (p*3 + dy)*7 + (delta + 3), lane 2x + a, holds the sum over (dx, b) with
    2(dx-1) + b - a = delta of W[p, y, x, dy, dx, a, b]. The JAX package's
    packing without its TPU padding (42 -> 48 rows, lanes to 128)."""
    W = np.asarray(W)
    P, NY, NX = W.shape[:3]
    if P != 2:
        raise ValueError(f"the stencil kernel takes 2 affine parts, got {P}")
    wt = np.zeros((NY, 42, 2 * NX))
    for p in range(P):
        for dy in range(3):
            for dx in range(3):
                for a in range(2):
                    for b in range(2):
                        kk = (p * 3 + dy) * 7 + 2 * (dx - 1) + b - a + 3
                        wt[:, kk, a::2] += W[p, :, :, dy, dx, a, b]
    return wt


def stencil_part_reference(Wp, u):
    """``K_p u`` for one part's tables Wp (NY, NX, 3, 3, 2, 2), batched over
    u (B, 2*NY*NX): the 9 block offsets as plain PyTorch, in u's dtype."""
    NY, NX = Wp.shape[:2]
    B = u.shape[0]
    up = torch.nn.functional.pad(u.reshape(B, NY, NX, 2), (0, 0, 1, 1, 1, 1))
    acc = None
    for dy in range(3):
        for dx in range(3):
            t = torch.einsum("yxab,syxb->syxa", Wp[:, :, dy, dx], up[:, dy:dy + NY, dx:dx + NX])
            acc = t if acc is None else acc + t
    return acc.reshape(B, -1)


def stencil_affine_reference(W, coeffs, u):
    """Plain PyTorch version: ``sum_p c_p K_p u`` on the unpacked tables W
    (2, NY, NX, 3, 3, 2, 2), batched over u (B, 2*NY*NX), in u's dtype."""
    c = coeffs.to(u.dtype)
    q = None
    for p in range(W.shape[0]):
        qp = c[:, p:p + 1] * stencil_part_reference(W[p], u)
        q = qp if q is None else q + qp
    return q


def sample_tile(nx2: int, B: int, itemsize: int, rows_per_block: int = 1) -> int:
    """Samples per block: up to 8, fewer when B is smaller or the staged
    rows (rows_per_block + 2 of them a sample) would not fit in a block's
    shared memory."""
    row = (rows_per_block + 2) * (nx2 + 6) + 2
    tile = min(_SAMPLE_TILE, B, _SMEM_BYTES // (row * itemsize))
    if tile < 1:
        raise ValueError(f"{rows_per_block} grid row(s) of {nx2} lanes do not fit the stencil "
                         f"kernel's shared memory ({_SMEM_BYTES} bytes)")
    return tile


def stencil_affine_matvec(W, w_planes, coeffs, u, rows_per_block: int = 1):
    """Batched ``q = (c0 K_lam + c1 K_mu) u`` through the CUDA kernel.

    W: (2, NY, NX, 3, 3, 2, 2) block tables (the plain version's operand);
    w_planes: (NY, 42, 2NX) packed planes (the kernel's); coeffs (B, 2);
    u (B, 2*NY*NX). CPU tensors run :func:`stencil_affine_reference` on W;
    CUDA tensors, all float32 or all float64, run the kernel on w_planes:
    one grid row a block, or ``rows_per_block`` rows a block (the last block
    takes the rest), bitwise equal. Returns q (B, 2*NY*NX) in u's dtype.

    ``stencil_affine_matvec.launches`` counts the one-row kernel's launches,
    ``stencil_affine_matvec.rows_launches`` the rows-per-block option's.
    """
    if not (isinstance(rows_per_block, int) and rows_per_block >= 1):
        raise ValueError(f"rows_per_block must be a positive int, got {rows_per_block!r}")
    if u.device.type == "cpu":
        return stencil_affine_reference(W, coeffs, u)
    tensors = (w_planes, coeffs, u)
    device = u.device
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError(f"stencil_affine_matvec: tensors on {[str(t.device) for t in tensors]}; "
                         "all must be on one CUDA device (or u on the CPU)")
    dtype = u.dtype
    if dtype not in (torch.float32, torch.float64) or any(t.dtype != dtype for t in tensors):
        raise TypeError(f"stencil_affine_matvec: dtypes {[t.dtype for t in tensors]}; "
                        "all must be float32 or all float64")
    NY, planes, NX2 = w_planes.shape
    B = u.shape[0]
    if planes != 42 or coeffs.shape != (B, 2) or u.shape != (B, NY * NX2):
        raise ValueError(f"stencil_affine_matvec: shapes w_planes {tuple(w_planes.shape)}, "
                         f"coeffs {tuple(coeffs.shape)}, u {tuple(u.shape)}")
    for name, t in (("w_planes", w_planes), ("coeffs", coeffs), ("u", u)):
        if not t.is_contiguous():
            raise ValueError(f"stencil_affine_matvec: {name} must be contiguous")

    q = torch.empty_like(u)
    if B > 0:
        lib, _, _ = _build.load_library()
        f32 = dtype == torch.float32
        tile = sample_tile(NX2, B, u.element_size(), rows_per_block)
        threads = min(_MAX_THREADS, -(-NX2 // 32) * 32)
        ptrs = (w_planes.data_ptr(), coeffs.data_ptr(), u.data_ptr(), q.data_ptr())
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            if rows_per_block == 1:
                fn = lib.vbicm_stencil_affine_f32 if f32 else lib.vbicm_stencil_affine_f64
                err = fn(*ptrs, B, NY, NX2, tile, threads, stream)
            else:
                fn = lib.vbicm_stencil_affine_rows_f32 if f32 else lib.vbicm_stencil_affine_rows_f64
                err = fn(*ptrs, B, NY, NX2, tile, rows_per_block, threads, stream)
        if err != 0:
            raise RuntimeError(f"stencil_affine kernel launch failed with CUDA error {err} "
                               f"(B={B}, NY={NY}, NX2={NX2}, tile={tile}, "
                               f"rows_per_block={rows_per_block}, {dtype})")
        if rows_per_block == 1:
            stencil_affine_matvec.launches += 1
        else:
            stencil_affine_matvec.rows_launches += 1
    return q


stencil_affine_matvec.launches = 0
stencil_affine_matvec.rows_launches = 0
