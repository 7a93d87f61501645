"""Batched hex8-box affine stencil matvec: the CUDA kernel's wrapper and its
plain PyTorch version (counterpart of ``vbicm_tpu/ops/stencil3d_pallas.py``).

For a batch of samples s on the (NZ, NY, NX) node grid of a structured hex8
box, ``q[s] = (c0[s] K_lam + c1[s] K_mu) u[s]``. The kernel
(``csrc/stencil3d_affine.cu``) reads the operator as 198 dof-interleaved
coefficient planes per (z, y) row (:func:`pack_w_interleaved_3d`); the plain
version reads the unpacked block tables W (2, NZ, NY, NX, 3, 3, 3, 3, 3) of
``ops.stencil3d``, so a fault in the packing cannot hide in both. On CPU
tensors the wrapper runs the plain version; on CUDA tensors it launches the
kernel or raises.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _build

# Shared memory one block may use on Hopper (227 KB); the kernel stages
# _TILE * 9 rows of 3NX + 10 values.
_SMEM_BYTES = 232448
# Samples a block, as compiled into the kernel: at B = 256 on 32x8x8 and
# 64x16x16, f32 and f64, tile 4 was faster than 8 on an H100 (tile 8 stages
# twice the shared memory, so fewer blocks fit on an SM; PERF.md).
_TILE = 4
_PLANES = 198  # 2 parts x 9 (dz, dy) rows x 11 lane offsets


def pack_w_interleaved_3d(W) -> np.ndarray:
    """(2, NZ, NY, NX, 3, 3, 3, 3, 3) block tables -> (NZ*NY, 198, 3NX)
    planes: plane (p*9 + dz*3 + dy)*11 + (delta + 5), lane 3x + a, holds
    W[p, z, y, x, dz, dy, dx, a, b] for the one (dx, b) with
    delta = 3(dx - 1) + b - a. The JAX package's packing without its TPU
    padding (198 -> 200 rows, lanes to a multiple of 128)."""
    W = np.asarray(W)
    P, NZ, NY, NX = W.shape[:4]
    if P != 2:
        raise ValueError(f"the stencil kernel takes 2 affine parts, got {P}")
    wt = np.zeros((NZ * NY, _PLANES, 3 * NX))
    for p in range(P):
        for dz in range(3):
            for dy in range(3):
                for dx in range(3):
                    for a in range(3):
                        for b in range(3):
                            kk = (p * 9 + dz * 3 + dy) * 11 + 3 * (dx - 1) + b - a + 5
                            wt[:, kk, a::3] = W[p, :, :, :, dz, dy, dx, a, b].reshape(NZ * NY, NX)
    return wt


def stencil3d_part_reference(Wp, u):
    """``K_p u`` for one part's tables Wp (NZ, NY, NX, 3, 3, 3, 3, 3),
    batched over u (B, 3*NZ*NY*NX): the 27 block offsets as plain PyTorch,
    in u's dtype."""
    NZ, NY, NX = Wp.shape[:3]
    B = u.shape[0]
    up = torch.nn.functional.pad(u.reshape(B, NZ, NY, NX, 3), (0, 0, 1, 1, 1, 1, 1, 1))
    acc = None
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                t = torch.einsum("zyxab,szyxb->szyxa", Wp[:, :, :, dz, dy, dx],
                                 up[:, dz:dz + NZ, dy:dy + NY, dx:dx + NX])
                acc = t if acc is None else acc + t
    return acc.reshape(B, -1)


def stencil3d_affine_reference(W, coeffs, u):
    """Plain PyTorch version: ``sum_p c_p K_p u`` on the unpacked tables W
    (2, NZ, NY, NX, 3, 3, 3, 3, 3), batched over u (B, 3*NZ*NY*NX), in u's
    dtype."""
    c = coeffs.to(u.dtype)
    q = None
    for p in range(W.shape[0]):
        qp = c[:, p:p + 1] * stencil3d_part_reference(W[p], u)
        q = qp if q is None else q + qp
    return q


def staged_bytes(nx3: int, itemsize: int) -> int:
    """Shared memory one block stages: its _TILE samples' 9 u rows of
    ``nx3 + 10`` values. Raises if that exceeds a block's shared memory."""
    nbytes = _TILE * 9 * (nx3 + 10) * itemsize
    if nbytes > _SMEM_BYTES:
        raise ValueError(f"a grid row of {nx3} lanes is too long for the 3-D stencil kernel's "
                         f"shared memory ({nbytes} > {_SMEM_BYTES} bytes)")
    return nbytes


def stencil3d_affine_matvec(W, w_planes, coeffs, u):
    """Batched ``q = (c0 K_lam + c1 K_mu) u`` through the CUDA kernel.

    W: (2, NZ, NY, NX, 3, 3, 3, 3, 3) block tables, the plain version's
    operand; w_planes: (NZ*NY, 198, 3NX) packed planes, the kernel's;
    coeffs (B, 2); u (B, 3*NZ*NY*NX). CPU tensors run
    :func:`stencil3d_affine_reference` on W; CUDA tensors, all float32 or all
    float64, run the kernel on w_planes, and W, which may stay on the host,
    gives only the grid's shape. Returns q in u's dtype.

    ``stencil3d_affine_matvec.launches`` counts the kernel's launches.
    """
    if u.device.type == "cpu":
        return stencil3d_affine_reference(W, coeffs, u)
    tensors = (w_planes, coeffs, u)
    device = u.device
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError(f"stencil3d_affine_matvec: tensors on "
                         f"{[str(t.device) for t in tensors]}; all must be on one CUDA device "
                         "(or u on the CPU)")
    dtype = u.dtype
    if dtype not in (torch.float32, torch.float64) or any(t.dtype != dtype for t in tensors):
        raise TypeError(f"stencil3d_affine_matvec: dtypes {[t.dtype for t in tensors]}; "
                        "all must be float32 or all float64")
    NZ, NY, NX = W.shape[1:4]
    NX3 = 3 * NX
    B = u.shape[0]
    if (tuple(w_planes.shape) != (NZ * NY, _PLANES, NX3) or coeffs.shape != (B, 2)
            or u.shape != (B, NZ * NY * NX3)):
        raise ValueError(f"stencil3d_affine_matvec: shapes W {tuple(W.shape)}, w_planes "
                         f"{tuple(w_planes.shape)}, coeffs {tuple(coeffs.shape)}, "
                         f"u {tuple(u.shape)}")
    for name, t in (("w_planes", w_planes), ("coeffs", coeffs), ("u", u)):
        if not t.is_contiguous():
            raise ValueError(f"stencil3d_affine_matvec: {name} must be contiguous")

    q = torch.empty_like(u)
    if B > 0:
        lib, _, _ = _build.load_library()
        fn = (lib.vbicm_stencil3d_affine_f32 if dtype == torch.float32
              else lib.vbicm_stencil3d_affine_f64)
        staged_bytes(NX3, u.element_size())
        with torch.cuda.device(device):
            err = fn(w_planes.data_ptr(), coeffs.data_ptr(), u.data_ptr(), q.data_ptr(),
                     B, NZ, NY, NX3, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"stencil3d_affine kernel launch failed with CUDA error {err} "
                               f"(B={B}, NZ={NZ}, NY={NY}, NX3={NX3}, {dtype})")
        stencil3d_affine_matvec.launches += 1
    return q


stencil3d_affine_matvec.launches = 0
