"""Batched structured-grid affine stencil as banded dense products on the
tensor cores: the CUDA kernel's wrapper, the table packing and the plain
PyTorch version (counterpart of ``vbicm_tpu/ops/stencil_mxu.py``).

The function is ``ops.stencil_kernel``'s, ``q = (c0 K_lam + c1 K_mu) u``
on the (NY, NX) grid of a structured quad4 mesh. For each grid row y and
128-lane output tile t, the three contributing u rows' 136-lane source
windows (starting at lane ``t*128 - 3``) and 8 zeros make one (B, 416)
operand, multiplied by a (416, 256) banded table whose two 128-column
halves are the two affine parts:

    acc[b, p*128 + k] = sum_{dy, w} u[b, y+dy-1, t*128 + w - 3] * M[y, t][dy*136 + w, p*128 + k]
    q[b, y, t*128 + k] = c0[b] * acc[b, k] + c1[b] * acc[b, 128 + k]

Precision modes, as the JAX package's:

* ``"bf16x3"``: u and the table are split into bfloat16 high and low
  halves, and ``uh Mh + ul Mh + uh Ml`` is summed in float32 (about 1e-5 of
  max|q| from the exact operator);
* ``"f32"``: one float32 table and float32-accurate products (the kernel
  uses three TF32 products of a big/small split, 3xTF32).

The table holds NY*T*416*256 entries (25.9 M at 160x80, 103.5 MB in either
mode): densifying the 7-tap band costs about 19x the band's flops. On CPU
tensors the wrapper runs the plain version; on CUDA tensors it launches the
kernel (``csrc/stencil_mxu.cu``) or raises.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _build

LPAD = 8  # leading zero lanes of the padded u row (>= the 3 halo lanes)
WIN = 136  # source window of one u row: 128 lanes + 6 taps + 2 of padding
KDIM = 3 * WIN + 8  # the three windows and 8 zeros: 416
MODES = ("bf16x3", "f32")


def n_tiles(NX: int) -> int:
    """T, the 128-lane output tiles of a grid row of 2NX lanes."""
    return -(-2 * NX // 128)


def pack_w_bands(W, mode: str = "bf16x3"):
    """(2, NY, NX, 3, 3, 2, 2) stencil tables -> banded tables
    (NY*T*KDIM, 256): row block [y, t] is a (KDIM, 256) matrix whose row
    dy*WIN + k + d, column p*128 + k holds the folded coefficient for output
    lane i = t*128 + k (dof-interleaved i = 2x + a) from source lane
    i + d - 3, summed over (dx, b) with 2(dx-1) + b - a = d - 3.

    Returns a (hi, lo) pair of bfloat16 tensors for ``"bf16x3"`` (hi the
    float64 table rounded to bfloat16, lo the rest rounded likewise; both
    round through float32, as the JAX package's conversion does), or one
    float32 tensor for ``"f32"``, on the CPU.
    """
    W = np.asarray(W)
    P, NY, NX = W.shape[:3]
    if P != 2:
        raise ValueError(f"the banded stencil takes 2 affine parts, got {P}")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    NX2 = 2 * NX
    T = n_tiles(NX)
    planes = np.zeros((P, NY, 3, 7, T * 128))
    for p in range(P):
        for dy in range(3):
            for dx in range(3):
                for a in range(2):
                    for b in range(2):
                        delta = 2 * (dx - 1) + b - a
                        planes[p, :, dy, delta + 3, a:NX2:2] += W[p, :, :, dy, dx, a, b]
    out = np.zeros((NY, T, KDIM, 256))
    k = np.arange(128)
    for p in range(P):
        for dy in range(3):
            for t in range(T):
                for d in range(7):
                    out[:, t, dy * WIN + k + d, p * 128 + k] = planes[p, :, dy, d,
                                                                      t * 128:(t + 1) * 128]
    out = torch.as_tensor(out.reshape(NY * T * KDIM, 256))
    if mode == "f32":
        return out.to(torch.float32)
    hi = out.to(torch.bfloat16)
    lo = (out - hi.to(torch.float64)).to(torch.bfloat16)
    return hi, lo


def band_windows(u, NY: int, NX: int):
    """(B, NY*2NX) -> (NY*T, B, KDIM) float32 operands: for grid row y and
    tile t the three u rows' windows from padded lane ``LPAD - 3 + t*128``
    and 8 zeros, rows outside the grid zero."""
    B = u.shape[0]
    NX2 = 2 * NX
    T = n_tiles(NX)
    XL = -(-(LPAD + T * 128) // 128) * 128
    g = u.to(torch.float32).reshape(B, NY, NX2)
    upad = torch.nn.functional.pad(g, (LPAD, XL - NX2 - LPAD, 1, 1))  # (B, NY + 2, XL)
    zpad = upad.new_zeros(B, NY, KDIM - 3 * WIN)
    tiles = []
    for t in range(T):
        s = LPAD - 3 + t * 128
        tiles.append(torch.cat([upad[:, dy:dy + NY, s:s + WIN] for dy in range(3)] + [zpad], -1))
    uw = torch.stack(tiles, 2)  # (B, NY, T, KDIM)
    return uw.reshape(B, NY * T, KDIM).transpose(0, 1)


def split_bf16(x):
    """float32 x -> (hi, lo) bfloat16 with hi = bf16(x), lo = bf16(x - hi)."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.to(torch.float32)).to(torch.bfloat16)


def stencil_affine_mxu_reference(m_bands, coeffs, u, NY: int, NX: int, mode: str = "bf16x3"):
    """Plain PyTorch version: the same windows, bfloat16 splits and products
    (exact in float32, since a product of two bfloat16 values is), summed in
    float32 by batched matrix products, then the two halves combined.
    Returns (B, NY*2NX) float32."""
    B = u.shape[0]
    NX2 = 2 * NX
    T = n_tiles(NX)
    uw = band_windows(u, NY, NX)
    if mode == "bf16x3":
        mh, ml = (m.to(torch.float32).reshape(NY * T, KDIM, 256) for m in m_bands)
        uh, ul = (x.to(torch.float32) for x in split_bf16(uw))
        acc = torch.bmm(uh, mh) + torch.bmm(ul, mh) + torch.bmm(uh, ml)
    elif mode == "f32":
        acc = torch.bmm(uw, m_bands.to(torch.float32).reshape(NY * T, KDIM, 256))
    else:
        raise ValueError(f"unknown mode {mode!r}")
    c = coeffs.to(torch.float32)
    q = (c[:, 0:1] * acc[..., :128] + c[:, 1:2] * acc[..., 128:]).reshape(NY, T, B, 128)
    return q.permute(2, 0, 1, 3).reshape(B, NY, T * 128)[:, :, :NX2].reshape(B, NY * NX2)


def stencil_affine_matvec_mxu(m_bands, coeffs, u, NY: int, NX: int, mode: str = "bf16x3"):
    """q = K(c) u for a batch through banded tensor-core products.

    m_bands: from :func:`pack_w_bands` (a (hi, lo) bfloat16 pair for
    ``"bf16x3"``, a float32 table for ``"f32"``); coeffs (B, 2); u (B,
    NY*2NX). CPU tensors run :func:`stencil_affine_mxu_reference`; CUDA
    tensors (coeffs and u float32) the kernel. Returns (B, NY*2NX) float32.

    ``stencil_affine_matvec_mxu.launches`` counts the kernel's launches.
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    tables = tuple(m_bands) if mode == "bf16x3" else (m_bands,)
    if u.device.type == "cpu":
        return stencil_affine_mxu_reference(m_bands, coeffs, u, NY, NX, mode)
    tensors = (*tables, coeffs, u)
    device = u.device
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError(f"stencil_affine_matvec_mxu: tensors on {[str(t.device) for t in tensors]}; "
                         "all must be on one CUDA device (or u on the CPU)")
    table_dtype = torch.bfloat16 if mode == "bf16x3" else torch.float32
    if (u.dtype != torch.float32 or coeffs.dtype != torch.float32
            or any(t.dtype != table_dtype for t in tables)):
        raise TypeError(f"stencil_affine_matvec_mxu ({mode}): dtypes {[t.dtype for t in tensors]}; "
                        f"tables {table_dtype}, coeffs and u float32")
    B = u.shape[0]
    NX2 = 2 * NX
    rows = NY * n_tiles(NX) * KDIM
    if (coeffs.shape != (B, 2) or u.shape != (B, NY * NX2)
            or any(t.shape != (rows, 256) for t in tables)):
        raise ValueError(f"stencil_affine_matvec_mxu: shapes tables "
                         f"{[tuple(t.shape) for t in tables]}, coeffs {tuple(coeffs.shape)}, "
                         f"u {tuple(u.shape)} for NY={NY}, NX={NX}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("stencil_affine_matvec_mxu: every tensor must be contiguous")

    q = torch.empty_like(u)
    if B > 0:
        lib, _, _ = _build.load_library()
        fn = lib.vbicm_stencil_mxu_bf16x3 if mode == "bf16x3" else lib.vbicm_stencil_mxu_f32
        lo = tables[1].data_ptr() if mode == "bf16x3" else None
        with torch.cuda.device(device):
            err = fn(tables[0].data_ptr(), lo, coeffs.data_ptr(), u.data_ptr(), q.data_ptr(),
                     B, NY, NX2, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"stencil_mxu kernel launch failed with CUDA error {err} "
                               f"(B={B}, NY={NY}, NX2={NX2}, {mode})")
        stencil_affine_matvec_mxu.launches += 1
    return q


stencil_affine_matvec_mxu.launches = 0
