"""Batched spectral solve-apply: the CUDA kernel's wrapper and its plain
PyTorch version (counterpart of ``vbicm_tpu/ops/spectral_pallas.py``).

For a batch of samples s,

    a[s] = (b[s] V) / d[s],   d[s] = c0[s] * g + c1[s]
    x[s] = a[s] V^T            (= K(c_s)^-1 b[s] for the pencil's V, g)

The kernel (``csrc/spectral_apply.cu``) runs an apply as two tiled
tensor-core products on the current stream: a = (b V) / d with the scale
fused into the first product's epilogue, then x = a V^T; where the grid is
short of the card each product's k-range is split and a second pass adds
the slices in order. Float32 runs as 3xTF32 (float32 accuracy), float64 on
DMMA. On CPU tensors the wrapper runs
the plain version; on CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import _build

# (BM, BN) output tiles the kernel is compiled for, largest first; each is
# one block of two 4-warp groups that split every k-tile
# (csrc/spectral_apply.cu, launch)
TILES = ((64, 64), (64, 32), (32, 32), (16, 32))
SMEM_BYTES = 232448  # shared memory one Hopper block may use (227 KB)
SMS = 132  # streaming multiprocessors of an H100 SXM
_STAGES = 3
_KSPLIT = 2  # warp groups a block, each over half of every k-tile
_BK = {4: 64, 8: 16}  # k-tile depth by itemsize
_PAD_ROW_K = {4: 8, 8: 4}  # row pads of the staged tiles (conflict-free fragment reads)
_PAD_K_COL = {4: 4, 8: 4}
_MIN_BLOCKS = {4: SMS // 2, 8: 2 * SMS}  # launch_plan's output tiles to aim for


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """The kernel's tiling for one (B, n): ``(bm, bn)`` output tile,
    ``split`` slices of the k-range (each a block, their sums added by a
    second pass when > 1), ``blocks`` a launch (tiles x split),
    ``smem_bytes`` of shared memory a block, and whether rows take 16-byte
    copies (``vec``)."""

    bm: int
    bn: int
    split: int
    blocks: int
    smem_bytes: int
    vec: bool


def tile_smem_bytes(bm: int, bn: int, itemsize: int) -> int:
    """Shared memory a block of either launch uses: three k-tiles of the
    (bm, BK) left operand and of V's (BK, bn) or (bn, BK) panel, or, at the
    end, the two groups' (bm, bn + 4) output tiles, whichever is larger."""
    bk = _BK[itemsize]
    pad = _PAD_ROW_K[itemsize]
    panel = max(bk * (bn + _PAD_K_COL[itemsize]), bn * (bk + pad))
    stages = _STAGES * itemsize * (bm * (bk + pad) + panel)
    return max(stages, _KSPLIT * bm * (bn + 4) * itemsize)


def split_for(tiles: int) -> int:
    """Slices of the k-range for a grid of ``tiles`` output tiles: the split
    S of 1 to 4 that gives the busiest SM the least work, ceil(tiles S /
    SMS) / S of a tile's (the smallest S on a tie), when that is at most
    three quarters of the unsplit grid's; else none. Each slice is a block;
    a second pass adds the slices' sums in order."""
    def busiest(s):
        return -(-tiles * s // SMS) / s

    best = min(range(1, 5), key=lambda s: (busiest(s), s))
    return best if busiest(best) <= 0.75 * busiest(1) else 1


def launch_plan(B: int, n: int, itemsize: int) -> LaunchPlan:
    """The tiling of an apply at (B, n): the largest output tile whose grid
    has at least ``_MIN_BLOCKS[itemsize]`` tiles (8 warps each), failing
    that the one with the most, and :func:`split_for`'s k-range split.
    Tiles taller than the batch's 16-row multiple are not considered (B = 8
    and 16 take the 16-row tile). tools/spectral_tiles.py times every tile
    and split on the card (PERF.md): in float32 the 64 x 64 tile is the
    fastest at (256, 1680), (256, 1200) and (4096, 1680), 32 x 32 at
    (256, 440); a split of 3 makes (256, 1200)'s 76 tiles 1.3x faster and a
    split is flat or slower once every SM has two blocks; the float64 (DMMA)
    tiles want two blocks an SM."""
    if B <= 0 or n <= 0:
        raise ValueError(f"launch_plan: B={B}, n={n} must be positive")
    if itemsize not in _BK:
        raise ValueError(f"launch_plan: itemsize {itemsize} is not float32's or float64's")
    rows = -(-B // 16) * 16
    cands = [t for t in TILES if t[0] <= rows]

    def tiles(t):
        return -(-B // t[0]) * -(-n // t[1])

    bm, bn = next((t for t in cands if tiles(t) >= _MIN_BLOCKS[itemsize]),
                  max(cands, key=tiles))
    split = split_for(tiles((bm, bn)))
    return LaunchPlan(bm, bn, split, tiles((bm, bn)) * split, tile_smem_bytes(bm, bn, itemsize),
                      (n * itemsize) % 16 == 0)


def spectral_apply_reference(V, g, coeffs, b, *, return_coords=False):
    """Plain PyTorch version: two matmuls and a divide, in the inputs' dtype."""
    d = coeffs[:, :1] * g[None, :] + coeffs[:, 1:2]
    a = (b @ V) / d
    x = a @ V.T
    return (x, a) if return_coords else x


def spectral_apply_batched(V, g, coeffs, b, *, return_coords=False):
    """Batched spectral apply through the CUDA kernel.

    V: (n, n) eigenbasis; g: (n,) eigenvalues; coeffs: (B, 2) per-sample
    (c0, c1); b: (B, n) right-hand sides, all one dtype (float32 or float64)
    on one device, contiguous. Returns x (B, n), or (x, a) with the
    eigen-coordinates a when ``return_coords``. The output tile is
    :func:`launch_plan`'s.

    Counter ``spectral_apply.launches`` (``utils.trace``): applies, one a
    call; an apply is two kernel launches (a, then x), four when the plan
    splits the k-range (each product's second pass).
    """
    tensors = (V, g, coeffs, b)
    if all(t.device.type == "cpu" for t in tensors):
        return spectral_apply_reference(V, g, coeffs, b, return_coords=return_coords)
    n = V.shape[0]
    B = b.shape[0]
    if V.shape != (n, n) or g.shape != (n,) or coeffs.shape != (B, 2) or b.shape != (B, n):
        raise ValueError(f"spectral_apply_batched: shapes V {tuple(V.shape)}, g {tuple(g.shape)}, "
                         f"coeffs {tuple(coeffs.shape)}, b {tuple(b.shape)}")
    device = _build.check_operands("spectral_apply_batched", ("V", "g", "coeffs", "b"), tensors,
                                   floats=4)
    dtype = V.dtype
    x = torch.empty((B, n), dtype=dtype, device=device)
    a = torch.empty((B, n), dtype=dtype, device=device)  # launch 2 reads it
    if B > 0:
        plan = launch_plan(B, n, V.element_size())
        vec = plan.vec and all(t.data_ptr() % 16 == 0 for t in (V, b, a))
        # the split's partial sums (S, B, n)
        ws = torch.empty((plan.split, B, n), dtype=dtype, device=device) if plan.split > 1 else None
        _build.launch("spectral_apply", dtype, device,
                      (V.data_ptr(), g.data_ptr(), coeffs.data_ptr(), b.data_ptr(), x.data_ptr(),
                       a.data_ptr(), None if ws is None else ws.data_ptr(), B, n, plan.bm, plan.bn,
                       plan.split, int(vec)),
                      lambda: f"(B={B}, n={n}, {plan}, vec={vec}, {dtype})")
    return (x, a) if return_coords else x
