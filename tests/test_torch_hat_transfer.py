"""The hat transfers' kernel wrapper (``ops/hat_transfer_kernel.py``) on the
CPU: the plain version is today's matrix-product form bit for bit, the
wrapper refuses what the CUDA kernels do not take, and the kernels' launch
plan and index arithmetic (``csrc/hat_transfer.cu``), replayed on the host,
cover every output once and compute the plain version's sums. The kernels
themselves run on the card in chip_smoke.py."""
import importlib.util
import os
import re

import numpy as np
import pytest
import torch

from vbicm_tpu_torch.ops.hat_transfer_kernel import (
    SMEM_BUDGET,
    SMEM_MAX,
    grid_nodes,
    hat_transfer,
    launch_plan,
    smem_bytes,
)
from vbicm_tpu_torch.ops.multigrid import hat_matrix, make_grid_transfer_nd
from vbicm_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "vbicm_tpu_torch", "csrc", "hat_transfer.cu")

# (coarse cells slowest first, ratio, dofs a node): the fine grids 8x4,
# 16x8, 32x16 and the boxes 4x2x2, 6x4x2 of the port's small tests
SMALL = [((2, 4), 2, 2), ((2, 4), 4, 2), ((4, 8), 4, 2), ((1, 1, 2), 2, 3), ((1, 2, 3), 2, 3)]
# the benchmark cells' grid (160x80 at ratio 4), the 3-D boxes 32x8x8 and
# 64x16x16 and the 3-D field path's, and odd small grids and ratios
PLANNED = [((20, 40), 4, 2), ((2, 2, 8), 4, 3), ((4, 4, 16), 4, 3), ((8, 8, 32), 2, 3),
           ((3, 5), 2, 2), ((1, 1), 3, 2), ((2, 3, 1), 3, 3), ((5, 7), 2, 3), ((2, 2, 3), 4, 2)]


def _matmul_form(cells_coarse, ratio):
    """The transfers as ``make_grid_transfer_nd`` computed them before the
    kernels: one batched matrix product an axis."""
    nc = [c + 1 for c in cells_coarse]
    nf = [c * ratio + 1 for c in cells_coarse]
    ps = [torch.as_tensor(hat_matrix(f, c, ratio)) for f, c in zip(nf, nc)]

    def prolong(u_c):
        B, t = u_c.shape[0], u_c
        for k, p in enumerate(ps):
            t = torch.matmul(p.to(u_c.dtype), t.reshape(B * int(np.prod(nf[:k])), nc[k], -1))
        return t.reshape(B, -1)

    def restrict(r_f):
        B, t = r_f.shape[0], r_f
        for k in reversed(range(len(ps))):
            t = torch.matmul(ps[k].T.contiguous().to(r_f.dtype),
                             t.reshape(B * int(np.prod(nf[:k])), nf[k], -1))
        return t.reshape(B, -1)

    return prolong, restrict


def _sizes(cells_coarse, ratio, ndof):
    nf, nc = grid_nodes(cells_coarse, ratio)
    return ndof * int(np.prod(nf)), ndof * int(np.prod(nc))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("cells,ratio,ndof", SMALL)
def test_cpu_transfers_are_the_matmul_form_bitwise(cells, ratio, ndof, dtype):
    n_f, n_c = _sizes(cells, ratio, ndof)
    rng = np.random.default_rng(sum(cells) + ratio)
    u_c = torch.as_tensor(rng.normal(size=(5, n_c)), dtype=dtype)
    r_f = torch.as_tensor(rng.normal(size=(5, n_f)), dtype=dtype)
    prolong, restrict = make_grid_transfer_nd(cells, ratio, ndof)
    want_p, want_r = _matmul_form(cells, ratio)
    before = trace.counters().get("hat_transfer.launches", 0)
    assert torch.equal(prolong(u_c), want_p(u_c))
    assert torch.equal(restrict(r_f), want_r(r_f))
    assert trace.counters().get("hat_transfer.launches", 0) == before


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("x,kw,error,match", [
    (_meta((3, 30)), {}, ValueError, "CUDA device"),  # not on a CUDA device
    (_meta((3, 30), torch.float16), {}, TypeError, "float32"),
    (_meta((3, 30), torch.int32), {}, TypeError, "float32"),
    (_meta((3, 31)), {}, ValueError, "expected"),
    (_meta((3, 90)), {}, ValueError, "expected"),  # the fine size where coarse is due
    (_meta(30), {}, ValueError, "expected"),
    (_meta((30, 3)).T, {}, ValueError, "contiguous"),
    (_meta(3 * 30 + 1)[1:].view(3, 30), {}, ValueError, "aligned"),
    (_meta((3, 30)), {"ndof_node": 1}, ValueError, "dofs a node"),
    (_meta((3, 30)), {"ratio": 1}, ValueError, "ratio"),
    (_meta((3, 30)), {"cells_coarse": (1, 1, 1, 1)}, ValueError, "axes"),
], ids=["device", "half", "int", "size", "fine-size", "one-dim", "noncontiguous", "misaligned",
        "ndof", "ratio", "four-axes"])
def test_wrapper_refuses_what_the_kernels_do_not_take(x, kw, error, match):
    """A prolongation from the 8x4 grid's coarse grid at ratio 2 ((2, 4)
    cells, 30 coarse values), with one argument changed."""
    args = {"cells_coarse": (2, 4), "ratio": 2, "ndof_node": 2, **kw}
    before = trace.counters().get("hat_transfer.launches", 0)
    with pytest.raises(error, match=match):
        hat_transfer(x, None, args["cells_coarse"], args["ratio"], args["ndof_node"],
                     adjoint=False)
    assert trace.counters().get("hat_transfer.launches", 0) == before


def test_restriction_refuses_a_coarse_vector():
    with pytest.raises(ValueError, match="expected"):
        hat_transfer(_meta((3, 30)), None, (2, 4), 2, 2, adjoint=True)


def _axes3(cells, ratio):
    """(nz, ny, nx), (cz, cy, cx): a 2-D grid as one z-plane."""
    nf, nc = grid_nodes(cells, ratio)
    if len(cells) == 2:
        return (1, *nf), (1, *nc)
    return tuple(nf), tuple(nc)


def _restrict_tiles(B, cells, ratio, plan):
    """The restriction kernel's blocks as it numbers them: (sample, coarse z
    range, coarse y range, fine z window, fine y window), the kernel's
    integer arithmetic replayed."""
    (nz, ny, _), (cz, cy, _) = _axes3(cells, ratio)
    r = ratio
    nby, nbz = -(-cy // plan.ty), -(-cz // plan.tz)
    assert plan.restrict_blocks == B * nbz * nby
    for blk in range(plan.restrict_blocks):
        by, bz, s = blk % nby, (blk // nby) % nbz, blk // (nby * nbz)
        cz0, cy0 = bz * plan.tz, by * plan.ty
        cz1, cy1 = min(cz0 + plan.tz, cz), min(cy0 + plan.ty, cy)
        fz = (max(0, r * cz0 - r + 1), min(nz - 1, r * (cz1 - 1) + r - 1))
        fy = (max(0, r * cy0 - r + 1), min(ny - 1, r * (cy1 - 1) + r - 1))
        yield s, (cz0, cz1), (cy0, cy1), fz, fy


def _taps(c, r, n):
    """The fine taps of coarse node c along an axis of n fine nodes, and
    their weights."""
    f = np.arange(max(0, r * c - r + 1), min(n - 1, r * c + r - 1) + 1)
    return f, 1.0 - np.abs(f - r * c) / r


def _replay_restrict(x, cells, ratio, ndof, plan):
    """The restriction computed block by block as the kernel does: a
    tile's window of fine lines, then along x, y and z, each tap read from
    the block's window (an assertion fails if a tap lies outside it).
    Returns (coarse vectors, how often each coarse node was written)."""
    (nz, ny, nx), (cz, cy, cx) = _axes3(cells, ratio)
    B = x.shape[0]
    fine = x.reshape(B, nz, ny, nx, ndof)
    out = np.zeros((B, cz, cy, cx, ndof))
    hits = np.zeros((B, cz, cy, cx), dtype=np.int64)
    for s, (cz0, cz1), (cy0, cy1), (fz0, fz1), (fy0, fy1) in _restrict_tiles(B, cells, ratio,
                                                                             plan):
        stage = fine[s, fz0:fz1 + 1, fy0:fy1 + 1]
        tx = np.stack([np.tensordot(w, stage[:, :, f], axes=(0, 2))
                       for f, w in (_taps(xc, ratio, nx) for xc in range(cx))], axis=2)
        for yc in range(cy0, cy1):
            f, w = _taps(yc, ratio, ny)
            assert f[0] >= fy0 and f[-1] <= fy1
            txy = np.tensordot(w, tx[:, f - fy0], axes=(0, 1))  # (wz, cx, ndof)
            for zc in range(cz0, cz1):
                fzs, wz = _taps(zc, ratio, nz)
                assert fzs[0] >= fz0 and fzs[-1] <= fz1
                out[s, zc, yc] = np.tensordot(wz, txy[fzs - fz0], axes=(0, 0))
                hits[s, zc, yc] += 1
    return out.reshape(B, -1), hits


def _replay_prolong(x, cells, ratio, ndof, plan):
    """The prolongation computed block by block as the kernel does: each
    block's fine lines, along z and y from each line's coarse taps, then
    along x. Returns (fine vectors, how often each fine node was written)."""
    (nz, ny, nx), (cz, cy, cx) = _axes3(cells, ratio)
    B = x.shape[0]
    coarse = x.reshape(B, cz, cy, cx, ndof)
    out = np.zeros((B, nz, ny, nx, ndof))
    hits = np.zeros((B, nz, ny, nx), dtype=np.int64)
    nlines = nz * ny
    nb = -(-nlines // plan.lines)
    assert plan.prolong_blocks == B * nb
    r = ratio

    def taps(f):
        c, rem = divmod(f, r)
        return [(c, 1.0 - rem / r)] + ([(c + 1, 1.0 - (r - rem) / r)] if rem else [])

    for blk in range(plan.prolong_blocks):
        s, band = divmod(blk, nb)
        for L in range(band * plan.lines, min(band * plan.lines + plan.lines, nlines)):
            z, y = divmod(L, ny)
            t = sum(wy * sum(wz * coarse[s, zc, yc] for zc, wz in taps(z))
                    for yc, wy in taps(y))  # (cx, ndof)
            for xf in range(nx):
                out[s, z, y, xf] = sum(wx * t[xc] for xc, wx in taps(xf))
                hits[s, z, y, xf] += 1
    return out.reshape(B, -1), hits


@pytest.mark.parametrize("cells,ratio,ndof", SMALL + PLANNED[4:])
@pytest.mark.parametrize("tiles", [None, (1, 1, 1), (2, 2, 3)])
def test_replayed_kernels_compute_the_plain_transfers(cells, ratio, ndof, tiles):
    """float64, 3 samples, the plan's tiles and forced ones (tiles of one
    coarse row and one fine line; tiles that do not divide the grid)."""
    n_f, n_c = _sizes(cells, ratio, ndof)
    kw = {} if tiles is None else dict(zip(("tz", "ty", "lines"), tiles))
    if len(cells) == 2:
        kw.pop("tz", None)
    plan = launch_plan(3, cells, ratio, ndof, 8, **kw)
    prolong, restrict = make_grid_transfer_nd(cells, ratio, ndof)
    rng = np.random.default_rng(7)
    r_f = rng.normal(size=(3, n_f))
    u_c = rng.normal(size=(3, n_c))
    got_r, hits_r = _replay_restrict(r_f, cells, ratio, ndof, plan)
    got_p, hits_p = _replay_prolong(u_c, cells, ratio, ndof, plan)
    assert (hits_r == 1).all() and (hits_p == 1).all()
    want_r = restrict(torch.as_tensor(r_f)).numpy()
    want_p = prolong(torch.as_tensor(u_c)).numpy()
    np.testing.assert_allclose(got_r, want_r, rtol=0, atol=1e-13 * np.abs(want_r).max())
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=1e-13 * np.abs(want_p).max())


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("cells,ratio,ndof", PLANNED)
def test_launch_plan_covers_every_row_and_sample_once(cells, ratio, ndof, itemsize):
    """B = 256 (the cells' batch) and 300: each coarse (z, y) row of each
    sample in exactly one restriction block, each fine line in exactly one
    prolongation block, every block within a block's shared memory."""
    (nz, ny, _), (cz, cy, _) = _axes3(cells, ratio)
    for B in (256, 300):
        plan = launch_plan(B, cells, ratio, ndof, itemsize)
        rows = np.zeros((B, cz, cy), dtype=np.int64)
        for s, (cz0, cz1), (cy0, cy1), _, _ in _restrict_tiles(B, cells, ratio, plan):
            rows[s, cz0:cz1, cy0:cy1] += 1
        assert (rows == 1).all()
        nb = -(-(nz * ny) // plan.lines)
        lines = np.zeros((B, nz * ny), dtype=np.int64)
        for blk in range(plan.prolong_blocks):
            s, band = divmod(blk, nb)
            lines[s, band * plan.lines:(band + 1) * plan.lines] += 1
        assert (lines == 1).all()
        assert plan.restrict_smem <= SMEM_MAX and plan.prolong_smem <= SMEM_MAX


def test_launch_plan_on_the_cells_grid():
    """160x80 at ratio 4 in float32: restriction tiles of 6, 5 and 5 coarse
    rows within the budget (27 fine lines at most), 256 x 4 blocks."""
    plan = launch_plan(256, (20, 40), 4, 2, 4)
    assert plan.restrict_smem <= SMEM_BUDGET
    assert smem_bytes((20, 40), 4, 2, 4, ty=plan.ty + 1) > SMEM_BUDGET or plan.ty == 21
    assert plan.restrict_blocks == 256 * -(-21 // plan.ty)
    assert plan.prolong_blocks == 256 * -(-81 // plan.lines)


@pytest.mark.parametrize("cells,ndof,itemsize", [((2, 2000), 2, 8), ((1, 1, 3000), 3, 4)])
def test_a_line_too_long_for_one_block_raises(cells, ndof, itemsize):
    with pytest.raises(ValueError, match="too long"):
        launch_plan(4, cells, 4, ndof, itemsize)


def test_kernel_names_fall_in_no_benchmark_family():
    """The benchmark sorts device time by substrings of kernel names
    (portbench/harness/trace.py); the transfer kernels match none of them, so
    ``cublas_ms.*`` and ``elementwise_ms.*`` keep their meaning. The profile
    tool names them in a family of their own."""
    from portbench.harness.trace import FAMILIES, family

    with open(SOURCE) as f:
        names = set(re.findall(r"__global__ void __launch_bounds__\(\w+\)\s+(\w+)\(", f.read()))
    assert names == {"hat_restrict_kernel", "hat_prolong_kernel"}
    spec = importlib.util.spec_from_file_location(
        "profile_scaled_torch", os.path.join(ROOT, "tools", "profile_scaled_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    for name in names:
        # as the profiler shows it: demangled, with the instance's arguments
        shown = (f"void (anonymous namespace)::{name}<float, 2, 2>(float const*, float*, "
                 "(anonymous namespace)::Grid)")
        assert family(shown) == "other"
        assert not any(k in shown for _, keys in FAMILIES for k in keys)
        assert tool.family(shown) == "transfer kernel"


@pytest.mark.parametrize("cells,ratio,ndof", SMALL)
def test_transfers_are_adjoint_in_float64(cells, ratio, ndof):
    """<P u, r> = <u, R r> to 1e-12 of the product of the norms."""
    n_f, n_c = _sizes(cells, ratio, ndof)
    rng = np.random.default_rng(3)
    u = torch.as_tensor(rng.normal(size=(4, n_c)))
    r = torch.as_tensor(rng.normal(size=(4, n_f)))
    prolong, restrict = make_grid_transfer_nd(cells, ratio, ndof)
    lhs = (prolong(u) * r).sum(1)
    rhs = (u * restrict(r)).sum(1)
    assert torch.allclose(lhs, rhs, rtol=0, atol=1e-12 * float(u.norm() * r.norm()))

