"""The hat transfers' kernel wrapper (``ops/hat_transfer_kernel.py``) on the
CPU: the plain version is today's matrix-product form bit for bit, the
wrapper refuses what the CUDA kernels do not take, and the kernels' launch
plan and index arithmetic (``csrc/hat_transfer.cu``), replayed on the host,
cover every output once and compute the plain version's sums. Then the
two-level preconditioner around them (``ops/multigrid.py``): its plain path
is the composition as it was before the fused pair, bit for bit, also with
the grid transfers handed as a plain ``(prolong, restrict)`` tuple; the
pair's wrappers refuse what its kernels do not take, CPU tensors too. The kernels themselves run on the card
in chip_smoke.py."""
import importlib.util
import os
import re

import numpy as np
import pytest
import scipy.linalg
import torch

from vbicm_tpu_torch.config import SectionCard
from vbicm_tpu_torch.mesh import beam_hex8_mesh, cooks_membrane_mesh
from vbicm_tpu_torch.model import build_fem_model
from vbicm_tpu_torch.ops.element import lame_from_Ev
from vbicm_tpu_torch.ops.hat_transfer_kernel import (
    SMEM_BUDGET,
    SMEM_MAX,
    free_slots,
    grid_nodes,
    hat_prolong_prec,
    hat_restrict_prec,
    hat_transfer,
    launch_plan,
    smem_bytes,
)
from vbicm_tpu_torch.ops.multigrid import (
    cooks_prolongation,
    hat_matrix,
    make_gather_transfer,
    make_grid_transfer_nd,
    make_two_level_preconditioner,
)
from vbicm_tpu_torch.ops.spectral_kernel import spectral_apply_batched
from vbicm_tpu_torch.prob.randomfield import make_mean_field_preconditioner
from vbicm_tpu_torch.solver import make_coarse_spectral_apply
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
    assert names == {"hat_restrict_kernel", "hat_prolong_kernel", "hat_restrict_prec_kernel",
                     "hat_prolong_prec_kernel"}
    spec = importlib.util.spec_from_file_location(
        "profile_scaled_torch", os.path.join(ROOT, "tools", "profile_scaled_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    for name in names:
        # as the profiler shows it: demangled, with the instance's arguments
        prec = ", (anonymous namespace)::Prec<float>" if "_prec_" in name else ""
        shown = (f"void (anonymous namespace)::{name}<float, 2, 2>(float const*, float*, "
                 f"(anonymous namespace)::Grid{prec})")
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



# ---------------------------------------------------------------------------
# the two-level preconditioner around the transfers
# ---------------------------------------------------------------------------


def _frozen_composition(coarse_model, fine_free_mask, transfer, omega):
    """The additive preconditioner as ``ops/multigrid.py`` and
    ``solver.make_coarse_spectral_apply`` composed it before the fused pair:
    r mask, the smoothing, the restriction, the free-dof gather, the coarse
    spectral solve, the embed, the prolongation, its mask and the sum."""
    g, V = scipy.linalg.eigh(coarse_model.k_lam_ff.numpy(), coarse_model.k_mu_ff.numpy())
    free = coarse_model.free_dof
    inv = torch.argsort(torch.cat([free, coarse_model.supp_dof]))
    nsupp = int(coarse_model.supp_dof.shape[0])
    prolong, restrict = transfer

    def coarse_apply(coeffs, r_full):
        V_ = torch.as_tensor(V, dtype=r_full.dtype).contiguous()
        g_ = torch.as_tensor(g, dtype=r_full.dtype)
        c = coeffs.to(r_full.dtype).contiguous()
        x = spectral_apply_batched(V_, g_, c, r_full[:, free].contiguous())
        return torch.cat([x, x.new_zeros((*x.shape[:-1], nsupp))], dim=-1)[..., inv]

    def prec(coeffs, diag_inv, r):
        mask = fine_free_mask.to(r.dtype)
        r = r * mask
        z_smooth = omega * diag_inv * r
        return z_smooth + prolong(coarse_apply(coeffs, restrict(r))) * mask

    return prec


def _two_level_case(name):
    """(fine, coarse, transfer, coeffs0): the 16x8 Cook's grid over 4x2 with
    the hat transfers (2-D stencil path; as a plain tuple for
    "stencil2d_tuple") or the gather transfers (element path), the 4x2x2
    box over 2x1x1 (3-D), and the 2-D mean field (coeffs0 the mean field's
    constant coefficients, else None)."""
    if name == "box3d":
        sec = SectionCard(stype=4)
        fine = build_fem_model(beam_hex8_mesh(4, 2, 2), sec, device="cpu", dense=False)
        coarse = build_fem_model(beam_hex8_mesh(2, 1, 1), sec, device="cpu", dense=True)
        return fine, coarse, make_grid_transfer_nd((1, 1, 2), 2, 3), None
    fine = build_fem_model(cooks_membrane_mesh(16, 8), device="cpu", dense=False)
    coarse = build_fem_model(cooks_membrane_mesh(4, 2), device="cpu", dense=True)
    if name == "gather":
        return fine, coarse, make_gather_transfer(*cooks_prolongation(4, 2, 4)), None
    if name == "stencil2d_tuple":
        return fine, coarse, tuple(make_grid_transfer_nd((2, 4), 4, 2)), None
    # the mean field's coefficients: E0 = 20, nu = 0.3 (prob/randomfield.py)
    coeffs0 = torch.tensor(lame_from_Ev(20.0, 0.3), dtype=torch.float64) \
        if name == "mean_field" else None
    return fine, coarse, make_grid_transfer_nd((2, 4), 4, 2), coeffs0


def _prec_inputs(fine, dtype, seed, B=3):
    """coeffs (B, 2) in float64, as the solvers hand them; diag_inv and r
    (B, n) in the CG's dtype, diag_inv 1 at the supports as the solver's."""
    rng = np.random.default_rng(seed)
    coeffs = torch.as_tensor(np.stack([rng.uniform(8.0, 16.0, B), rng.uniform(6.0, 9.0, B)], 1))
    mask = fine.free_mask.to(dtype)
    dinv = torch.as_tensor(rng.uniform(0.01, 0.1, (B, fine.ndof)), dtype=dtype)
    dinv = torch.where(mask > 0, dinv, torch.ones_like(dinv))
    r = torch.as_tensor(rng.normal(size=(B, fine.ndof)), dtype=dtype)
    return coeffs, dinv, r


CASES = ["stencil2d", "stencil2d_tuple", "box3d", "gather", "mean_field"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", CASES)
def test_preconditioner_plain_path_is_the_frozen_composition(case, dtype):
    """On CPU tensors every preconditioner takes its plain path, counted in
    ``prec.calls.plain``, bitwise the composition as it was."""
    fine, coarse, transfer, coeffs0 = _two_level_case(case)
    want_prec = _frozen_composition(coarse, fine.free_mask, transfer, 0.6)
    coeffs, dinv, r = _prec_inputs(fine, dtype, seed=len(case))
    if coeffs0 is None:
        prec = make_two_level_preconditioner(make_coarse_spectral_apply(coarse), fine.free_mask,
                                             transfer, omega=0.6)
    else:
        prec = make_mean_field_preconditioner(coarse, 4, 2, 4, fine.free_mask, omega=0.6)
        coeffs = coeffs0.to(dtype).expand(r.shape[0], 2)
    before = trace.counters()
    got = prec(coeffs, dinv, r)
    after = trace.counters()
    assert got.dtype == dtype
    assert torch.equal(got, want_prec(coeffs, dinv, r))
    assert after.get("prec.calls.plain", 0) - before.get("prec.calls.plain", 0) == 1
    assert after.get("prec.calls.fused", 0) == before.get("prec.calls.fused", 0)


@pytest.mark.parametrize("case", ["stencil2d", "box3d"])
def test_free_slot_table_follows_the_coarse_models_free_dofs(case):
    _, coarse, _, _ = _two_level_case(case)
    slots = free_slots(make_coarse_spectral_apply(coarse).free_dof, coarse.ndof)
    assert slots.dtype == torch.int32 and slots.shape == (coarse.ndof,)
    assert torch.equal(slots[coarse.free_dof].long(), torch.arange(coarse.nfree))
    assert bool((slots[coarse.supp_dof] == -1).all()) and coarse.supp_dof.numel() > 0


def test_free_slot_table_of_any_order():
    """The table follows the order it is given, not the dofs' order."""
    free = torch.tensor([5, 0, 3, 2])
    assert free_slots(free, 7).tolist() == [1, -1, 3, 2, -1, 0, -1]


# a prolongation from the 8x4 grid's coarse grid at ratio 2 ((2, 4) cells,
# 90 fine and 30 coarse values), 20 of the coarse dofs free
_NF, _NC, _NFREE = 90, 30, 20


def _prec_operands(**change):
    """The pair's operands on the meta device (no data; the wrappers'
    checks run, and a meta tensor is on no CUDA device), one changed."""
    ops = {"r": _meta((3, _NF)), "mask": _meta(_NF), "diag_inv": _meta((3, _NF)),
           "slots": torch.empty(_NC, dtype=torch.int32, device="meta"),
           "z_free": _meta((3, _NFREE)), "nfree": _NFREE}
    ops.update(change)
    return ops


def _call_restrict(ops):
    return hat_restrict_prec(ops["r"], ops["mask"], ops["slots"], ops["nfree"], (2, 4), 2, 2)


def _call_prolong(ops):
    return hat_prolong_prec(ops["z_free"], ops["slots"], ops["r"], ops["diag_inv"], ops["mask"],
                            0.6, (2, 4), 2, 2)


_PREC_REFUSALS = [
    (_call_restrict, {}, ValueError, "CUDA device"),
    (_call_restrict, {"mask": torch.empty(_NF)}, ValueError, "CUDA device"),
    (_call_restrict, {"mask": _meta(_NF, torch.float64)}, TypeError, "float32"),
    (_call_restrict, {"mask": _meta(_NF - 2)}, ValueError, "expected"),
    (_call_restrict, {"mask": _meta(2 * _NF)[::2]}, ValueError, "contiguous"),
    (_call_restrict, {"mask": _meta(_NF + 1)[1:]}, ValueError, "aligned"),
    (_call_restrict, {"r": _meta((3, _NF - 2))}, ValueError, "expected"),
    (_call_restrict, {"slots": torch.empty(_NC, dtype=torch.int64, device="meta")}, TypeError,
     "int32"),
    (_call_restrict, {"slots": torch.empty(_NC + 2, dtype=torch.int32, device="meta")},
     ValueError, "expected"),
    (_call_restrict, {"slots": torch.empty(2 * _NC, dtype=torch.int32, device="meta")[::2]},
     ValueError, "contiguous"),
    (_call_restrict, {"nfree": _NC + 1}, ValueError, "nfree"),
    (_call_restrict, {"r": torch.empty((3, _NF)), "mask": torch.empty(_NF),
                      "slots": torch.empty(_NC, dtype=torch.int32)}, ValueError, "CUDA device"),
    (_call_prolong, {}, ValueError, "CUDA device"),
    (_call_prolong, {"z_free": torch.empty((3, _NFREE)), "r": torch.empty((3, _NF)),
                     "diag_inv": torch.empty((3, _NF)), "mask": torch.empty(_NF),
                     "slots": torch.empty(_NC, dtype=torch.int32)}, ValueError, "CUDA device"),
    (_call_prolong, {"diag_inv": _meta((3, _NF), torch.float64)}, TypeError, "float32"),
    (_call_prolong, {"diag_inv": _meta((3, _NF - 2))}, ValueError, "expected"),
    (_call_prolong, {"diag_inv": _meta((1, _NF))}, ValueError, "expected"),
    (_call_prolong, {"diag_inv": _meta((3, 2 * _NF))[:, ::2]}, ValueError, "contiguous"),
    (_call_prolong, {"diag_inv": _meta(3 * _NF + 1)[1:].view(3, _NF)}, ValueError, "aligned"),
    (_call_prolong, {"diag_inv": torch.empty((3, _NF))}, ValueError, "CUDA device"),
    (_call_prolong, {"mask": _meta(_NF, torch.float16)}, TypeError, "float32"),
    (_call_prolong, {"mask": _meta((1, _NF))}, ValueError, "expected"),
    (_call_prolong, {"z_free": _meta(_NFREE)}, ValueError, "expected"),
    (_call_prolong, {"z_free": _meta((3, _NFREE), torch.float64)}, TypeError, "float32"),
    (_call_prolong, {"z_free": _meta((3, 2 * _NFREE))[:, ::2]}, ValueError, "contiguous"),
    (_call_prolong, {"z_free": _meta((3, _NC + 1))}, ValueError, "nfree"),
    (_call_prolong, {"slots": torch.empty(_NC, dtype=torch.float32, device="meta")}, TypeError,
     "int32"),
    (_call_prolong, {"slots": torch.empty(_NC - 1, dtype=torch.int32, device="meta")},
     ValueError, "expected"),
]


@pytest.mark.parametrize("call,change,error,match", _PREC_REFUSALS,
                         ids=[f"{c.__name__[6:]}-{'-'.join(ch) or 'device'}-{m.split()[0]}-{i}"
                              for i, (c, ch, _, m) in enumerate(_PREC_REFUSALS)])
def test_prec_pair_refuses_what_its_kernels_do_not_take(call, change, error, match):
    before = trace.counters()
    with pytest.raises(error, match=match):
        call(_prec_operands(**change))
    after = trace.counters()
    for name in ("hat_transfer_prec.launches", "hat_transfer.launches"):
        assert after.get(name, 0) == before.get(name, 0)
