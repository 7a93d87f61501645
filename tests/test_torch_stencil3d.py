"""The port's hex8-box stencil (tables, diagonal, packing, plain matvec, the
kernel wrapper on the CPU) against the JAX package.

On the CPU the wrapper runs its plain PyTorch version; the CUDA kernel itself
is held against that plain version on the card by chip_smoke.py. Inputs are
made with numpy from fixed seeds and handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from vbicm_tpu.config import SectionCard as JaxSectionCard
from vbicm_tpu.mesh.solid3d import beam_hex8_mesh as jax_beam_hex8_mesh
from vbicm_tpu.model import build_fem_model as jax_build_fem_model
from vbicm_tpu.ops.stencil3d import build_stencil_tables_3d as jax_build_stencil_tables_3d
from vbicm_tpu.ops.stencil3d import make_stencil_affine_matvec_3d as jax_make_affine_3d
from vbicm_tpu.ops.stencil3d import make_stencil_part_matvec_3d as jax_make_part_matvec_3d
from vbicm_tpu.ops.stencil3d_pallas import pack_w_interleaved_3d as jax_pack_w_interleaved_3d
from vbicm_tpu.ops.stencil3d_pallas import stencil_affine_matvec_pallas_3d
from vbicm_tpu_torch.config import SectionCard
from vbicm_tpu_torch.mesh import beam_hex8_mesh
from vbicm_tpu_torch.model import build_fem_model
from vbicm_tpu_torch.ops.assembly import element_affine_matvec
from vbicm_tpu_torch.ops.stencil3d import (
    build_stencil_tables_3d,
    make_stencil_affine_matvec_3d,
    make_stencil_part_matvec_3d,
)
from vbicm_tpu_torch.ops.stencil3d_kernel import (
    PITCH,
    pack_w_interleaved_3d,
    pack_w_nodes_3d,
    plan_tiling_3d,
    stencil3d_affine_matvec,
    stencil3d_affine_reference,
)
from vbicm_tpu_torch.utils import trace

GRIDS = [(4, 2, 2), (6, 4, 2)]


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS/OpenMP thread while this file runs: its arrays are small,
    and the test workers running in parallel share the cores."""
    with threadpool_limits(1):
        yield


@pytest.fixture(scope="module", params=GRIDS, ids=lambda g: "x".join(map(str, g)))
def grid(request):
    """(cells, JAX matrix-free model, port matrix-free model)."""
    cells = request.param
    return (cells,
            jax_build_fem_model(jax_beam_hex8_mesh(*cells), JaxSectionCard(stype=4), dense=False),
            build_fem_model(beam_hex8_mesh(*cells), SectionCard(stype=4), device="cpu",
                            dense=False))


def _inputs(B, ndof, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(1.0, 3.0, (B, 2)), rng.normal(size=(B, ndof))


def _jax_parts(jmodel, cells, u):
    """K_p u for p = 0, 1 through the JAX package's float64 part matvec."""
    jpm, _ = jax_make_part_matvec_3d(jmodel, *cells)
    ju = jnp.asarray(u)
    return [np.asarray(jax.vmap(lambda v, p=p: jpm(p, v))(ju)) for p in range(2)]


def test_tables_and_diagonal_bit_identical_to_jax(grid):
    cells, jmodel, model = grid
    W = build_stencil_tables_3d(model, *cells)
    assert W.shape == (2, cells[2] + 1, cells[1] + 1, cells[0] + 1, 3, 3, 3, 3, 3)
    assert np.array_equal(W, jax_build_stencil_tables_3d(jmodel, *cells))
    _, diag = make_stencil_part_matvec_3d(model, *cells)
    _, jdiag = jax_make_part_matvec_3d(jmodel, *cells)
    assert np.array_equal(diag.numpy(), np.asarray(jdiag))


def test_packing_equals_jax_packing_without_padding(grid):
    cells, jmodel, _ = grid
    W = jax_build_stencil_tables_3d(jmodel, *cells)
    NX, NY, NZ = (c + 1 for c in cells)
    ours = pack_w_interleaved_3d(W)
    assert ours.shape == (NZ * NY, 198, 3 * NX)
    theirs = jax_pack_w_interleaved_3d(W)
    theirs = theirs.reshape(NZ * NY, 200, theirs.shape[1])
    # each (plane, lane) holds one table value, no sum: the JAX float32
    # packing is the port's float64 packing rounded once
    assert np.array_equal(ours.astype(np.float32), theirs[:, :198, :3 * NX])
    assert not theirs[:, 198:].any() and not theirs[:, :, 3 * NX:].any()  # only padding dropped


def test_plain_part_matvec_matches_jax(grid):
    cells, jmodel, model = grid
    _, u = _inputs(5, model.ndof, seed=cells[0])
    want = _jax_parts(jmodel, cells, u)
    part_matvec, _ = make_stencil_part_matvec_3d(model, *cells)
    for p in range(2):
        q = part_matvec(p, torch.as_tensor(u)).numpy()
        # 1e-12 relative: the same float64 stencil, summation order aside
        assert np.abs(q - want[p]).max() <= 1e-12 * np.abs(want[p]).max()
        q32 = part_matvec(p, torch.as_tensor(u, dtype=torch.float32))
        assert q32.dtype == torch.float32
        # float32 sums of 27 block terms: 3e-6 of max|q|
        assert np.abs(q32.numpy() - want[p]).max() <= 3e-6 * np.abs(want[p]).max()


def test_plain_affine_matches_jax_f64_affine(grid):
    cells, jmodel, model = grid
    coeffs, u = _inputs(4, model.ndof, seed=cells[0] + 1)
    jaffine, _, _ = jax_make_affine_3d(jmodel, *cells, use_pallas=False)
    want = np.asarray(jax.vmap(jaffine)(jnp.asarray(coeffs), jnp.asarray(u)))
    affine, _ = make_stencil_affine_matvec_3d(model, *cells)
    q = affine(torch.as_tensor(coeffs), torch.as_tensor(u)).numpy()
    # 1e-12 relative: float64 on both sides
    assert np.abs(q - want).max() <= 1e-12 * np.abs(want).max()


def test_plain_affine_f32_matches_pallas_interpret():
    cells = GRIDS[0]
    jmodel = jax_build_fem_model(jax_beam_hex8_mesh(*cells), JaxSectionCard(stype=4), dense=False)
    NX, NY, NZ = (c + 1 for c in cells)
    coeffs, u = _inputs(4, jmodel.ndof, seed=3)
    W = jax_build_stencil_tables_3d(jmodel, *cells)
    want = np.asarray(stencil_affine_matvec_pallas_3d(
        jnp.asarray(jax_pack_w_interleaved_3d(W)), jnp.asarray(coeffs, jnp.float32),
        jnp.asarray(u, jnp.float32), NZ=NZ, NY=NY, NX=NX, interpret=True))
    q = stencil3d_affine_reference(torch.as_tensor(W, dtype=torch.float32),
                                   torch.as_tensor(coeffs, dtype=torch.float32),
                                   torch.as_tensor(u, dtype=torch.float32)).numpy()
    # 3e-6 x max|q|, as tests/test_stencil3d.py: float32 sums of 198 terms
    # taken in different orders
    np.testing.assert_allclose(q, want, atol=3e-6 * np.abs(want).max())


def test_stencil_equals_element_matvec(grid):
    cells, _, model = grid
    coeffs, u = _inputs(3, model.ndof, seed=cells[0] + 2)
    c, ut = torch.as_tensor(coeffs), torch.as_tensor(u)
    affine, _ = make_stencil_affine_matvec_3d(model, *cells)
    want = element_affine_matvec(torch.stack([model.ke_lam, model.ke_mu]), model.lm, c, ut,
                                 model.ndof)
    # two float64 forms of the assembled operator: 1e-12 relative
    assert float((affine(c, ut) - want).abs().max()) <= 1e-12 * float(want.abs().max())


def test_wrapper_on_cpu_runs_plain_and_counts_no_launch():
    model = build_fem_model(beam_hex8_mesh(2, 1, 1), SectionCard(stype=4), device="cpu")
    W = torch.as_tensor(build_stencil_tables_3d(model, 2, 1, 1))
    coeffs, u = (torch.as_tensor(a) for a in _inputs(3, model.ndof, seed=9))
    before = trace.counters().get("stencil3d_affine.launches", 0)
    q = stencil3d_affine_matvec(W, None, coeffs, u)
    assert torch.equal(q, stencil3d_affine_reference(W, coeffs, u))
    assert trace.counters().get("stencil3d_affine.launches", 0) == before


def test_wrapper_refuses_tensors_off_cpu_and_cuda():
    W = torch.empty((2, 2, 2, 3, 3, 3, 3, 3, 3))
    w, c, u = (torch.empty(s, device="meta") for s in ((4, 9, 3, 60), (3, 2), (3, 36)))
    before = trace.counters().get("stencil3d_affine.launches", 0)
    with pytest.raises(ValueError):
        stencil3d_affine_matvec(W, w, c, u)
    assert trace.counters().get("stencil3d_affine.launches", 0) == before


SMEM_BYTES = 232448  # shared memory one H100 block may use (227 KB)


def _max_threads(itemsize, samples):
    return 512 if itemsize == 4 and samples <= 8 else 256  # the kernel's launch bounds


def _h100_fit(NX3, itemsize, samples=8):
    """A model of what the library's vbicm_stencil3d_affine_fit_* reports on
    an H100 for rows of NX3 lanes: csrc/stencil3d_affine.cu's launch
    geometry (a thread a node and ``samples`` samples, a ring of 3 staged
    rows, each the row's node-major coefficients and the tile's u row with a
    halo node each side, in 16-byte copies), its launch bounds, 227 KB of
    shared memory a block, and the blocks an SM holds by its registers (as
    ptxas allocates them) and shared memory."""
    nxn, vec = NX3 // 3, 16 // itemsize

    def fit(g):
        threads = -(-g * nxn // 32) * 32
        stage = nxn * PITCH[itemsize] + g * samples * (NX3 + 6)
        smem = 3 * -(-stage // vec) * vec * itemsize
        if threads > _max_threads(itemsize, samples) or smem > SMEM_BYTES:
            return None
        regs = {(4, 4): 96, (4, 8): 128, (4, 16): 208, (8, 4): 128, (8, 8): 176}[itemsize, samples]
        per_sm = min(65536 // (regs * threads), 233472 // (smem + 1024), 32)
        return threads, smem, per_sm, samples, PITCH[itemsize]

    return fit


def _covered(B, NZ, NY, NX3, plan):
    """How often each (sample, grid row, node) is stored by a launch with
    ``plan``: the kernel's block and thread index arithmetic
    (csrc/stencil3d_affine.cu), replayed on the host."""
    nxn = NX3 // 3
    sb = plan.groups * plan.samples
    hits = np.zeros((B, NZ * NY, nxn), dtype=np.int64)
    for bx in range(-(-B // sb)):
        s0 = bx * sb
        ns = min(sb, B - s0)
        for row in range(NZ * NY):
            for tid in range(plan.threads):
                g, x = divmod(tid, nxn)
                if g >= plan.groups:
                    continue
                for s in range(plan.samples):
                    if g * plan.samples + s < ns:
                        hits[s0 + g * plan.samples + s, row, x] += 1
    return hits


@pytest.mark.parametrize("B,NZ,NY,NX3,itemsize,samples", [
    (256, 9, 9, 99, 4, 8), (256, 9, 9, 99, 8, 8), (300, 9, 9, 99, 4, 16), (5, 3, 3, 15, 8, 8),
    (1, 3, 5, 15, 4, 4), (64, 5, 7, 39, 4, 8)])
def test_launch_plan_covers_every_output_once(B, NZ, NY, NX3, itemsize, samples):
    """Ragged batches (1, 5, 300), several sample groups a block, and
    kernels built with 4, 8 and 16 samples a thread."""
    plan = plan_tiling_3d(B, NZ, NY, NX3, _h100_fit(NX3, itemsize, samples))
    assert plan.samples == samples
    assert np.array_equal(_covered(B, NZ, NY, NX3, plan), np.ones((B, NZ * NY, NX3 // 3)))


@pytest.mark.parametrize("B,NZ,NY,NX3,itemsize,samples", [
    (256, 17, 17, 195, 4, 8), (256, 17, 17, 195, 8, 8), (64, 17, 17, 195, 4, 16),
    (256, 17, 17, 195, 8, 4), (4, 3, 3, 336, 8, 8), (300, 9, 9, 690, 4, 8)])
def test_launch_plan_fits_shared_memory_and_threads(B, NZ, NY, NX3, itemsize, samples):
    # 64x16x16 and the longest rows whose ring of staged coefficients and u
    # fits: 112 nodes with 8 float64 samples a thread, 230 with 8 float32
    fit = _h100_fit(NX3, itemsize, samples)
    plan = plan_tiling_3d(B, NZ, NY, NX3, fit)
    assert (plan.threads, plan.smem_bytes) == fit(plan.groups)[:2]
    assert plan.smem_bytes <= SMEM_BYTES
    assert plan.threads % 32 == 0 and plan.threads <= _max_threads(itemsize, samples)
    assert plan.groups * (NX3 // 3) <= plan.threads
    assert plan.blocks == NZ * NY * -(-B // (plan.groups * plan.samples))


@pytest.mark.parametrize("B,NX3,itemsize,groups", [(256, 99, 4, 3), (256, 195, 4, 7),
                                                   (64, 195, 4, 3), (256, 195, 8, 3)])
def test_launch_plan_picks_the_groups_that_keep_most_warps_busy(B, NX3, itemsize, groups):
    # 32x8x8 (33 nodes a row): three groups, four blocks of 4 warps an SM;
    # 64x16x16 (65 nodes): seven groups of 8 float32 samples at B = 256 (15
    # warps), three at B = 64 (seven would leave 6 of 14 groups empty); in
    # float64 three (256 threads at most a block)
    fit = _h100_fit(NX3, itemsize)
    plan = plan_tiling_3d(B, 9, 9, NX3, fit)
    assert plan.groups == groups
    ngroups = -(-B // 8)

    def busy(g):
        threads, _, per_sm = fit(g)[:3]
        return per_sm * threads // 32 * ngroups / (-(-ngroups // g) * g)

    fits = [g for g in range(1, ngroups + 1) if fit(g) is not None]
    assert busy(groups) == max(busy(g) for g in fits)


@pytest.mark.parametrize("NX3,itemsize,samples", [(771, 8, 8), (1539, 4, 8), (3999, 4, 4)])
def test_a_row_too_long_for_one_block_raises(NX3, itemsize, samples):
    with pytest.raises(ValueError, match="too long"):
        plan_tiling_3d(4, 3, 3, NX3, _h100_fit(NX3, itemsize, samples))


def test_the_kernel_reads_only_taps_whose_planes_can_be_nonzero():
    """A lane 3x + a reads taps d = 3 dx + b - a + 2 (dx, b in 0..2) of each
    row (csrc/stencil3d_affine.cu): the others are zero in every packed
    plane."""
    model = build_fem_model(beam_hex8_mesh(4, 2, 2), SectionCard(stype=4), device="cpu")
    planes = pack_w_interleaved_3d(build_stencil_tables_3d(model, 4, 2, 2))
    planes = planes.reshape(9, 18, 11, 5, 3)  # (row, (p, dz, dy), d, x, a)
    for a in range(3):
        read = [3 * dx + b - a + 2 for dx in range(3) for b in range(3)]
        assert not np.delete(planes[..., a], read, axis=2).any()
        assert planes[:, :, read, :, a].any()


@pytest.mark.parametrize("itemsize", [4, 8])
def test_node_packing_is_the_jax_planes_rearranged(grid, itemsize):
    """The kernel's node-major coefficients hold plane (p*9 + v)*11 + 3 dx +
    b - a + 2 at lane 3x + a as entry [row, v, x, dx*20 + (p*3 + a)*3 + b],
    zero-padded to the pitch."""
    cells, jmodel, _ = grid
    W = jax_build_stencil_tables_3d(jmodel, *cells)
    planes = pack_w_interleaved_3d(W)
    nodes = pack_w_nodes_3d(W, itemsize)
    NX = cells[0] + 1
    assert nodes.shape == (planes.shape[0], 9, NX, PITCH[itemsize])
    seen = np.zeros(PITCH[itemsize], dtype=bool)
    for p in range(2):
        for v in range(9):
            for dx in range(3):
                for a in range(3):
                    for b in range(3):
                        k = dx * 20 + (p * 3 + a) * 3 + b
                        seen[k] = True
                        assert np.array_equal(nodes[:, v, :, k],
                                              planes[:, (p * 9 + v) * 11 + 3 * dx + b - a + 2,
                                                     a::3])
    assert seen.sum() == 54 and not nodes[..., ~seen].any()


def _kernel_order_affine(nodes, coeffs, u, NZ, NY, NX):
    """The kernel's sums on the node-major coefficients, replayed in float64
    numpy: staged rows by (dz, dy) inside the grid, then the neighbour node
    dx, then its dof b, each part its own sum; c0 a0 + c1 a1 at the end."""
    B = u.shape[0]
    up = np.zeros((B, NZ + 2, NY + 2, NX + 2, 3))
    up[:, 1:-1, 1:-1, 1:-1] = u.reshape(B, NZ, NY, NX, 3)
    c = nodes[..., :60].reshape(NZ, NY, 9, NX, 3, 20)[..., :18].reshape(NZ, NY, 9, NX, 3, 2, 3, 3)
    acc = np.zeros((2, B, NZ, NY, NX, 3))
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                for b in range(3):
                    ub = up[:, dz:dz + NZ, dy:dy + NY, dx:dx + NX, b]  # (B, z, y, x)
                    for p in range(2):
                        w = c[:, :, dz * 3 + dy, :, dx, p, :, b]  # (z, y, x, a)
                        acc[p] += np.einsum("zyxa,szyx->szyxa", w, ub)
    c0, c1 = (coeffs[:, p, None, None, None, None] for p in range(2))
    return (c0 * acc[0] + c1 * acc[1]).reshape(B, -1)


def test_node_layout_arithmetic_matches_plain_affine(grid):
    cells, _, model = grid
    NX, NY, NZ = (n + 1 for n in cells)
    coeffs, u = _inputs(3, model.ndof, seed=cells[0] + 5)
    W = build_stencil_tables_3d(model, *cells)
    want = stencil3d_affine_reference(torch.as_tensor(W), torch.as_tensor(coeffs),
                                      torch.as_tensor(u)).numpy()
    q = _kernel_order_affine(pack_w_nodes_3d(W, 8), coeffs, u, NZ, NY, NX)
    # float64 on both sides, sums in other orders: 1e-12 relative
    assert np.abs(q - want).max() <= 1e-12 * np.abs(want).max()
