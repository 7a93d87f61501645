"""The port's structured-grid stencil (tables, packing, plain matvec, the
kernel wrapper on the CPU) and its matrix-free model against the JAX package.

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

from vbicm_tpu.mesh import cooks_membrane_mesh as jax_cooks_mesh
from vbicm_tpu.model import build_fem_model as jax_build_fem_model
from vbicm_tpu.ops.stencil import build_stencil_tables as jax_build_stencil_tables
from vbicm_tpu.ops.stencil import make_stencil_part_matvec as jax_make_stencil_part_matvec
from vbicm_tpu.ops.stencil_pallas import pack_w_interleaved as jax_pack_w_interleaved
from vbicm_tpu.ops.stencil_pallas import (
    stencil_affine_matvec_pallas,
    stencil_affine_matvec_pallas_mr,
)
from vbicm_tpu_torch import _build
from vbicm_tpu_torch.mesh import cooks_membrane_mesh
from vbicm_tpu_torch.model import build_fem_model
from vbicm_tpu_torch.ops.assembly import element_affine_matvec, element_matvec
from vbicm_tpu_torch.ops.stencil import (
    StencilOperator,
    build_stencil_tables,
    make_stencil_affine_matvec,
    make_stencil_part_matvec,
)
from vbicm_tpu_torch.ops.stencil_kernel import (
    pack_w_interleaved,
    plan_tiling,
    stencil_affine_matvec,
    stencil_affine_reference,
)
from vbicm_tpu_torch.utils import trace

GRIDS = [(8, 4), (32, 16)]
SMEM_BYTES = 232448  # shared memory one H100 block may use (227 KB)
MAX_THREADS = {4: 512, 8: 256}  # the kernel's launch bounds, by itemsize


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS/OpenMP thread while this file runs: its arrays are small,
    and the test workers running in parallel share the cores."""
    with threadpool_limits(1):
        yield


@pytest.fixture(scope="module", params=GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def grid(request):
    """(nx, ny, JAX matrix-free model, port matrix-free model)."""
    nx, ny = request.param
    return (nx, ny, jax_build_fem_model(jax_cooks_mesh(nx, ny), dense=False),
            build_fem_model(cooks_membrane_mesh(nx, ny), device="cpu", dense=False))


def _inputs(B, ndof, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(1.0, 3.0, (B, 2)), rng.normal(size=(B, ndof))


def test_tables_and_diagonal_bit_identical_to_jax(grid):
    nx, ny, jmodel, model = grid
    W = build_stencil_tables(model, nx, ny)
    assert np.array_equal(W, jax_build_stencil_tables(jmodel, nx, ny))
    _, diag = make_stencil_part_matvec(model, nx, ny)
    _, jdiag = jax_make_stencil_part_matvec(jmodel, nx, ny)
    assert np.array_equal(diag.numpy(), np.asarray(jdiag))


def test_packing_equals_jax_packing_without_padding(grid):
    nx, ny, jmodel, _ = grid
    W = jax_build_stencil_tables(jmodel, nx, ny)
    ours = pack_w_interleaved(W)
    NY, NX2 = ny + 1, 2 * (nx + 1)
    assert ours.shape == (NY, 42, NX2)
    theirs = jax_pack_w_interleaved(W)
    theirs = theirs.reshape(NY, 48, theirs.shape[1])
    # the JAX packing accumulates a plane's (dx, b) terms in float32, the
    # port in float64: equal to one float32 rounding of the sum
    np.testing.assert_allclose(ours.astype(np.float32), theirs[:, :42, :NX2], rtol=2e-7, atol=0)
    assert not theirs[:, 42:].any() and not theirs[:, :, NX2:].any()  # only padding dropped


def test_plain_stencil_matches_jax_f64_part_matvec(grid):
    nx, ny, jmodel, model = grid
    coeffs, u = _inputs(5, model.ndof, seed=nx)
    jpm, _ = jax_make_stencil_part_matvec(jmodel, nx, ny)
    ju = jnp.asarray(u)
    want = sum(coeffs[:, p:p + 1] * np.asarray(jax.vmap(lambda v: jpm(p, v))(ju))
               for p in range(2))
    affine, part_matvec, _ = make_stencil_affine_matvec(model, nx, ny)
    q = affine(torch.as_tensor(coeffs), torch.as_tensor(u)).numpy()
    # 1e-12 relative: the same float64 stencil, summation order aside
    assert np.abs(q - want).max() <= 1e-12 * np.abs(want).max()
    q1 = part_matvec(1, torch.as_tensor(u)).numpy()
    w1 = np.asarray(jax.vmap(lambda v: jpm(1, v))(ju))
    assert np.abs(q1 - w1).max() <= 1e-12 * np.abs(w1).max()


def test_plain_stencil_f32_matches_pallas_interpret(grid):
    nx, ny, jmodel, model = grid
    coeffs, u = _inputs(4, model.ndof, seed=nx + 1)
    W = jax_build_stencil_tables(jmodel, nx, ny)
    want = np.asarray(stencil_affine_matvec_pallas(
        jnp.asarray(jax_pack_w_interleaved(W)), jnp.asarray(coeffs, jnp.float32),
        jnp.asarray(u, jnp.float32), NY=ny + 1, NX=nx + 1, interpret=True))
    q = stencil_affine_reference(torch.as_tensor(W, dtype=torch.float32),
                                 torch.as_tensor(coeffs, dtype=torch.float32),
                                 torch.as_tensor(u, dtype=torch.float32)).numpy()
    # 3e-6 x max|q|, as tests/test_stencil.py: float32 sums of 42 terms
    # taken in different orders
    np.testing.assert_allclose(q, want, atol=3e-6 * np.abs(want).max())


def test_stencil_equals_element_matvec(grid):
    nx, ny, _, model = grid
    coeffs, u = _inputs(3, model.ndof, seed=nx + 2)
    c, ut = torch.as_tensor(coeffs), torch.as_tensor(u)
    affine, part_matvec, _ = make_stencil_affine_matvec(model, nx, ny)
    want = element_affine_matvec(torch.stack([model.ke_lam, model.ke_mu]), model.lm, c, ut,
                                 model.ndof)
    # two float64 forms of the assembled operator: 1e-12 relative
    assert float((affine(c, ut) - want).abs().max()) <= 1e-12 * float(want.abs().max())
    want1 = element_matvec(model.ke_mu, model.lm, ut, model.ndof)
    assert float((part_matvec(1, ut) - want1).abs().max()) <= 1e-12 * float(want1.abs().max())


def test_matrix_free_model_matches_jax(grid):
    nx, ny, jmodel, model = grid
    assert not model.dense and model.k_lam_ff is None and model.k_mu_ff is None
    assert (model.ndof, model.nfree, model.nele) == (jmodel.ndof, jmodel.nfree, jmodel.nele)
    for name in ("coords", "lm", "free_dof", "free_mask", "f_ext", "B", "dvol", "ke_lam",
                 "ke_mu"):
        np.testing.assert_array_equal(getattr(model, name).numpy(),
                                      np.asarray(getattr(jmodel, name)), err_msg=name)


@pytest.mark.parametrize("nx,ny,dense", [(32, 16, True), (64, 32, False)])
def test_dense_is_chosen_by_free_dof_count(nx, ny, dense):
    # 2*nx*(ny+1) free dofs: 1088 at 32x16, 4224 at 64x32 (the rule is <= 4096)
    model = build_fem_model(cooks_membrane_mesh(nx, ny), device="cpu")
    assert model.dense is dense and (model.k_lam_ff is not None) is dense


def test_wrapper_on_cpu_runs_plain_and_counts_no_launch():
    model = build_fem_model(cooks_membrane_mesh(8, 4), device="cpu")
    W = torch.as_tensor(build_stencil_tables(model, 8, 4))
    coeffs, u = (torch.as_tensor(a) for a in _inputs(3, model.ndof, seed=9))
    before = trace.counters().get("stencil_affine.launches", 0)
    q = stencil_affine_matvec(W, None, coeffs, u)
    assert torch.equal(q, stencil_affine_reference(W, coeffs, u))
    assert trace.counters().get("stencil_affine.launches", 0) == before


def test_wrapper_refuses_tensors_off_cpu_and_cuda():
    w, c, u = (torch.empty(s, device="meta") for s in ((5, 42, 18), (3, 2), (3, 90)))
    before = trace.counters().get("stencil_affine.launches", 0)
    with pytest.raises(ValueError):
        stencil_affine_matvec(None, w, c, u)
    assert trace.counters().get("stencil_affine.launches", 0) == before


def _h100_fit(NX2, itemsize):
    """A model of what the library's vbicm_stencil_affine_fit_* reports on
    an H100 for rows of NX2 lanes: csrc/stencil_affine.cu's launch geometry
    (a thread a node, a ring of 8 staged samples of rt + 2 rows with a halo
    node each side and (c0, c1)), its launch bounds, 227 KB of shared memory
    a block, and the blocks an SM holds by its registers (128 a thread in
    float32, 224 in float64, as ptxas allocates them) and shared memory."""
    nxn = NX2 // 2

    def fit(rt):
        threads = -(-rt * nxn // 32) * 32
        smem = 8 * ((rt + 2) * (nxn + 2) + 1) * 2 * itemsize
        if threads > MAX_THREADS[itemsize] or smem > SMEM_BYTES:
            return None
        regs = {4: 128, 8: 224}[itemsize] * threads
        return threads, smem, min(65536 // regs, 233472 // (smem + 1024), 32)

    return fit


def _plan(B, NY, NX2, itemsize, rows_per_block=None, sms=132):
    return plan_tiling(B, NY, NX2, _h100_fit(NX2, itemsize), sms, rows_per_block)


def _covered(B, NY, NX2, plan):
    """How often each (sample, grid row, node) is stored by a launch with
    ``plan``: the kernel's block, run, sub-band and thread index arithmetic
    (csrc/stencil_affine.cu), replayed on the host."""
    nxn = NX2 // 2
    hits = np.zeros((B, NY, nxn), dtype=np.int64)
    total = -(-NY // plan.rows) * B
    for block in range(plan.blocks):
        wk, wend = block * plan.run, min(total, (block + 1) * plan.run)
        while wk < wend:
            band, s0 = divmod(wk, B)
            ns = min(B - s0, wend - wk)
            wk += ns
            yb0 = band * plan.rows
            yend = min(yb0 + plan.rows, NY)
            for yb in range(yb0, yend, plan.rows_at_once):
                rows = min(plan.rows_at_once, yend - yb)
                for tid in range(plan.threads):
                    rt, x = divmod(tid, nxn)
                    if rt < rows:
                        hits[s0:s0 + ns, yb + rt, x] += 1
    return hits


@pytest.mark.parametrize("B,NY,NX2,itemsize,rows,sms", [
    (256, 81, 322, 4, None, 132), (256, 81, 322, 8, None, 132), (300, 81, 322, 4, None, 50),
    (5, 81, 322, 4, 2, 132), (1, 5, 18, 8, 4, 3), (16, 17, 66, 4, 8, 7), (8, 81, 322, 8, 8, 132)])
def test_launch_plan_covers_every_output_once(B, NY, NX2, itemsize, rows, sms):
    """Ragged batches (1, 5, 300), bands that do not divide NY (81 rows in
    bands of 2 or 8, 17 in 8, 5 in 4), runs that cross bands (cards of 3,
    7 and 50 SMs), sub-bands (8 rows a band with fewer computed at once)."""
    plan = _plan(B, NY, NX2, itemsize, rows, sms)
    assert np.array_equal(_covered(B, NY, NX2, plan), np.ones((B, NY, NX2 // 2)))


@pytest.mark.parametrize("B,NY,NX2,itemsize", [(256, 81, 322, 4), (300, 81, 322, 4),
                                               (256, 81, 322, 8), (8, 257, 512, 8),
                                               (16, 9, 1024, 4)])
def test_launch_plan_fits_shared_memory_and_threads(B, NY, NX2, itemsize):
    # the largest rows: 256 nodes (float64), 512 (float32)
    fit = _h100_fit(NX2, itemsize)
    plan = plan_tiling(B, NY, NX2, fit, 132)
    assert (plan.threads, plan.smem_bytes) == fit(plan.rows_at_once)[:2]
    assert plan.smem_bytes <= SMEM_BYTES
    assert plan.threads % 32 == 0 and plan.threads <= MAX_THREADS[itemsize]
    assert plan.rows_at_once * (NX2 // 2) <= plan.threads
    pairs = -(-NY // plan.rows) * B
    assert plan.blocks == -(-pairs // plan.run) and (plan.blocks - 1) * plan.run < pairs


@pytest.mark.parametrize("rows", [1, 2, 3, 4, 8, 100])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_launch_plan_honours_a_forced_rows_per_block(rows, itemsize):
    # 160x80: float32 computes up to 3 rows of 161 nodes at once, float64
    # one; a band of more is taken in sub-bands; a band is at most the grid
    plan = _plan(256, 81, 322, itemsize, rows)
    assert plan.rows == min(rows, 81)
    assert plan.rows_at_once == min(rows, 81, {4: 3, 8: 1}[itemsize])


@pytest.mark.parametrize("B,itemsize,waves", [(256, 4, 1), (8, 4, 1), (256, 8, 2), (16, 8, 1),
                                              (8, 8, 1)])
def test_launch_plan_takes_two_waves_only_for_long_runs_of_lone_small_blocks(B, itemsize, waves):
    # 160x80: one block an SM either way, 16 warps in float32, 6 in float64;
    # float64 runs 158 pairs a block in one wave at B = 256, 10 at B = 16
    plan = _plan(B, 81, 322, itemsize)
    pairs = -(-81 // plan.rows) * B
    assert plan.run == -(-pairs // (waves * 132))


@pytest.mark.parametrize("err,want", [(0, (3, 4, 5)), (1, None), (700, RuntimeError)])
def test_kernel_fit_reads_the_entry_points_answer(err, want):
    """The plans read a fit entry point's ints on success, no fit on
    cudaErrorInvalidValue, and raise on any other CUDA error."""
    def entry(nx2, rt, out):
        out[0], out[1], out[2] = 3, 4, 5
        return err

    if want is RuntimeError:
        with pytest.raises(RuntimeError, match="700"):
            _build.kernel_fit(entry, 3, 322, 1)
    else:
        assert _build.kernel_fit(entry, 3, 322, 1) == want


@pytest.mark.parametrize("NX2,itemsize", [(1026, 4), (514, 8), (2000, 8), (10000, 4)])
def test_a_row_too_long_for_one_block_raises(NX2, itemsize):
    with pytest.raises(ValueError, match="too long"):
        _plan(4, 9, NX2, itemsize)


def test_the_kernel_skips_only_taps_whose_planes_are_zero():
    """The kernel reads an even lane's taps d = 1..6 and an odd lane's
    d = 0..5 (csrc/stencil_affine.cu): the others are zero in every packed
    plane, so skipping them leaves the one-row kernel's sums bit for bit."""
    model = build_fem_model(cooks_membrane_mesh(8, 4), device="cpu")
    planes = pack_w_interleaved(build_stencil_tables(model, 8, 4)).reshape(5, 6, 7, 18)
    assert not planes[:, :, 0, 0::2].any() and not planes[:, :, 6, 1::2].any()
    assert planes[:, :, 1:, 0::2].any() and planes[:, :, :6, 1::2].any()


@pytest.mark.parametrize("rpp", [3, 4])
def test_rows_per_block_on_cpu_matches_pallas_multirow_interpret(rpp):
    """NY + 1 = 5 grid rows: neither 3 nor 4 divides them (the JAX test's
    case, tests/test_stencil.py)."""
    nx, ny = 8, 4
    jmodel = jax_build_fem_model(jax_cooks_mesh(nx, ny), dense=False)
    model = build_fem_model(cooks_membrane_mesh(nx, ny), device="cpu", dense=False)
    W = jax_build_stencil_tables(jmodel, nx, ny)
    coeffs, u = _inputs(4, model.ndof, seed=rpp)
    want = np.asarray(stencil_affine_matvec_pallas_mr(
        jnp.asarray(jax_pack_w_interleaved(W)), jnp.asarray(coeffs, jnp.float32),
        jnp.asarray(u, jnp.float32), NY=ny + 1, NX=nx + 1, rows_per_program=rpp,
        interpret=True))
    op = StencilOperator(model, nx, ny, W=W)
    c, ut = torch.as_tensor(coeffs, dtype=torch.float32), torch.as_tensor(u, dtype=torch.float32)
    before = trace.counters()
    q = op.affine(c, ut, rows_per_block=rpp)
    assert torch.equal(q, op.affine(c, ut))  # the option computes the one-row function
    # 3e-6 x max|q|, as the one-row case above: float32 sums in other orders
    np.testing.assert_allclose(q.numpy(), want, atol=3e-6 * np.abs(want).max())
    after = trace.counters()
    assert all(after.get(k, 0) == before.get(k, 0)
               for k in ("stencil_affine.launches", "stencil_affine_rows.launches"))


@pytest.mark.parametrize("rows", [0, -1, 2.0])
def test_rows_per_block_must_be_a_positive_int(rows):
    model = build_fem_model(cooks_membrane_mesh(8, 4), device="cpu")
    W = torch.as_tensor(build_stencil_tables(model, 8, 4))
    coeffs, u = (torch.as_tensor(a) for a in _inputs(2, model.ndof, seed=1))
    with pytest.raises(ValueError):
        stencil_affine_matvec(W, None, coeffs, u, rows_per_block=rows)
