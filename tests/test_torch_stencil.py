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
    sample_tile,
    stencil_affine_matvec,
    stencil_affine_reference,
)

GRIDS = [(8, 4), (32, 16)]


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
    before = stencil_affine_matvec.launches
    q = stencil_affine_matvec(W, None, coeffs, u)
    assert torch.equal(q, stencil_affine_reference(W, coeffs, u))
    assert stencil_affine_matvec.launches == before == 0


def test_wrapper_refuses_tensors_off_cpu_and_cuda():
    w, c, u = (torch.empty(s, device="meta") for s in ((5, 42, 18), (3, 2), (3, 90)))
    with pytest.raises(ValueError):
        stencil_affine_matvec(None, w, c, u)
    assert stencil_affine_matvec.launches == 0


def test_sample_tile_fits_shared_memory():
    assert sample_tile(322, 256, 8) == 8  # 160x80 in float64: 63 KB
    assert sample_tile(322, 5, 4) == 5
    assert sample_tile(2000, 256, 8) == 4
    with pytest.raises(ValueError):
        sample_tile(10000, 1, 8)


@pytest.mark.parametrize("rows,itemsize,tile", [(1, 8, 8), (3, 4, 8), (8, 8, 8), (10, 8, 7),
                                                (40, 8, 2)])
def test_sample_tile_of_the_rows_per_block_option(rows, itemsize, tile):
    # 160x80: 8 rows a block in float64 stage 8 x 10 x 328 values, 210 KB
    # of the 227 KB; at 10 rows the tile shrinks
    assert sample_tile(322, 256, itemsize, rows) == tile
    assert tile * ((rows + 2) * 328 + 2) * itemsize <= 232448


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
    q = op.affine(c, ut, rows_per_block=rpp)
    assert torch.equal(q, op.affine(c, ut))  # the option computes the one-row function
    # 3e-6 x max|q|, as the one-row case above: float32 sums in other orders
    np.testing.assert_allclose(q.numpy(), want, atol=3e-6 * np.abs(want).max())
    assert stencil_affine_matvec.launches == stencil_affine_matvec.rows_launches == 0


@pytest.mark.parametrize("rows", [0, -1, 2.0])
def test_rows_per_block_must_be_a_positive_int(rows):
    model = build_fem_model(cooks_membrane_mesh(8, 4), device="cpu")
    W = torch.as_tensor(build_stencil_tables(model, 8, 4))
    coeffs, u = (torch.as_tensor(a) for a in _inputs(2, model.ndof, seed=1))
    with pytest.raises(ValueError):
        stencil_affine_matvec(W, None, coeffs, u, rows_per_block=rows)
