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
    pack_w_interleaved_3d,
    staged_bytes,
    stencil3d_affine_matvec,
    stencil3d_affine_reference,
)

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
    q = stencil3d_affine_matvec(W, None, coeffs, u)
    assert torch.equal(q, stencil3d_affine_reference(W, coeffs, u))
    assert stencil3d_affine_matvec.launches == 0


def test_wrapper_refuses_tensors_off_cpu_and_cuda():
    W = torch.empty((2, 2, 2, 3, 3, 3, 3, 3, 3))
    w, c, u = (torch.empty(s, device="meta") for s in ((4, 198, 9), (3, 2), (3, 36)))
    with pytest.raises(ValueError):
        stencil3d_affine_matvec(W, w, c, u)
    assert stencil3d_affine_matvec.launches == 0


def test_sample_tile_fits_shared_memory():
    # a block stages 4 samples x 9 rows of 3NX + 10 values
    assert staged_bytes(195, 8) == 4 * 9 * 205 * 8  # 64x16x16 in float64: 59 KB
    assert staged_bytes(195, 4) == 4 * 9 * 205 * 4
    assert staged_bytes(795, 8) == 231840  # the longest float64 row that fits
    with pytest.raises(ValueError):
        staged_bytes(798, 8)
    with pytest.raises(ValueError):
        staged_bytes(4000, 4)
