"""The port's banded tensor-core stencil (table packing, windows and
bfloat16 splits, plain version, the wrapper on the CPU) against the JAX
package's ``ops/stencil_mxu.py``.

On the CPU the wrapper runs its plain PyTorch version; the CUDA kernel is
held against that plain version on the card by chip_smoke.py. 12x6 has one
128-lane tile a row (2NX = 26); 64x4 has two (2NX = 130), so the tile seam
is crossed. Inputs are made with numpy from fixed seeds.
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
from vbicm_tpu.ops.stencil_mxu import KDIM as JAX_KDIM
from vbicm_tpu.ops.stencil_mxu import LPAD as JAX_LPAD
from vbicm_tpu.ops.stencil_mxu import WIN as JAX_WIN
from vbicm_tpu.ops.stencil_mxu import pack_w_bands as jax_pack_w_bands
from vbicm_tpu.ops.stencil_mxu import stencil_affine_matvec_mxu as jax_stencil_affine_matvec_mxu
from vbicm_tpu_torch.ops.stencil_mxu import (
    KDIM,
    LPAD,
    MODES,
    WIN,
    band_windows,
    n_tiles,
    pack_w_bands,
    split_bf16,
    stencil_affine_matvec_mxu,
    stencil_affine_mxu_reference,
)

GRIDS = [(12, 6), (64, 4)]


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS/OpenMP thread while this file runs: its arrays are small,
    and the test workers running in parallel share the cores."""
    with threadpool_limits(1):
        yield


@pytest.fixture(scope="module", params=GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def grid(request):
    """(nx, ny, JAX matrix-free model, its float64 stencil tables W)."""
    nx, ny = request.param
    model = jax_build_fem_model(jax_cooks_mesh(nx, ny), dense=False)
    return nx, ny, model, jax_build_stencil_tables(model, nx, ny)


def _inputs(B, ndof, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(5.0, 15.0, (B, 2)).astype(np.float32),
            rng.standard_normal((B, ndof)).astype(np.float32))


def _bits(x):
    """bfloat16 tensor or array -> uint16 bits."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _exact(model, W, nx, ny, coeffs, u):
    """c0 K_lam u + c1 K_mu u in float64 through JAX's part matvec."""
    pm, _ = jax_make_stencil_part_matvec(model, nx, ny, W=W)
    ju = jnp.asarray(u, jnp.float64)
    return sum(coeffs[:, p:p + 1].astype(np.float64) * np.asarray(jax.vmap(lambda v: pm(p, v))(ju))
               for p in range(2))


def test_constants_are_jax_constants():
    assert (LPAD, WIN, KDIM) == (JAX_LPAD, JAX_WIN, JAX_KDIM) == (8, 136, 416)
    assert [n_tiles(nx + 1) for nx, _ in GRIDS] == [1, 2]


def test_pack_w_bands_bit_identical_to_jax(grid):
    nx, ny, _, W = grid
    f32 = pack_w_bands(W, "f32")
    assert f32.dtype == torch.float32 and f32.shape == ((ny + 1) * n_tiles(nx + 1) * KDIM, 256)
    np.testing.assert_array_equal(f32.numpy(), np.asarray(jax_pack_w_bands(W, "f32")))
    hi, lo = pack_w_bands(W, "bf16x3")
    jhi, jlo = jax_pack_w_bands(W, "bf16x3")
    assert hi.dtype == lo.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(hi), _bits(jhi))
    np.testing.assert_array_equal(_bits(lo), _bits(jlo))
    assert lo.any()  # the low half carries bits: the table is not bfloat16-exact


def test_windows_and_splits_bit_identical_to_jax(grid):
    """The port's (B, KDIM) operands and their bfloat16 splits are the JAX
    kernel's: its padding and window slices (``stencil_affine_matvec_mxu``
    and ``_row_kernel_bf16x3``) in jnp, then ``astype``."""
    nx, ny, model, _ = grid
    NY, NX = ny + 1, nx + 1
    NX2, T = 2 * NX, n_tiles(NX)
    _, u = _inputs(3, model.ndof, seed=nx)
    XL = -(-(JAX_LPAD + T * 128) // 128) * 128
    g = jnp.asarray(u).reshape(3, NY, NX2)
    upad = jnp.pad(g, ((0, 0), (1, 1), (JAX_LPAD, XL - NX2 - JAX_LPAD)))
    zpad = jnp.zeros((3, 8), jnp.float32)
    want = np.stack([np.asarray(jnp.concatenate(
        [upad[:, y + dy, JAX_LPAD - 3 + t * 128:JAX_LPAD - 3 + t * 128 + JAX_WIN]
         for dy in range(3)] + [zpad], axis=1)) for y in range(NY) for t in range(T)])
    uw = band_windows(torch.as_tensor(u), NY, NX)
    assert uw.shape == (NY * T, 3, KDIM)
    np.testing.assert_array_equal(uw.numpy(), want)
    uh, ul = split_bf16(uw)
    jw = jnp.asarray(want)
    juh = jw.astype(jnp.bfloat16)
    jul = (jw - juh.astype(jnp.float32)).astype(jnp.bfloat16)
    np.testing.assert_array_equal(_bits(uh), _bits(juh))
    np.testing.assert_array_equal(_bits(ul), _bits(jul))


@pytest.mark.parametrize("mode", MODES)
def test_plain_banded_matches_jax_interpret_and_the_exact_operator(grid, mode):
    nx, ny, model, W = grid
    NY, NX = ny + 1, nx + 1
    coeffs, u = _inputs(4, model.ndof, seed=nx + 1)
    jm = jax_pack_w_bands(W, mode)
    want = np.asarray(jax_stencil_affine_matvec_mxu(jm, jnp.asarray(coeffs), jnp.asarray(u),
                                                    NY=NY, NX=NX, interpret=True, mode=mode))
    q = stencil_affine_mxu_reference(pack_w_bands(W, mode), torch.as_tensor(coeffs),
                                     torch.as_tensor(u), NY, NX, mode).numpy()
    exact = _exact(model, W, nx, ny, coeffs, u)
    scale = np.abs(exact).max()
    # the same products summed in float32 in another order: 1e-6 of max|q|
    # (1.5e-7 measured)
    assert np.abs(q - want).max() <= 1e-6 * scale
    # tests/test_pallas.py's bounds against the exact operator
    assert np.abs(q - exact).max() <= {"f32": 5e-6, "bf16x3": 5e-5}[mode] * scale


def test_wrapper_on_cpu_runs_plain_and_counts_no_launch():
    nx, ny = 12, 6
    W = jax_build_stencil_tables(jax_build_fem_model(jax_cooks_mesh(nx, ny), dense=False), nx, ny)
    coeffs, u = (torch.as_tensor(a) for a in _inputs(2, 2 * (nx + 1) * (ny + 1), seed=5))
    before = stencil_affine_matvec_mxu.launches
    for mode in MODES:
        mb = pack_w_bands(W, mode)
        q = stencil_affine_matvec_mxu(mb, coeffs, u, ny + 1, nx + 1, mode)
        assert torch.equal(q, stencil_affine_mxu_reference(mb, coeffs, u, ny + 1, nx + 1, mode))
    assert stencil_affine_matvec_mxu.launches == before == 0


def test_wrapper_and_packing_refuse_bad_input():
    rows = 5 * KDIM
    m = torch.empty((rows, 256), device="meta")
    c, u = torch.empty((3, 2), device="meta"), torch.empty((3, 5 * 18), device="meta")
    with pytest.raises(ValueError):
        stencil_affine_matvec_mxu(m, c, u, 5, 9, "f32")
    with pytest.raises(ValueError):
        stencil_affine_matvec_mxu(m, c, u, 5, 9, "bf16")
    with pytest.raises(ValueError):
        pack_w_bands(np.zeros((3, 2, 2, 3, 3, 2, 2)), "f32")
    with pytest.raises(ValueError):
        pack_w_bands(np.zeros((2, 2, 2, 3, 3, 2, 2)), "f16")
    assert stencil_affine_matvec_mxu.launches == 0
