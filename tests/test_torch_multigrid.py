"""The port's two-level preconditioner pieces against the JAX package: the
bilinear prolongation tables, the grid transfers, the additive
preconditioner and the coarse spectral solve (CPU; the coarse solve's
wrapper runs its plain version here)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from vbicm_tpu.mesh import cooks_membrane_mesh as jax_cooks_mesh
from vbicm_tpu.model import build_fem_model as jax_build_fem_model
from vbicm_tpu.ops.multigrid import cooks_prolongation as jax_cooks_prolongation
from vbicm_tpu.ops.multigrid import make_grid_transfer as jax_make_grid_transfer
from vbicm_tpu.ops.multigrid import make_grid_transfer_conv as jax_make_grid_transfer_conv
from vbicm_tpu.ops.multigrid import (
    make_two_level_preconditioner as jax_make_two_level_preconditioner,
)
from vbicm_tpu.solver import make_coarse_spectral_apply as jax_make_coarse_spectral_apply
from vbicm_tpu_torch.mesh import cooks_membrane_mesh
from vbicm_tpu_torch.model import build_fem_model
from vbicm_tpu_torch.ops.multigrid import (
    cooks_prolongation,
    make_grid_transfer_nd,
    make_two_level_preconditioner,
)
from vbicm_tpu_torch.solver import make_coarse_spectral_apply

TRANSFERS = [(5, 3, 2), (4, 2, 4)]


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS/OpenMP thread while this file runs: its arrays are small,
    and the test workers running in parallel share the cores."""
    with threadpool_limits(1):
        yield


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("nxc,nyc,r", TRANSFERS)
def test_prolongation_tables_identical(nxc, nyc, r):
    idx, w = cooks_prolongation(nxc, nyc, r)
    jidx, jw = jax_cooks_prolongation(nxc, nyc, r)
    assert np.array_equal(idx, jidx) and np.array_equal(w, jw)


@pytest.mark.parametrize("nxc,nyc,r", TRANSFERS)
def test_transfers_match_jax_conv_and_reshape_forms(nxc, nyc, r):
    nc = 2 * (nxc + 1) * (nyc + 1)
    nf = 2 * (nxc * r + 1) * (nyc * r + 1)
    rng = np.random.default_rng(nxc * 10 + r)
    uc, rf = rng.normal(size=(3, nc)), rng.normal(size=(3, nf))
    prolong, restrict = make_grid_transfer_nd((nyc, nxc), r, 2)
    p = prolong(torch.as_tensor(uc)).numpy()
    rs = restrict(torch.as_tensor(rf)).numpy()
    for jprolong, jrestrict in (jax_make_grid_transfer_conv(nxc, nyc, r),
                                jax_make_grid_transfer(nxc, nyc, r)):
        # 1e-13: the same bilinear weights, float64, summation order aside
        assert _rel(p, jax.vmap(jprolong)(jnp.asarray(uc))) < 1e-13
        assert _rel(rs, jax.vmap(jrestrict)(jnp.asarray(rf))) < 1e-13


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-14), (torch.float32, 1e-6)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("nxc,nyc,r", TRANSFERS)
def test_transfers_are_adjoint(nxc, nyc, r, dtype, tol):
    nc = 2 * (nxc + 1) * (nyc + 1)
    nf = 2 * (nxc * r + 1) * (nyc * r + 1)
    rng = np.random.default_rng(r)
    uc = torch.as_tensor(rng.normal(size=(2, nc)), dtype=dtype)
    vf = torch.as_tensor(rng.normal(size=(2, nf)), dtype=dtype)
    prolong, restrict = make_grid_transfer_nd((nyc, nxc), r, 2)
    lhs = (prolong(uc) * vf).sum(-1)
    rhs = (uc * restrict(vf)).sum(-1)
    # <P u, v> = <u, P^T v> up to the rounding of the two sums (tol x scale)
    scale = float((prolong(uc).abs() * vf.abs()).sum())
    assert float((lhs - rhs).abs().max()) <= tol * scale


@pytest.fixture(scope="module")
def two_level_16x8():
    """Fine 16x8 and coarse 4x2 models (ratio 4) from both packages."""
    fine = (jax_build_fem_model(jax_cooks_mesh(16, 8), dense=False),
            build_fem_model(cooks_membrane_mesh(16, 8), device="cpu", dense=False))
    coarse = (jax_build_fem_model(jax_cooks_mesh(4, 2), dense=True),
              build_fem_model(cooks_membrane_mesh(4, 2), device="cpu", dense=True))
    return fine, coarse


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 1e-5)],
                         ids=["f64", "f32"])
def test_coarse_spectral_apply_matches_jax(two_level_16x8, dtype, tol):
    _, (jcoarse, coarse) = two_level_16x8
    rng = np.random.default_rng(11)
    coeffs = np.stack([rng.uniform(8.0, 16.0, 4), rng.uniform(6.0, 9.0, 4)], axis=1)
    r = (rng.normal(size=(4, coarse.ndof)) * coarse.free_mask.numpy()).astype(dtype)
    want = np.asarray(jax.vmap(jax_make_coarse_spectral_apply(jcoarse))(
        jnp.asarray(coeffs), jnp.asarray(r)))
    got = make_coarse_spectral_apply(coarse)(torch.as_tensor(coeffs), torch.as_tensor(r))
    assert got.dtype == torch.from_numpy(r).dtype
    # float64: 1e-12 relative; float32: the apply's float32 products
    assert _rel(got.numpy(), want) < tol
    assert not got.numpy()[:, coarse.supp_dof.numpy()].any()


def test_preconditioner_matches_jax(two_level_16x8):
    (jfine, fine), (jcoarse, coarse) = two_level_16x8
    rng = np.random.default_rng(12)
    coeffs = np.stack([rng.uniform(8.0, 16.0, 3), rng.uniform(6.0, 9.0, 3)], axis=1)
    dinv = rng.uniform(0.01, 0.1, (3, fine.ndof))
    r = rng.normal(size=(3, fine.ndof))
    idx, w = jax_cooks_prolongation(4, 2, 4)
    jprec, _, _ = jax_make_two_level_preconditioner(
        idx, w, jax_make_coarse_spectral_apply(jcoarse), jfine.free_mask, omega=0.6,
        grid_transfer=jax_make_grid_transfer_conv(4, 2, 4))
    want = np.asarray(jax.vmap(jprec)(jnp.asarray(coeffs), jnp.asarray(dinv), jnp.asarray(r)))
    prec = make_two_level_preconditioner(make_coarse_spectral_apply(coarse), fine.free_mask,
                                         make_grid_transfer_nd((2, 4), 4, 2), omega=0.6)
    got = prec(*(torch.as_tensor(a) for a in (coeffs, dinv, r))).numpy()
    # 1e-12 relative: float64 on both sides
    assert _rel(got, want) < 1e-12
