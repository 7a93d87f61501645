"""The port's spectral apply and spectral solver against the JAX package.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA kernel
itself is held against that plain version on the card by chip_smoke.py.
Inputs are made with numpy from fixed seeds and handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from vbicm_tpu.ops.solve import make_spectral_affine_solver as jax_make_spectral_solver
from vbicm_tpu.ops.spectral_pallas import spectral_apply_batched as jax_spectral_apply
from vbicm_tpu.ops.spectral_pallas import spectral_apply_reference as jax_spectral_reference
from vbicm_tpu_torch.mesh import cooks_membrane_mesh
from vbicm_tpu_torch.model import build_fem_model
from vbicm_tpu_torch.ops.solve import make_spectral_affine_solver
from vbicm_tpu_torch.ops.spectral_kernel import (
    sample_tile,
    spectral_apply_batched,
    spectral_apply_reference,
)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS/OpenMP thread while this file runs: its matrices are small,
    and the test workers running in parallel share the cores."""
    with threadpool_limits(1):
        yield


def _problem(B, n, seed):
    """Orthonormal eigenbasis, positive eigenvalues and coefficients (the
    inputs of tests/test_pallas.py)."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    g = np.abs(rng.normal(size=n)) + 0.1
    coeffs = np.abs(rng.normal(size=(B, 2))) + 1.0
    b = rng.normal(size=(B, n))
    return Q, g, coeffs, b


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("B,n", [(20, 200), (128, 256), (5, 440), (130, 130)])
def test_plain_f32_matches_jax_kernel_and_reference(B, n):
    arrays = _problem(B, n, seed=B + n)
    ours = spectral_apply_reference(*(torch.as_tensor(x, dtype=torch.float32) for x in arrays))
    jx = [jnp.asarray(x, jnp.float32) for x in arrays]
    pallas = np.asarray(jax_spectral_apply(*jx, interpret=True))
    xla = np.asarray(jax_spectral_reference(*jx))
    # atol 3e-5, as tests/test_pallas.py: float32 sums over n terms taken in
    # different orders
    np.testing.assert_allclose(ours.numpy(), pallas, atol=3e-5)
    np.testing.assert_allclose(ours.numpy(), xla, atol=3e-5)


def test_plain_f64_matches_numpy():
    Q, g, c, b = _problem(7, 440, seed=1)
    x, a = spectral_apply_reference(*(torch.as_tensor(v) for v in (Q, g, c, b)), return_coords=True)
    d = c[:, :1] * g[None, :] + c[:, 1:2]
    a_np = (b @ Q) / d
    # 1e-12 relative: float64 products of 440 terms, summation order aside
    assert _rel(a, a_np) < 1e-12
    assert _rel(x, a_np @ Q.T) < 1e-12


def test_wrapper_on_cpu_runs_plain_and_counts_no_launch():
    arrays = [torch.as_tensor(x) for x in _problem(5, 64, seed=2)]
    before = spectral_apply_batched.launches
    x, a = spectral_apply_batched(*arrays, return_coords=True)
    xr, ar = spectral_apply_reference(*arrays, return_coords=True)
    assert torch.equal(x, xr) and torch.equal(a, ar)
    assert spectral_apply_batched.launches == before == 0


def test_wrapper_refuses_tensors_off_cpu_and_cuda():
    V, g, c, b = (torch.empty(s, device="meta") for s in ((8, 8), (8,), (3, 2), (3, 8)))
    with pytest.raises(ValueError):
        spectral_apply_batched(V, g, c, b)
    assert spectral_apply_batched.launches == 0


def test_sample_tile_fits_shared_memory():
    assert sample_tile(440, 8) == 8  # Cook's 20x10 in float64: 56 KB
    assert sample_tile(6000, 8) == 2
    assert sample_tile(14528, 8) == 1
    with pytest.raises(ValueError):
        sample_tile(14529, 8)


@pytest.fixture(scope="module")
def cooks_parts(cooks_model):
    """Cook's 20x10 free-free stiffness parts, from the JAX model and the port's."""
    jax_parts = jnp.stack([cooks_model.k_lam_ff, cooks_model.k_mu_ff])
    model = build_fem_model(cooks_membrane_mesh(20, 10), device="cpu")
    return jax_parts, torch.stack([model.k_lam_ff, model.k_mu_ff])


@pytest.mark.parametrize("mixed", [False, True], ids=["f64", "f32_apply_1_refinement"])
def test_solver_forward_and_vjp_match_jax(cooks_parts, mixed):
    jax_parts, parts = cooks_parts
    n = parts.shape[-1]
    rng = np.random.default_rng(4)
    coeffs = np.stack([rng.uniform(8.0, 16.0, 6), rng.uniform(6.0, 9.0, 6)], axis=1)
    f = rng.normal(size=(6, n))
    xbar = rng.normal(size=(6, n))

    jsolve = jax_make_spectral_solver(jax_parts, apply_dtype=jnp.float32 if mixed else None,
                                      refine_iters=int(mixed))
    x_j, vjp = jax.vjp(jax.vmap(jsolve), jnp.asarray(coeffs), jnp.asarray(f))
    cbar_j, fbar_j = vjp(jnp.asarray(xbar))

    solve = make_spectral_affine_solver(parts, apply_dtype=torch.float32 if mixed else None,
                                        refine_iters=int(mixed))
    c_t = torch.tensor(coeffs, requires_grad=True)
    f_t = torch.tensor(f, requires_grad=True)
    x = solve(c_t, f_t)
    cbar, fbar = torch.autograd.grad(x, (c_t, f_t), torch.as_tensor(xbar))

    # 1e-10 relative in float64; with the float32 apply both packages land
    # within ~1e-11 of the exact solve after one refinement, so 1e-9
    tol = 1e-9 if mixed else 1e-10
    assert _rel(x.detach(), x_j) < tol
    assert _rel(fbar, fbar_j) < tol
    # the coefficient cotangent is a contraction of the eigen-coordinates,
    # which both packages keep in the apply dtype: float32-grade when mixed
    assert _rel(cbar, cbar_j) < (1e-5 if mixed else 1e-10)


def test_solver_gradcheck_small_pencil():
    rng = np.random.default_rng(5)
    M = rng.normal(size=(12, 12))
    A = M @ M.T  # symmetric PSD
    Bm = np.eye(12) + 0.1 * (M + M.T) @ (M + M.T).T / 12.0  # SPD
    solve = make_spectral_affine_solver(torch.as_tensor(np.stack([A, Bm])))
    coeffs = torch.tensor(rng.uniform(0.5, 2.0, (3, 2)), requires_grad=True)
    f = torch.tensor(rng.normal(size=(3, 12)), requires_grad=True)
    assert torch.autograd.gradcheck(solve, (coeffs, f))
