"""The port's spectral apply and spectral solver against the JAX package.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA kernel
itself is held against that plain version on the card by chip_smoke.py.
Here its launch plan is checked at every shape chip_smoke.py runs, and its
float32 arithmetic (3xTF32) is emulated. Inputs are made with numpy from
fixed seeds and handed to both packages.
"""
import importlib.util
import os

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
    SMEM_BYTES,
    SMS,
    TILES,
    launch_plan,
    spectral_apply_batched,
    spectral_apply_reference,
    split_for,
    tile_smem_bytes,
)
from vbicm_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CHIP = _chip_smoke()


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
    before = trace.counters().get("spectral_apply.launches", 0)
    x, a = spectral_apply_batched(*arrays, return_coords=True)
    xr, ar = spectral_apply_reference(*arrays, return_coords=True)
    assert torch.equal(x, xr) and torch.equal(a, ar)
    assert trace.counters().get("spectral_apply.launches", 0) == before


def test_wrapper_refuses_tensors_off_cpu_and_cuda():
    V, g, c, b = (torch.empty(s, device="meta") for s in ((8, 8), (8,), (3, 2), (3, 8)))
    before = trace.counters().get("spectral_apply.launches", 0)
    with pytest.raises(ValueError):
        spectral_apply_batched(V, g, c, b)
    assert trace.counters().get("spectral_apply.launches", 0) == before


@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
@pytest.mark.parametrize("B,n", CHIP.SHAPES)
def test_launch_plan_at_chip_smoke_shapes(B, n, itemsize):
    plan = launch_plan(B, n, itemsize)
    assert (plan.bm, plan.bn) in TILES
    tiles = -(-B // plan.bm) * -(-n // plan.bn)
    assert plan.split == split_for(tiles) and 1 <= plan.split <= 4
    assert plan.blocks == tiles * plan.split >= 1
    assert plan.smem_bytes == tile_smem_bytes(plan.bm, plan.bn, itemsize) <= SMEM_BYTES
    assert plan.bm <= -(-B // 16) * 16  # no tile taller than the batch's 16-row multiple
    # 16-byte copies only where a row is a whole number of 16-byte pieces
    # (f32 n = 130 is 520 bytes: element copies)
    assert plan.vec == ((n * itemsize) % 16 == 0)


@pytest.mark.parametrize("B,n,split", [(256, 1680, 1), (256, 1200, 3)])
def test_launch_plan_fills_the_card_on_the_coarse_solves(B, n, split):
    # float32: 64 x 64 tiles of 8 warps (108 at n = 1680; at n = 1200 76,
    # split 3 ways into 228 blocks), the fastest in tools/spectral_tiles.py;
    # float64: at least two blocks an SM
    plan = launch_plan(B, n, 4)
    assert (plan.bm, plan.bn, plan.split) == (64, 64, split) and plan.blocks >= 100
    assert launch_plan(B, n, 8).blocks >= 2 * SMS


@pytest.mark.parametrize("tiles,split", [
    (108, 1),   # (256, 1680): splitting cannot shorten the busiest SM's share
    (76, 3),    # (256, 1200): 228 blocks, at most 2 thirds a tile an SM
    (152, 4),   # (512, 1200)
    (53, 2),    # (8 and 16, 1680) on 16-row tiles
    (224, 1),   # float64 (256, 440): 1.75 of 2 tiles an SM is too little gain
    (1728, 1),  # (4096, 1680)
])
def test_split_for_the_busiest_sm(tiles, split):
    assert split_for(tiles) == split


@pytest.mark.parametrize("B", [5, 8, 16])
def test_launch_plan_takes_16_row_tiles_for_small_batches(B):
    # the 160x80 paths' spot checks run B = 8 and 16 at n = 1680
    assert launch_plan(B, 1680, 4).bm == 16


def test_launch_plan_prefers_large_tiles_when_the_grid_is_full():
    plan = launch_plan(4096, 1680, 4)
    assert (plan.bm, plan.bn) == TILES[0] and plan.blocks >= SMS
    assert all(tile_smem_bytes(bm, bn, s) <= SMEM_BYTES for bm, bn in TILES for s in (4, 8))
    with pytest.raises(ValueError):
        launch_plan(0, 440, 4)
    with pytest.raises(ValueError):
        launch_plan(16, 440, 2)


def _tf32(x):
    """float32 -> TF32 (10 mantissa bits), rounded to nearest with ties away
    from zero, as cvt.rna.tf32.f32 and the kernels' to_tf32
    (csrc/tf32x3.cuh)."""
    return ((x.view(torch.int32) + 0x1000) & -8192).view(torch.float32)


def _gemm_3xtf32(A, Bm):
    """The kernel's float32 product: both operands split into TF32 big and
    small parts, As Bb + Ab Bs + Ab Bb accumulated in float32 one MMA depth
    (8) at a time."""
    Ab, Bb = _tf32(A), _tf32(Bm)
    As, Bs = _tf32(A - Ab), _tf32(Bm - Bb)
    acc = torch.zeros((A.shape[0], Bm.shape[1]), dtype=torch.float32)
    for k0 in range(0, A.shape[1], 8):
        k = slice(k0, k0 + 8)
        acc = acc + As[:, k] @ Bb[k]
        acc = acc + Ab[:, k] @ Bs[k]
        acc = acc + Ab[:, k] @ Bb[k]
    return acc


def test_tf32_rounding_is_to_nearest_ties_away():
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, 1 + 1.5 * ulp, -(1 + ulp / 2), 1 + ulp / 2 - 2.0 ** -23],
                     dtype=torch.float32)
    assert _tf32(x).tolist() == [1 + ulp, 1 + 2 * ulp, -(1 + ulp), 1.0]


def test_3xtf32_apply_keeps_float32_accuracy(cooks_parts):
    """The kernel's float32 arithmetic on a Cook's 20x10 pencil at (16, 440),
    against the exact (float64) apply within chip_smoke.py's float32 REL_TOL
    of 2e-5. Measured: 5.8e-7 for x and 4.2e-7 for a (a 35x margin), the
    plain float32 apply's 5.2e-7 / 3.4e-7; one TF32 pass is 4.7e-4 / 3.2e-4,
    outside the tolerance."""
    solver = make_spectral_affine_solver(cooks_parts[1])
    V, g = solver.V, solver.g
    rng = np.random.default_rng(6)
    c = torch.as_tensor(np.stack([rng.uniform(8.0, 16.0, 16), rng.uniform(6.0, 9.0, 16)], 1))
    b = torch.as_tensor(rng.normal(size=(16, V.shape[0])))
    x64, a64 = spectral_apply_reference(V, g, c, b, return_coords=True)
    V32, g32, c32, b32 = (t.float() for t in (V, g, c, b))
    d = c32[:, :1] * g32[None, :] + c32[:, 1:2]
    a = _gemm_3xtf32(b32, V32) / d
    x = _gemm_3xtf32(a, V32.T.contiguous())
    tol = CHIP.REL_TOL[torch.float32]
    assert tol == 2e-5
    assert _rel(x, x64) < tol / 20 and _rel(a, a64) < tol / 20
    a1 = (_tf32(b32) @ _tf32(V32)) / d
    x1 = _tf32(a1) @ _tf32(V32.T.contiguous())
    assert _rel(x1, x64) > tol  # why one TF32 pass is ruled out


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


def _small_pencil(seed, n=12):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n))
    A = M @ M.T  # symmetric PSD
    Bm = np.eye(n) + 0.1 * (M + M.T) @ (M + M.T).T / n  # SPD
    return rng, make_spectral_affine_solver(torch.as_tensor(np.stack([A, Bm])))


def test_solver_gradcheck_small_pencil():
    rng, solve = _small_pencil(5)
    coeffs = torch.tensor(rng.uniform(0.5, 2.0, (3, 2)), requires_grad=True)
    f = torch.tensor(rng.normal(size=(3, 12)), requires_grad=True)
    assert torch.autograd.gradcheck(solve, (coeffs, f))


def _round_toward_zero(x64):
    """float64 -> float32, rounded toward zero."""
    y = x64.to(torch.float32)
    over = y.double().abs() > x64.abs()
    y[over] = torch.nextafter(y[over], torch.zeros_like(y[over]))
    return y


def _gemm_3xtf32_truncating(A, Bm, flush_every):
    """``_gemm_3xtf32`` with each MMA's sum rounded toward zero, as the
    tensor cores accumulate; every ``flush_every`` MMA depths (a k-tile) the
    chain is added to a float32 total with a rounded add, or never (0)."""
    Ab, Bb = _tf32(A), _tf32(Bm)
    As, Bs = _tf32(A - Ab), _tf32(Bm - Bb)
    total = torch.zeros((A.shape[0], Bm.shape[1]), dtype=torch.float32)
    chain = torch.zeros_like(total)
    for step, k0 in enumerate(range(0, A.shape[1], 8)):
        k = slice(k0, k0 + 8)
        for X, Y in ((As, Bb), (Ab, Bs), (Ab, Bb)):
            chain = _round_toward_zero(chain.double() + X[:, k].double() @ Y[k].double())
        if flush_every and (step + 1) % flush_every == 0:
            total, chain = total + chain, torch.zeros_like(chain)
    return total + chain


def test_truncating_accumulation_needs_the_k_tile_flush():
    """At the coarse solve's n = 1680 one truncating MMA chain over all of K
    drifts past REL_TOL (measured 3.7e-5 of max|x| here), while the
    kernel's flush every float32 k-tile (64 deep, 8 MMA depths) stays far
    inside it (measured 1.4e-6 here; chip_smoke.py phase 2 reads 2.2e-6 on
    the card)."""
    V, g, c, b = (torch.as_tensor(x, dtype=torch.float32) for x in _problem(16, 1680, seed=9))
    d = c[:, :1] * g[None, :] + c[:, 1:2]
    x64 = spectral_apply_reference(*(t.double() for t in (V, g, c, b)))
    errs = {}
    for flush in (0, 8):
        a = _gemm_3xtf32_truncating(b, V, flush) / d
        errs[flush] = _rel(_gemm_3xtf32_truncating(a, V.T.contiguous(), flush), x64)
    assert errs[8] < CHIP.REL_TOL[torch.float32] / 10 < errs[0] / 5


def test_solver_gradgradcheck_small_pencil():
    """Second derivatives through the solve: its backward pass under
    create_graph is itself differentiable (finite differences of the
    backward, float64)."""
    rng, solve = _small_pencil(5)
    coeffs = torch.tensor(rng.uniform(0.5, 2.0, (3, 2)), requires_grad=True)
    f = torch.tensor(rng.normal(size=(3, 12)), requires_grad=True)
    assert torch.autograd.gradgradcheck(solve, (coeffs, f))


def test_solver_hessian_matches_autograd_through_plain_apply(cooks_parts):
    """Cook's 20x10, float64: the Hessian of a probe functional in the
    coefficients through the solve's double backward equals autograd's
    through the plain apply (1e-10 relative)."""
    solve = make_spectral_affine_solver(cooks_parts[1])
    rng = np.random.default_rng(8)
    c0 = torch.as_tensor(np.stack([rng.uniform(8.0, 16.0, 3), rng.uniform(6.0, 9.0, 3)], 1))
    f = torch.as_tensor(rng.normal(size=(3, solve.V.shape[0])))
    w = torch.as_tensor(rng.normal(size=(3, solve.V.shape[0])))
    H = torch.autograd.functional.hessian(lambda c: (w * solve(c, f)).sum(), c0)
    H_ref = torch.autograd.functional.hessian(
        lambda c: (w * spectral_apply_reference(solve.V, solve.g, c, f)).sum(), c0)
    assert H.shape == (3, 2, 3, 2)
    assert _rel(H, H_ref) < 1e-10


@pytest.mark.parametrize("mixed", [False, True], ids=["f64", "f32_apply_1_refinement"])
def test_first_order_backward_is_the_eigen_coordinate_form_bitwise(cooks_parts, mixed):
    """Without create_graph the backward pass is the eigen-coordinate
    adjoint, bit for bit: w and the coefficient cotangent
    -(sum g a b', sum a b') from the forward and adjoint coordinates."""
    solve = make_spectral_affine_solver(cooks_parts[1],
                                        apply_dtype=torch.float32 if mixed else None,
                                        refine_iters=int(mixed))
    rng = np.random.default_rng(9)
    c = torch.tensor(np.stack([rng.uniform(8.0, 16.0, 4), rng.uniform(6.0, 9.0, 4)], 1),
                     requires_grad=True)
    f = torch.tensor(rng.normal(size=(4, solve.V.shape[0])), requires_grad=True)
    xbar = torch.as_tensor(rng.normal(size=(4, solve.V.shape[0])))
    cbar, fbar = torch.autograd.grad(solve(c, f), (c, f), xbar)
    with torch.no_grad():
        _, a = solve.coords_and_apply(c, f)
        w, b = solve.coords_and_apply(c, xbar)
        ab = a * b
        want = -torch.stack([(solve.g * ab).sum(-1), ab.sum(-1)], dim=-1).to(c.dtype)
    assert torch.equal(fbar, w) and torch.equal(cbar, want)
