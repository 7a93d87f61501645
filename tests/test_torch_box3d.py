"""The port's 3-D tensor-product grid transfers and its box two-level solver
(values and adjoint gradients) against the JAX package and the dense solve
(CPU), and the port's plain path at the trainer's full 32x8x8 width against
the JAX golden fixture."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from vbicm_tpu.config import SectionCard as JaxSectionCard
from vbicm_tpu.mesh.solid3d import beam_hex8_mesh as jax_beam_hex8_mesh
from vbicm_tpu.model import build_fem_model as jax_build_fem_model
from vbicm_tpu.ops.multigrid import make_grid_transfer_nd as jax_make_grid_transfer_nd
from vbicm_tpu.solver import make_solver as jax_make_solver
from vbicm_tpu_torch.config import ProblemConfig, SectionCard
from vbicm_tpu_torch.mesh import beam_hex8_mesh
from vbicm_tpu_torch.model import build_fem_model
from vbicm_tpu_torch.ops.multigrid import make_grid_transfer_nd
from vbicm_tpu_torch.solver import make_fh_fun, make_two_level_solver_box3d

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                      "scaled_3d_golden.json")
CELLS_C, R = (2, 1, 1), 2  # coarse (nx, ny, nz); the fine grid is 4x2x2
CELLS = tuple(c * R for c in CELLS_C)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS/OpenMP thread while this file runs: its arrays are small,
    and the test workers running in parallel share the cores."""
    with threadpool_limits(1):
        yield


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("cells_c", [(1, 1, 2), (2, 2, 4)], ids=lambda c: "x".join(map(str, c)))
def test_grid_transfer_nd_matches_jax(cells_c):
    nc = int(np.prod([c + 1 for c in cells_c])) * 3
    nf = int(np.prod([c * R + 1 for c in cells_c])) * 3
    rng = np.random.default_rng(sum(cells_c))
    uc, rf = rng.normal(size=(3, nc)), rng.normal(size=(3, nf))
    jp, jr = jax_make_grid_transfer_nd(cells_c, R, 3)
    prolong, restrict = make_grid_transfer_nd(cells_c, R, 3)
    # 1e-13: float64 hat-matrix products against JAX's interpolation and its
    # linear transpose, summation order aside
    assert _rel(prolong(torch.as_tensor(uc)).numpy(), jax.vmap(jp)(jnp.asarray(uc))) < 1e-13
    assert _rel(restrict(torch.as_tensor(rf)).numpy(), jax.vmap(jr)(jnp.asarray(rf))) < 1e-13
    for dt in (torch.float32, torch.float64):
        assert prolong(torch.as_tensor(uc, dtype=dt)).dtype == dt


def _trilinear(shape, h):
    """A field multilinear in the (z, y, x) index coordinates times h, with
    3 dofs a node."""
    z, y, x = np.meshgrid(*[np.arange(n) * h for n in shape], indexing="ij")
    f = np.stack([1.0 + x + 2.0 * y - z + 0.5 * x * y * z, x * z - y, 3.0 * x * y + z], axis=-1)
    return torch.as_tensor(f.reshape(1, -1))


def test_grid_transfer_nd_exact_on_trilinear_fields_and_adjoint():
    cells_c = (2, 2, 4)  # (nz, ny, nx)
    prolong, restrict = make_grid_transfer_nd(cells_c, R, 3)
    uc = _trilinear([c + 1 for c in cells_c], 1.0)
    uf = _trilinear([c * R + 1 for c in cells_c], 1.0 / R)
    # a multilinear nodal field is prolonged exactly (the FE embedding)
    assert float((prolong(uc) - uf).abs().max()) <= 1e-13 * float(uf.abs().max())
    rng = np.random.default_rng(5)
    a = torch.as_tensor(rng.normal(size=(2, uc.shape[1])))
    b = torch.as_tensor(rng.normal(size=(2, uf.shape[1])))
    lhs = (prolong(a) * b).sum(-1)
    rhs = (a * restrict(b)).sum(-1)
    assert float((lhs - rhs).abs().max()) <= 1e-13 * float(lhs.abs().max())


@pytest.fixture(scope="module")
def models():
    """The 4x2x2 box: JAX dense (the reference solve), port matrix-free fine
    and dense coarse (2x1x1), port dense fine."""
    sec, jsec = SectionCard(stype=4), JaxSectionCard(stype=4)
    return (jax_build_fem_model(jax_beam_hex8_mesh(*CELLS), jsec, dense=True),
            build_fem_model(beam_hex8_mesh(*CELLS), sec, device="cpu", dense=False),
            build_fem_model(beam_hex8_mesh(*CELLS_C), sec, device="cpu", dense=True),
            build_fem_model(beam_hex8_mesh(*CELLS), sec, device="cpu", dense=True))


def _coeffs(n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(8.0, 16.0, n), rng.uniform(6.0, 9.0, n)], axis=1)


@pytest.mark.parametrize("mixed,tol", [(False, 1e-10), (True, 1e-7)],
                         ids=["f64_cg", "f32_cg_1_refinement"])
def test_box3d_solve_matches_jax_dense(models, mixed, tol):
    jdense, fine, coarse, _ = models
    coeffs = _coeffs(5, 11)
    uj = np.asarray(jax.vmap(jax_make_solver(jdense))(jnp.asarray(coeffs[:, 0]),
                                                      jnp.asarray(coeffs[:, 1])))
    kw = (dict(cg_dtype=torch.float32, refine_iters=1, tol=1e-4) if mixed
          else dict(tol=1e-12))
    solve = make_two_level_solver_box3d(fine, coarse, CELLS_C, R, maxiter=400, **kw)
    with torch.no_grad():
        u = solve(torch.as_tensor(coeffs[:, 0]), torch.as_tensor(coeffs[:, 1]))
    assert u.shape == (5, fine.ndof)
    # float64 CG at tol 1e-12 against the dense spectral solve: 1e-10; float32
    # CG at tol 1e-4 plus one float64 refinement: ~tol^2, so 1e-7
    assert _rel(u.numpy(), uj) < tol
    its = solve.solver.last_cg_iters
    assert len(its) == (2 if mixed else 1) and all(int(i.max()) < 400 for i in its)


def test_box3d_adjoint_matches_autograd_through_dense_solve(models):
    _, fine, coarse, dense = models
    coeffs = _coeffs(4, 12)
    w = torch.as_tensor(np.random.default_rng(13).normal(size=(4, fine.ndof)))
    solve = make_two_level_solver_box3d(fine, coarse, CELLS_C, R, cg_dtype=torch.float32,
                                        refine_iters=1, tol=1e-4, maxiter=400)
    c = torch.tensor(coeffs, requires_grad=True)
    (g,) = torch.autograd.grad((solve(c[:, 0], c[:, 1]) * w).sum(), c)

    c_ref = torch.tensor(coeffs, requires_grad=True)
    K = (c_ref[:, 0, None, None] * dense.k_lam_ff + c_ref[:, 1, None, None] * dense.k_mu_ff)
    u_f = torch.linalg.solve(K, dense.f_free.expand(4, -1))
    (g_ref,) = torch.autograd.grad((u_f * w[:, dense.free_dof]).sum(), c_ref)
    # the adjoint of a float32 CG + one float64 refinement at tol 1e-4 against
    # autograd through a float64 dense solve: 1e-6 relative
    assert _rel(g.numpy(), g_ref.numpy()) < 1e-6


@pytest.mark.parametrize("kwargs", [dict(cycle="vcycle"), dict(with_rhs_solver=True),
                                    dict(refine_residual="compensated")],
                         ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_box3d_solver_rejects_unported_options(models, kwargs):
    _, fine, coarse, _ = models
    with pytest.raises(NotImplementedError):
        make_two_level_solver_box3d(fine, coarse, CELLS_C, R, **kwargs)


@pytest.fixture(scope="module")
def train_golden():
    """The "train" golden entry and the port's 32x8x8 / 16x4x4 models."""
    with open(GOLDEN) as f:
        gold = json.load(f)
    g = gold["train"]["mesh"]
    kw = {"lx": g["lx"], "tip_force": tuple(g["tip_force"])}
    cells = (g["nx"], g["ny"], g["nz"])
    cells_c = tuple(c // g["ratio"] for c in cells)
    sec = SectionCard(stype=4)
    return (gold, build_fem_model(beam_hex8_mesh(*cells, **kw), sec, device="cpu", dense=False),
            build_fem_model(beam_hex8_mesh(*cells_c, **kw), sec, device="cpu", dense=True))


@pytest.mark.parametrize("kw,tol", [(dict(tol=1e-12, maxiter=2000), 1e-9),
                                    (dict(cg_dtype=torch.float32, refine_iters=2, tol=3e-3,
                                          maxiter=400), 1e-6)],
                         ids=["f64_cg", "f32_cg_2_refinements"])
def test_plain_path_32x8x8_matches_jax_golden(train_golden, kw, tol):
    gold, model, coarse = train_golden
    g = gold["train"]
    assert model.ndof == g["mesh"]["ndof"]
    probe = g["probe"]
    cfg = dataclasses.replace(ProblemConfig(), y_dim=3, node_id=probe["node_id"],
                              ele_id=probe["ele_id"], nipt_id=tuple(probe["nipt_id"]))
    solve = make_two_level_solver_box3d(model, coarse, tuple(c // g["mesh"]["ratio"] for c in (
        g["mesh"]["nx"], g["mesh"]["ny"], g["mesh"]["nz"])), g["mesh"]["ratio"], **kw)
    with torch.no_grad():
        y, h = make_fh_fun(model, cfg, solve_free=solve)(
            torch.as_tensor(gold["thetas"], dtype=torch.float64))
    # float64 CG at tol 1e-12 against the JAX package's: 1e-9; the chip
    # check's setting (float32 CG at tol 3e-3 + two float64 refinements):
    # 1e-6, as chip_smoke.py holds the kernel path
    assert _rel(y.numpy(), g["y"]) < tol and _rel(h.numpy(), g["h"]) < tol
