"""The port's field ROM (``rom/field.py``) against the JAX package on the
CPU, float64: the host greedy at 10x5 with 6 KL modes and a small pool
(32 candidates, at most 40 vectors) gives Q, M, f_r and both certificates
within 1e-12 of JAX's; the batched ROM observation operator on a JAX-built
basis carried across, y and h within 1e-10 of JAX's and theta-gradients
within rtol 1e-8; the reduced solve within 1e-10."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from vbicm_tpu.config import ProblemConfig as JaxProblemConfig
from vbicm_tpu.mesh import cooks_membrane_mesh as jax_cooks_mesh
from vbicm_tpu.model import build_fem_model as jax_build_fem_model
from vbicm_tpu.prob import randomfield as jrf
from vbicm_tpu.rom import field as jfield
from vbicm_tpu_torch.config import ProblemConfig
from vbicm_tpu_torch.mesh import cooks_membrane_mesh
from vbicm_tpu_torch.model import build_fem_model
from vbicm_tpu_torch.prob import randomfield as rf
from vbicm_tpu_torch.rom import field

N_MODES = 6
PROBES = tuple(range(8, 67, 6))
CFG = dict(theta_dim=N_MODES, y_dim=2 * len(PROBES), ele_id=5)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    with threadpool_limits(1):
        yield


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def bases():
    """Both packages' models, the KL basis (carried to JAX) and both
    packages' reduced bases from the same pool."""
    model = build_fem_model(cooks_membrane_mesh(10, 5), device="cpu")
    jmodel = jax_build_fem_model(jax_cooks_mesh(10, 5), dense=True)
    kl = rf.build_kl_expansion(model, n_modes=N_MODES, corr_len=15.0, sigma=0.3)
    jkl = jrf.KLExpansion(modes=kl.modes, eigvals=kl.eigvals, mean_log=kl.mean_log,
                          corr_len=kl.corr_len, sigma=kl.sigma)
    kw = dict(nu=0.3, n_candidates=32, n_validate=16, tol=1e-9, max_basis=40, seed=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the small pool's exhaustion warning, in both
        rb = field.build_reduced_basis_field(model, kl, **kw)
        jrb = jfield.build_reduced_basis_field(jmodel, jkl, **kw)
    return model, jmodel, kl, jkl, rb, jrb


def test_greedy_basis_matches_jax(bases):
    _, _, _, _, rb, jrb = bases
    assert rb.r == jrb.r and rb.nu == jrb.nu
    for name in ("Q", "M", "f_r", "theta_snapshots"):
        assert _rel(getattr(rb, name), getattr(jrb, name)) <= 1e-12, name
    for name in ("max_rel_residual", "val_max_rel_residual"):
        a, b = getattr(rb, name), getattr(jrb, name)
        assert abs(a - b) <= 1e-12 * max(abs(b), 1e-300), (name, a, b)


def test_reduced_solve_matches_jax(bases):
    _, _, kl, _, _, jrb = bases
    rb = field.FieldReducedBasis(**{k: getattr(jrb, k) for k in field.FieldReducedBasis.
                                    __dataclass_fields__})
    E = np.exp(kl.mean_log + np.random.default_rng(2).standard_normal((4, N_MODES)) @ kl.modes)
    got = field.reduced_field_solve(rb, torch.as_tensor(E))
    for b in range(4):
        assert _rel(got[b], jfield.reduced_field_solve(jrb, jnp.asarray(E[b]))) <= 1e-10


def test_rom_fh_on_a_jax_basis_matches_jax(bases):
    """A JAX-built basis carried across by its arrays: y, h 1e-10 and the
    theta-gradient of sum(y^2) + sum(h) rtol 1e-8."""
    model, jmodel, kl, jkl, _, jrb = bases
    rb = field.FieldReducedBasis(**{k: getattr(jrb, k) for k in field.FieldReducedBasis.
                                    __dataclass_fields__})
    fh = field.make_fh_fun_field_rom(model, kl, rb, ProblemConfig(**CFG), probe_nodes=PROBES)
    jfh = jfield.make_fh_fun_field_rom(jmodel, jkl, jrb, JaxProblemConfig(**CFG),
                                       probe_nodes=PROBES)
    theta = np.random.default_rng(7).standard_normal((5, N_MODES))
    th = torch.as_tensor(theta).requires_grad_(True)
    y, h = fh(th)
    (g,) = torch.autograd.grad((y**2).sum() + h.sum(), th)
    jy, jh = jax.jit(jax.vmap(jfh))(jnp.asarray(theta))
    jg = jax.jit(jax.vmap(jax.grad(lambda t: jnp.sum(jfh(t)[0] ** 2) + jnp.sum(jfh(t)[1]))))(
        jnp.asarray(theta))
    assert _rel(y.detach(), jy) <= 1e-10 and _rel(h.detach(), jh) <= 1e-10
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-8)


def test_rom_fh_is_exact_at_the_greedy_snapshots(bases):
    """At the greedy's own snapshot draws the solution lies in the basis, so
    the ROM equals the full-order field fh (1e-8 relative; certified
    training residual below 1e-9). The small pool's held-out certificate is
    far looser, as the JAX package's docstring measures."""
    model, _, kl, _, rb, _ = bases
    cfg = ProblemConfig(**CFG)
    fh = field.make_fh_fun_field_rom(model, kl, rb, cfg, probe_nodes=PROBES)
    full = rf.make_fh_fun_field(model, kl, cfg, probe_nodes=PROBES, grid=(10, 5))
    theta = torch.as_tensor(rb.theta_snapshots[:8])
    with torch.no_grad():
        (y, h), (yf, hf) = fh(theta), full(theta)
    assert rb.max_rel_residual < 1e-9
    assert _rel(y, yf) <= 1e-8 and _rel(h, hf) <= 1e-8


@pytest.mark.parametrize("override", [dict(probe_nodes=(0,)), dict(ele_id=51),
                                      dict(nipt_id=(5,))])
def test_rom_fh_rejects_bad_probes(bases, override):
    model, _, kl, _, rb, _ = bases
    override = dict(override)
    probes = override.pop("probe_nodes", PROBES)
    with pytest.raises(ValueError):
        field.make_fh_fun_field_rom(model, kl, rb, ProblemConfig(**{**CFG, **override}),
                                    probe_nodes=probes)
