"""The port's comparison pipeline (``eval/comparison.py``) and the trainer's
posterior sampler against the JAX package on Cook's 20x10 in float64 (CPU).

Held to JAX on the same inputs: the FEM pushes without noise to 1e-10; the
grid densities, ``y_grid``, ``relative_error_fields``, the proposed fields
of ``mean_sig_fields`` and the KLD maps' KDE bookkeeping (fed JAX's own
draws) to 1e-12; ``sample_theta`` with the same flax weights to 1e-12. The
maps and fields themselves draw torch random numbers, so they are checked
for shape, finiteness and the self-consistency of tests/test_eval.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from vbicm_tpu.config import ProblemConfig as JaxProblemConfig
from vbicm_tpu.config import TrainConfig as JaxTrainConfig
from vbicm_tpu.eval import comparison as jax_cmp
from vbicm_tpu.models.mlp import init_vi_networks as jax_init_vi_networks
from vbicm_tpu.solver import make_fh_fun as jax_make_fh_fun
from vbicm_tpu.vi.train import TwoStepTrainer as JaxTwoStepTrainer
from vbicm_tpu_torch.config import ProblemConfig, TrainConfig
from vbicm_tpu_torch.eval import comparison as cmp
from vbicm_tpu_torch.mesh import cooks_membrane_mesh
from vbicm_tpu_torch.model import build_fem_model
from vbicm_tpu_torch.models.mlp import ThetaPosteriorNet, load_flax_params
from vbicm_tpu_torch.solver import make_fh_fun
from vbicm_tpu_torch.vi.train import TwoStepTrainer

SIG_ETA = 3e-3


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS/OpenMP thread while this file runs: its arrays are small,
    and the test workers running in parallel share the cores."""
    with threadpool_limits(1):
        yield


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def model():
    return build_fem_model(cooks_membrane_mesh(20, 10), device="cpu")


@pytest.fixture(scope="module")
def batch_h(model, cooks_model):
    """Both packages' batched h on Cook's 20x10."""
    fh = make_fh_fun(model)
    jfh = jax.jit(jax.vmap(jax_make_fh_fun(cooks_model)))
    return (lambda th: fh(th)[1]), (lambda th: jfh(th)[1])


@pytest.fixture(scope="module")
def moments():
    """A 3x3 y-grid's posterior and predictive moments near their real
    scale: (y, theta_mean, theta_sig, z_mean, z_sig)."""
    rng = np.random.default_rng(0)
    n_y = 9
    tm = rng.normal(size=(n_y, 2)) * 0.3
    tsg = np.full((n_y, 2), 0.04)
    zm = np.log(0.25) + 0.05 * rng.normal(size=(n_y, 2))
    zs = np.exp(rng.uniform(-6.0, -4.0, (n_y, 2)))
    y = cmp.y_grid([-4.0, 5.5], [0.2, 0.3], 2.0, 3)[0]
    return y, tm, tsg, zm, zs


def test_fem_pushes_without_noise_match_jax(batch_h):
    bh, bh_j = batch_h
    th = np.random.default_rng(1).normal(size=(4, 6, 2))
    z = cmp.mc_z_samples_theta(torch.Generator().manual_seed(0), bh, th, 0.0, chunk=5)
    z_j = jax_cmp.mc_z_samples_theta(jax.random.PRNGKey(0), bh_j, th, 0.0)
    assert z.shape == (4, 6, 2) and _rel(z, z_j) <= 1e-10


def test_grid_densities_y_grid_and_relative_errors_match_jax():
    rng = np.random.default_rng(1)
    z_sam = np.exp(rng.normal(size=(500, 2)) * 0.2 + np.log(0.25))
    gd, gd_j = (m.classical_grid_density(z_sam, mf=3.0, num_points=40) for m in (cmp, jax_cmp))
    gp, gp_j = (m.proposed_grid_density(np.log([0.25, 0.25]), [0.04, 0.04], mf=3.0,
                                        num_points=40) for m in (cmp, jax_cmp))
    for got, want in ((gd, gd_j), (gp, gp_j)):
        for a, b in zip(got, want):
            assert _rel(a, b) <= 1e-12
        dx, dy = got.xg[0, 1] - got.xg[0, 0], got.yg[1, 0] - got.yg[0, 0]
        assert 0.6 < got.pdf.sum() * dx * dy < 1.1  # roughly a density
    assert _rel(cmp.kde_on_grid(z_sam, gp), jax_cmp.kde_on_grid(z_sam, gp_j)) <= 1e-12
    for a, b in zip(cmp.y_grid([-4.2, 5.6], [0.1, 0.1], 3.0, 4),
                    jax_cmp.y_grid([-4.2, 5.6], [0.1, 0.1], 3.0, 4)):
        assert _rel(a, b) <= 1e-12
    fields = {k: (rng.uniform(0.2, 0.3, (9, 2)), rng.uniform(1e-4, 1e-3, (9, 2)))
              for k in ("proposed", "classical", "reference")}
    fields["reference"][0][0, 0] = 1e-8  # below tol: zeroed
    rel, rel_j = cmp.relative_error_fields(fields), jax_cmp.relative_error_fields(fields)
    for k in ("proposed", "classical"):
        for a, b in zip(rel[k], rel_j[k]):
            assert np.abs(a - b).max() <= 1e-12 * np.abs(b).max()
    assert rel["proposed"][0][0, 0] == 0.0


def test_kld_bookkeeping_on_jax_draws_matches_jax_kld_maps(batch_h, moments):
    """kld_maps' KDE bookkeeping, fed the draws JAX's kld_maps makes from
    its key (the lognormal noise, the reference and classical pushes), gives
    JAX's maps to 1e-12."""
    _, bh_j = batch_h
    y, tm, tsg, zm, zs = moments
    num_sam, key = 24, jax.random.PRNGKey(3)
    tm_c = tm + 0.1
    want = jax_cmp.kld_maps(key, bh_j, y, (tm, tsg, zm, zs), (tm_c, tsg), SIG_ETA, num_sam)
    k1, k2, k3 = jax.random.split(key, 3)
    eps = np.asarray(jax.random.normal(k1, (y.shape[0], num_sam, 2), dtype=jnp.float64))
    z_ref = jax_cmp.mc_z_samples(k2, bh_j, tm, tsg, SIG_ETA, num_sam)
    z_cla = jax_cmp.mc_z_samples(k3, bh_j, tm_c, tsg, SIG_ETA, num_sam)
    got = cmp.kld_from_samples(y, zm, zs, eps, z_ref, z_cla)
    for a, b in zip(got, want):
        assert a.shape == (9,) and _rel(a, b) <= 1e-12


def test_maps_and_fields_run_and_agree_with_themselves(batch_h, moments):
    """kld_maps and mean_sig_fields end to end on torch draws: shapes and
    finiteness; the proposed fields equal JAX's closed form (1e-12); with
    the classical posterior equal to the proposed one, the classical and
    reference fields agree to Monte-Carlo error (tests/test_eval.py)."""
    bh, bh_j = batch_h
    y, tm, tsg, zm, zs = moments
    gen = torch.Generator().manual_seed(0)
    kld_p, kld_c = cmp.kld_maps(gen, bh, y, (tm, tsg, zm, zs), (tm, tsg), SIG_ETA, 24)
    assert kld_p.shape == kld_c.shape == (9,)
    assert np.isfinite(kld_p).all() and np.isfinite(kld_c).all()
    fields = cmp.mean_sig_fields(gen, bh, (tm, tsg, zm, zs), (tm, tsg), SIG_ETA, 200)
    fields_j = jax_cmp.mean_sig_fields(jax.random.PRNGKey(0), bh_j, (tm, tsg, zm, zs),
                                       (tm, tsg), SIG_ETA, 4)
    for a, b in zip(fields["proposed"], fields_j["proposed"]):
        assert _rel(a, b) <= 1e-12
    for name in ("classical", "reference"):
        m, s = fields[name]
        assert m.shape == s.shape == (9, 2) and np.isfinite(m).all() and np.isfinite(s).all()
    np.testing.assert_allclose(fields["classical"][0], fields["reference"][0], rtol=0.2,
                               atol=0.02)
    assert np.isfinite(cmp.relative_error_fields(fields)["proposed"][0]).all()


@pytest.fixture(scope="module")
def theta_weights():
    _, theta_p, _, _ = jax_init_vi_networks(jax.random.PRNGKey(4))
    return jax.tree_util.tree_map(np.asarray, theta_p)


def test_sample_theta_matches_jax(model, cooks_model, theta_weights):
    rng = np.random.default_rng(5)
    y, e = rng.normal(size=(6, 2)) + [-4.0, 5.5], rng.normal(size=(8, 2))
    want = JaxTwoStepTrainer(cooks_model, JaxProblemConfig(), JaxTrainConfig()).sample_theta(
        theta_weights, y, e)
    trainer = TwoStepTrainer(model, ProblemConfig(), TrainConfig())
    net = load_flax_params(ThetaPosteriorNet(), theta_weights)
    got = trainer.sample_theta(net, y, e)
    assert got.shape == (6, 8, 2) and _rel(got.detach(), want) <= 1e-12


def test_theta_sampler_drives_the_comparison_hook(model, batch_h, theta_weights):
    """The trainer's sampler through the ``proposed_sampler`` hook: the
    reference fields are Monte Carlo through exact posterior draws."""
    trainer = TwoStepTrainer(model, ProblemConfig(), TrainConfig())
    net = load_flax_params(ThetaPosteriorNet(), theta_weights)
    y = np.random.default_rng(6).normal(size=(3, 2)) + [-4.0, 5.5]
    sampler = trainer.theta_sampler(net, y)
    th = sampler(torch.Generator().manual_seed(1), 16)
    assert th.shape == (3, 16, 2)
    tm, tsg, zm, zs = trainer.predict(net, trainer.new_z_net(torch.Generator().manual_seed(2)), y)
    fields = cmp.mean_sig_fields(torch.Generator().manual_seed(3), batch_h[0],
                                 (tm, tsg, zm, zs), (tm, tsg), SIG_ETA, 16,
                                 proposed_sampler=sampler)
    assert all(np.isfinite(a).all() and a.shape == (3, 2) for a in fields["reference"])
