"""The port's analytic cases (``prob/analytic.py``), their quadrature
references (``eval/analytic_ref.py``) and ``examples/train_analytic_case_torch.py``
against the JAX package (CPU, float64): the maps and every reference
quantity to 1e-12 on the same inputs."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vbicm_tpu.eval import analytic_ref as jax_ref
from vbicm_tpu.prob import analytic as jax_an
from vbicm_tpu_torch.eval import analytic_ref as ref
from vbicm_tpu_torch.prob import analytic as an

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAPS = ["h_fun_1d_case1", "f_fun_1d_case1", "h_fun_1d_case2", "f_fun_1d_case2",
        "f_fun_2d_case3", "h_fun_2d_case3"]
CASES = [("f_fun_1d_case1", "h_fun_1d_case1", 0.7), ("f_fun_1d_case2", "h_fun_1d_case2", 3.1)]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", MAPS)
def test_maps_match_jax(name):
    x = np.random.default_rng(0).normal(size=(64, 2) if "2d" in name else (64, 1))
    got = getattr(an, name)(torch.as_tensor(x)).numpy()
    assert _rel(got, getattr(jax_an, name)(jnp.asarray(x))) <= 1e-12


@pytest.mark.parametrize("f_name,h_name,y", CASES)
def test_quadrature_references_match_jax(f_name, h_name, y):
    f, h = getattr(an, f_name), getattr(an, h_name)
    fj, hj = getattr(jax_an, f_name), getattr(jax_an, h_name)
    t = np.linspace(-6.0, 6.0, 4001)
    z = np.linspace(0.05, 8.0, 300)
    sig_e, sig_eta = 0.1, 3e-3
    m, v = ref.predictive_moments_1d(y, f, h, sig_e, sig_eta, t)
    pz = ref.predictive_pdf_1d(y, f, h, sig_e, sig_eta, t, z)
    g = ref.gaussian_pdf_grid(z, m, v)
    errs = {
        "posterior_weights_1d": _rel(ref.posterior_weights_1d(y, f, sig_e, t),
                                     jax_ref.posterior_weights_1d(y, fj, sig_e, t)),
        "predictive_pdf_1d": _rel(pz, jax_ref.predictive_pdf_1d(y, fj, hj, sig_e, sig_eta, t, z)),
        "predictive_moments_1d": _rel((m, v), jax_ref.predictive_moments_1d(y, fj, hj, sig_e,
                                                                            sig_eta, t)),
        "posterior_moments_1d": _rel(ref.posterior_moments_1d(y, f, sig_e, t),
                                     jax_ref.posterior_moments_1d(y, fj, sig_e, t)),
        "gaussian_pdf_grid": _rel(g, jax_ref.gaussian_pdf_grid(z, m, v)),
        "lognormal_pdf_grid": _rel(ref.lognormal_pdf_grid(z, np.log(m), 0.05),
                                   jax_ref.lognormal_pdf_grid(z, np.log(m), 0.05)),
        "kld_grid": _rel(ref.kld_grid(pz, g, z), jax_ref.kld_grid(pz, g, z)),
        "kld_gaussian_exact": _rel(ref.kld_gaussian_exact(m, v, m + 0.1, 2 * v),
                                   jax_ref.kld_gaussian_exact(m, v, m + 0.1, 2 * v)),
    }
    assert max(errs.values()) <= 1e-12, errs


def test_case1_posterior_is_the_closed_form():
    """Case 1 is linear-Gaussian: the quadrature posterior is N(2y / (4 +
    sig_e), 1 / (1 + 4 / sig_e))."""
    y, sig_e = 0.7, 0.1
    m, v = ref.posterior_moments_1d(y, an.f_fun_1d_case1, sig_e, np.linspace(-6, 6, 20001))
    assert abs(m - 2 * y / (4 + sig_e)) < 1e-10 and abs(v - 1 / (1 + 4 / sig_e)) < 1e-10


@pytest.mark.parametrize("gen_name,d", [("generate_data_1d_case2", 1),
                                         ("generate_data_2d_case3", 2)])
def test_datasets(gen_name, d):
    ds = getattr(an, gen_name)(torch.Generator().manual_seed(0), 256)
    assert ds.y_data.shape == ds.z_data.shape == ds.theta_data.shape == (256, d)
    assert ds.e_data.shape == (4, d) and np.all(ds.z_data > 0)
    assert np.all(np.isfinite(ds.log_z_data))
    y, z, theta = an.generate_data_1d(torch.Generator().manual_seed(1), 32, 0.1, 3e-3)
    assert y.shape == z.shape == theta.shape == (32, 1)


def _example(*args, env=None):
    return subprocess.run([sys.executable, os.path.join(ROOT, "examples",
                                                        "train_analytic_case_torch.py"), *args],
                          cwd=ROOT, capture_output=True, text=True, timeout=300,
                          env={**os.environ, **(env or {})})


@pytest.mark.parametrize("case", ["1", "3"])
def test_example_runs_on_the_cpu_when_asked(case):
    proc = _example("--device", "cpu", "--case", case, "--n-data", "512", "--epochs", "2")
    assert proc.returncode == 0, proc.stderr
    assert ("max |mean error|" if case == "1" else "case 3 (2-D)") in proc.stdout


def test_example_refuses_to_run_without_a_gpu():
    proc = _example("--case", "1", env={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and "no GPU" in proc.stderr
