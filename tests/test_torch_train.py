"""The port's slices as a whole on the CPU: dataset generation and the
two-step trainer on Cook's membrane 20x10 and on a small 3-D hex8 box, and
the rule that the port imports nothing of JAX."""
import ast
import dataclasses
import importlib.util
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import vbicm_tpu_torch
from vbicm_tpu_torch.config import ProblemConfig, SectionCard, TrainConfig
from vbicm_tpu_torch.mesh import beam_hex8_mesh, cooks_membrane_mesh
from vbicm_tpu_torch.model import build_fem_model
from vbicm_tpu_torch.prob.datagen import generate_data_fem
from vbicm_tpu_torch.solver import make_fh_fun, make_two_level_solver_box3d
from vbicm_tpu_torch.utils import trace
from vbicm_tpu_torch.vi.train import TwoStepTrainer


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS/OpenMP thread while this file runs: its matrices are small,
    and the test workers running in parallel share the cores."""
    with threadpool_limits(1):
        yield

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "vbicm_tpu")


def test_fit_cooks_two_step_on_cpu():
    before = trace.counters().get("spectral_apply.launches", 0)
    model = build_fem_model(cooks_membrane_mesh(20, 10), device="cpu")
    cfg = ProblemConfig()
    fh = make_fh_fun(model, cfg, factor_dtype=torch.float32, refine_iters=1)
    ds = generate_data_fem(torch.Generator().manual_seed(0), fh, n_sam=64, ne_sam=4,
                           device="cpu", sig_e=cfg.sig_e, sig_eta=cfg.sig_eta)
    assert ds.y_data.shape == (64, 2) and ds.z_data.shape == (64, 2) and ds.ne_sam == 4
    assert np.all(np.isfinite(ds.log_z_data))

    tcfg = TrainConfig(batch_size=16, num_epoch1=2, num_epoch2=2)
    trainer = TwoStepTrainer(model, cfg, tcfg, fh_batch=fh)
    res = trainer.fit(ds.y_data, ds.e_data, torch.Generator().manual_seed(1))
    assert res.hist_step1.shape == (2,) and res.hist_step2.shape == (2,)
    assert np.all(np.isfinite(res.hist_step1)) and np.all(np.isfinite(res.hist_step2))
    assert res.logz_mean_post.shape == (64, 2) and np.all(res.logz_sig_post >= 0.0)
    preds = trainer.predict(res.theta_net, res.z_net, ds.y_data)
    assert all(p.shape == (64, 2) and bool(torch.isfinite(p).all()) for p in preds)
    # CPU tensors take the plain version
    assert trace.counters().get("spectral_apply.launches", 0) == before


def test_fit_box3d_two_step_on_cpu():
    """The 3-D path end to end at 4x2x2 (coarse 2x1x1): dataset generation
    and the trainer through the box two-level observation operator, with
    input standardization and per-sample pairing."""
    before = trace.counters().get("stencil3d_affine.launches", 0)
    sec = SectionCard(stype=4)
    tip = (0.0, 0.0, -1.0)  # root stresses well above the noise at this coarse grid
    model = build_fem_model(beam_hex8_mesh(4, 2, 2, tip_force=tip), sec, device="cpu",
                            dense=False)
    coarse = build_fem_model(beam_hex8_mesh(2, 1, 1, tip_force=tip), sec, device="cpu")
    solve = make_two_level_solver_box3d(model, coarse, (2, 1, 1), 2, cg_dtype=torch.float32,
                                        refine_iters=1, tol=3e-3, maxiter=400)
    cfg = dataclasses.replace(ProblemConfig(), y_dim=3, node_id=model.nnodes, ele_id=14,
                              nipt_id=(1, 5))
    fh = make_fh_fun(model, cfg, solve_free=solve)
    ds = generate_data_fem(torch.Generator().manual_seed(0), fh, n_sam=32, ne_sam=4,
                           device="cpu", d_y=3, sig_e=cfg.sig_e, sig_eta=cfg.sig_eta)
    assert ds.y_data.shape == (32, 3) and np.all(np.isfinite(ds.log_z_data))
    tcfg = TrainConfig(batch_size=16, num_epoch1=2, num_epoch2=2, lr_decay_mode="fixed",
                       pairing="per_sample")
    trainer = TwoStepTrainer(None, cfg, tcfg, fh_batch=fh, device="cpu",
                             y_norm=(ds.y_mean, ds.y_std), bridge_chunk=48)
    res = trainer.fit(ds.y_data, ds.e_data, torch.Generator().manual_seed(1))
    assert np.all(np.isfinite(res.hist_step1)) and np.all(np.isfinite(res.hist_step2))
    assert res.logz_mean_post.shape == (32, 2)
    np.testing.assert_allclose(res.theta_net.y_shift.numpy(), ds.y_mean.ravel())
    preds = trainer.predict(res.theta_net, res.z_net, ds.y_data[:8])
    assert all(p.shape == (8, 2) and bool(torch.isfinite(p).all()) for p in preds)
    # CPU tensors take the plain version
    assert trace.counters().get("stencil3d_affine.launches", 0) == before


@pytest.mark.parametrize("field,value", [("posterior", "fullcov"), ("ckpt_every", 1),
                                         ("resample_e", True)])
def test_trainer_rejects_unported_options(field, value, tmp_path):
    """The options the trainer once refused as not ported are accepted: one
    epoch of one batch on Cook's 4x2 takes a finite step (and writes the
    checkpoint that ``ckpt_every`` asks for)."""
    model = build_fem_model(cooks_membrane_mesh(4, 2), device="cpu")
    cfg = ProblemConfig(node_id=15, ele_id=8)
    tcfg = TrainConfig(**{field: value}, pairing="per_sample", batch_size=8, num_epoch1=1)
    trainer = TwoStepTrainer(model, cfg, tcfg, results_path=str(tmp_path))
    y = np.random.default_rng(0).normal(scale=0.1, size=(8, 2))
    e = np.random.default_rng(1).normal(size=(4, 2))
    net, hist, _ = trainer.train_step1(y, e, torch.Generator().manual_seed(0))
    assert hist.shape == (1,) and np.isfinite(hist).all()
    if field == "ckpt_every":
        assert sorted(os.listdir(tmp_path / "step1"))[0].startswith("00-")


@pytest.mark.parametrize("posterior,pairing", [("gaussian", "per_sample"), ("fullcov", "cross"),
                                               ("flow", "cross")])
def test_trainer_rejects_what_jax_rejects(posterior, pairing):
    model = build_fem_model(cooks_membrane_mesh(4, 2), device="cpu")
    with pytest.raises(ValueError):
        TwoStepTrainer(model, ProblemConfig(node_id=15, ele_id=8),
                       TrainConfig(posterior=posterior, pairing=pairing))


def test_port_imports_no_jax_in_a_fresh_process():
    code = (
        "import importlib, pkgutil, sys, vbicm_tpu_torch\n"
        "for m in pkgutil.walk_packages(vbicm_tpu_torch.__path__, 'vbicm_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_port_sources_import_no_jax():
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "examples", "train_vi_torch.py"),
             os.path.join(ROOT, "examples", "train_scaled_fullorder_torch.py"),
             os.path.join(ROOT, "examples", "train_scaled_3d_torch.py"),
             os.path.join(ROOT, "examples", "train_scaled_rom_torch.py"),
             os.path.join(ROOT, "examples", "stencil_kernel_study_torch.py"),
             os.path.join(ROOT, "examples", "postprocess_vi_torch.py"),
             os.path.join(ROOT, "examples", "train_analytic_case_torch.py"),
             os.path.join(ROOT, "examples", "train_flow_vi_torch.py"),
             os.path.join(ROOT, "examples", "cooks_forward_torch.py"),
             os.path.join(ROOT, "examples", "train_randomfield_torch.py"),
             os.path.join(ROOT, "examples", "train_randomfield_3d_torch.py"),
             os.path.join(ROOT, "examples", "arbitrate_scaled_posterior_torch.py"),
             os.path.join(ROOT, "examples", "validate_scaled_3d_torch.py"),
             os.path.join(ROOT, "tools", "profile_scaled_torch.py")]
    for m in pkgutil.walk_packages(vbicm_tpu_torch.__path__, "vbicm_tpu_torch."):
        files.append(importlib.util.find_spec(m.name).origin)
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            assert not any(n.split(".")[0] in FORBIDDEN for n in names), (path, names)


def test_chip_smoke_refuses_to_run_without_a_gpu():
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_scaled_example_refuses_to_run_without_a_gpu():
    proc = subprocess.run([sys.executable,
                           os.path.join(ROOT, "examples", "train_scaled_fullorder_torch.py"),
                           "--nx", "8", "--ny", "4", "--n-data", "8"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr


def test_scaled_3d_example_refuses_to_run_without_a_gpu():
    proc = subprocess.run([sys.executable,
                           os.path.join(ROOT, "examples", "train_scaled_3d_torch.py"),
                           "--nx", "4", "--ny", "2", "--nz", "2", "--n-data", "8"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr


def test_scaled_rom_example_refuses_to_run_without_a_gpu():
    proc = subprocess.run([sys.executable,
                           os.path.join(ROOT, "examples", "train_scaled_rom_torch.py"),
                           "--nx", "8", "--ny", "4", "--n-data", "8"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr


def test_postprocess_example_refuses_to_run_without_a_gpu():
    proc = subprocess.run([sys.executable,
                           os.path.join(ROOT, "examples", "postprocess_vi_torch.py"),
                           "--n-data", "8", "--quick-train-epochs", "1"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr


@pytest.mark.parametrize("example", ["train_flow_vi_torch.py", "cooks_forward_torch.py"])
def test_new_examples_refuse_to_run_without_a_gpu(example):
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "examples", example)],
                          cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr


@pytest.mark.parametrize("example", ["train_randomfield_torch.py", "train_randomfield_3d_torch.py",
                                     "arbitrate_scaled_posterior_torch.py",
                                     "validate_scaled_3d_torch.py"])
def test_field_examples_refuse_to_run_without_a_gpu(example):
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "examples", example)],
                          cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr
