"""The trainer's checkpoints on the CPU: every resume lands bitwise on the
uninterrupted run (step 1, step 2, a crash inside an epoch with a partial
final chunk, ``fit(resume=True)``, resampled base draws), the numbered-file
fallback, and the checkpoint cadence."""
import os

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from vbicm_tpu_torch.config import ProblemConfig, TrainConfig
from vbicm_tpu_torch.mesh import cooks_membrane_mesh
from vbicm_tpu_torch.model import build_fem_model
from vbicm_tpu_torch.prob.datagen import generate_data_fem
from vbicm_tpu_torch.solver import make_fh_fun
from vbicm_tpu_torch.vi.train import TwoStepTrainer


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS/OpenMP thread while this file runs: its matrices are small,
    and the test workers running in parallel share the cores."""
    with threadpool_limits(1):
        yield


class Crash(Exception):
    """The simulated worker crash."""


@pytest.fixture(scope="module")
def problem():
    """Cook's 20x10 and 88 observations: batches of 16 give five full
    batches and a partial one."""
    model = build_fem_model(cooks_membrane_mesh(20, 10), device="cpu")
    cfg = ProblemConfig()
    fh = make_fh_fun(model, cfg)
    ds = generate_data_fem(torch.Generator().manual_seed(0), fh, n_sam=88, ne_sam=4,
                           device="cpu", sig_e=cfg.sig_e, sig_eta=cfg.sig_eta)
    return model, cfg, fh, ds


def _crashing(fh, after):
    """``fh`` that raises Crash on its call number ``after + 1``."""
    calls = [0]

    def wrapped(thetas):
        calls[0] += 1
        if calls[0] > after:
            raise Crash
        return fh(thetas)

    return wrapped


def _trainer(problem, tcfg, path=None, fh=None):
    model, cfg, fh0, _ = problem
    return TwoStepTrainer(model, cfg, tcfg, fh_batch=fh or fh0, results_path=path)


def _assert_same_net(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def _gen():
    return torch.Generator().manual_seed(1)


TCFG = dict(batch_size=16, lr_decay_mode="fixed", lr_patience=2, pairing="per_sample")


@pytest.mark.parametrize("family", ["meanfield", "fullcov", "flow"])
def test_step1_two_plus_two_equals_four(problem, tmp_path, family):
    ds = problem[3]
    tcfg = TrainConfig(**TCFG, posterior=family)
    net4, hist4, _ = _trainer(problem, tcfg).train_step1(ds.y_data, ds.e_data, _gen(), 4)
    _trainer(problem, tcfg, str(tmp_path)).train_step1(ds.y_data, ds.e_data, _gen(), 2)
    net, hist, _ = _trainer(problem, tcfg, str(tmp_path)).train_step1(
        ds.y_data, ds.e_data, _gen(), 4, resume=True)
    _assert_same_net(net, net4)
    assert np.array_equal(hist, hist4)


def test_step1_resume_with_resampled_draws(problem, tmp_path):
    ds = problem[3]
    tcfg = TrainConfig(**TCFG, resample_e=True, clip_grad_norm=5.0)
    net4, hist4, _ = _trainer(problem, tcfg).train_step1(ds.y_data, ds.e_data, _gen(), 4)
    _trainer(problem, tcfg, str(tmp_path)).train_step1(ds.y_data, ds.e_data, _gen(), 2)
    net, hist, _ = _trainer(problem, tcfg, str(tmp_path)).train_step1(
        ds.y_data, ds.e_data, _gen(), 4, resume=True)
    _assert_same_net(net, net4)
    assert np.array_equal(hist, hist4)


def test_step2_resume(problem, tmp_path):
    ds = problem[3]
    tcfg = TrainConfig(**TCFG)
    tr = _trainer(problem, tcfg)
    g = _gen()
    theta_net, _, _ = tr.train_step1(ds.y_data, ds.e_data, g, 2)
    lm, ls = tr.bridge(ds.y_data, ds.e_data, theta_net, g)
    state = g.get_state()
    z4, hist4, _ = tr.train_step2(ds.y_data, ds.e_data, theta_net, lm, ls, g, 4)
    g.set_state(state)
    _trainer(problem, tcfg, str(tmp_path)).train_step2(ds.y_data, ds.e_data, theta_net, lm, ls,
                                                      g, 2)
    g.set_state(state)
    z, hist, _ = _trainer(problem, tcfg, str(tmp_path)).train_step2(
        ds.y_data, ds.e_data, theta_net, lm, ls, g, 4, resume=True)
    _assert_same_net(z, z4)
    assert np.array_equal(hist, hist4)


@pytest.mark.parametrize("step", ["step1", "step2"])
def test_chunk_crash_after_partial_final_chunk_resumes_exactly(problem, tmp_path, step):
    """``ckpt_chunk`` with ``scan_chunk=2`` over five full batches and a
    partial one banks batches 2, 4 and 5 of each epoch. A crash in the
    partial batch of epoch 1 leaves a bundle with 5 batches done; the
    resumed run must skip all five. The JAX package's skip test
    ``s + ck <= start_batch`` (vbicm_tpu/vi/train.py:463, :650) would run
    the last chunk (batch 5) again on top of the banked state, and this
    test would then fail."""
    ds = problem[3]
    tcfg = TrainConfig(**TCFG, ckpt_chunk=True, scan_chunk=2, ckpt_every=5)
    straight = _trainer(problem, tcfg).fit(ds.y_data, ds.e_data, _gen(), epochs1=3, epochs2=3)
    # step 1 calls fh once a batch (6 an epoch); step 2 once a batch too,
    # after the bridge's one sweep
    after = 6 + 5 if step == "step1" else 3 * 6 + 1 + 6 + 5
    crashing = _trainer(problem, tcfg, str(tmp_path), _crashing(problem[2], after))
    with pytest.raises(Crash):
        crashing.fit(ds.y_data, ds.e_data, _gen(), epochs1=3, epochs2=3)
    state = torch.load(os.path.join(tmp_path, step, "latest.pt"), weights_only=True)
    assert (state["epoch"], state["batches_done"]) == (1, 5)
    res = _trainer(problem, tcfg, str(tmp_path)).fit(ds.y_data, ds.e_data, _gen(), epochs1=3,
                                                    epochs2=3, resume=True)
    _assert_same_net(res.theta_net, straight.theta_net)
    _assert_same_net(res.z_net, straight.z_net)
    assert np.array_equal(res.hist_step1, straight.hist_step1)
    assert np.array_equal(res.hist_step2, straight.hist_step2)


def test_fit_resume_after_step1(problem, tmp_path):
    """Step 1 done and banked, the run killed before the bridge: ``fit(resume
    =True)`` restores step 1 with the generator, so that the bridge and
    step 2 draw what the uninterrupted run drew."""
    ds = problem[3]
    tcfg = TrainConfig(**TCFG, num_epoch1=3, num_epoch2=3, ckpt_every=1)
    straight = _trainer(problem, tcfg).fit(ds.y_data, ds.e_data, _gen())
    _trainer(problem, tcfg, str(tmp_path)).train_step1(ds.y_data, ds.e_data, _gen())
    res = _trainer(problem, tcfg, str(tmp_path)).fit(ds.y_data, ds.e_data, _gen(), resume=True)
    assert res.epoch_times_step1 == []  # nothing of step 1 ran again
    np.testing.assert_array_equal(res.logz_mean_post, straight.logz_mean_post)
    np.testing.assert_array_equal(res.logz_sig_post, straight.logz_sig_post)
    _assert_same_net(res.z_net, straight.z_net)
    assert np.array_equal(res.hist_step1, straight.hist_step1)
    assert np.array_equal(res.hist_step2, straight.hist_step2)
    assert os.path.exists(os.path.join(tmp_path, "temp_data.mat"))


def test_corrupt_bundle_falls_back_to_numbered_file(problem, tmp_path):
    """An unreadable ``latest.pt``: the newest numbered weights file is
    restored, the history slots without a file hold NaN, and fixed-mode lr
    decay does not fire against them (with 0.0 there, as the JAX package
    fills, the positive loss would fire it at epoch 4)."""
    ds = problem[3]
    tcfg = TrainConfig(**TCFG, ckpt_every=2)
    tr = _trainer(problem, tcfg, str(tmp_path))
    net, _, _ = tr.train_step1(ds.y_data, ds.e_data, _gen(), 4)
    d = os.path.join(tmp_path, "step1")
    assert sorted(n.split("-")[0] for n in os.listdir(d) if n != "latest.pt") == ["01", "03"]
    with open(os.path.join(d, "latest.pt"), "r+b") as f:
        f.truncate(100)
    tr2 = _trainer(problem, TrainConfig(**TCFG, ckpt_every=1), str(tmp_path))
    assert tr2._lr_decay(tr2.optimizer_step1(net), np.array([np.nan, 1.0, np.nan]), 2, 5.0) is False
    resumed, hist, _ = tr2.train_step1(ds.y_data, ds.e_data, _gen(), 5, resume=True)
    assert np.isnan(hist[[0, 2]]).all() and np.isfinite(hist[[1, 3, 4]]).all()
    assert hist[4] > 0.0  # so a 0.0 in slot 2 would have fired the decay
    bundle = torch.load(os.path.join(d, "latest.pt"), weights_only=True)
    assert bundle["epoch"] == 4
    assert all(g["lr"] == tcfg.lr for g in bundle["opt"]["param_groups"])


def test_checkpoint_cadence(problem, tmp_path):
    """Numbered files every ``num_epochs // 5`` epochs, or every
    ``ckpt_every``; step 2 also banks its last epoch."""
    ds = problem[3]
    y, e = ds.y_data[:32], ds.e_data
    for every, want in ((0, ["01", "03", "05", "07", "09"]), (3, ["02", "05", "08"])):
        path = str(tmp_path / f"every{every}")
        tr = _trainer(problem, TrainConfig(**TCFG, ckpt_every=every), path)
        net, _, _ = tr.train_step1(y, e, _gen(), 10)
        names = sorted(os.listdir(os.path.join(path, "step1")))
        assert [n.split("-")[0] for n in names if n != "latest.pt"] == want
        assert "latest.pt" in names
        lm, ls = tr.bridge(y, e, net, _gen())
        tr.train_step2(y, e, net, lm, ls, _gen(), 4)
        steps2 = sorted(n.split("-")[0] for n in os.listdir(os.path.join(path, "step2"))
                        if n != "latest.pt")
        assert steps2[-1] == "03"
