"""Two-step VI trainer (counterpart of ``vbicm_tpu/vi/train.py``).

  step 1: fit q(theta|y) by the reparameterized ELBO with the FEM inside the
          likelihood, Adam(lr, betas=(0.99, 0.999), eps=1e-10);
  bridge: push posterior samples for every y through one batched FEM sweep
          and cache the log-z moments;
  step 2: fit the lognormal predictive p(z|y) with the step-1 net frozen,
          Adam(lr, betas=(0.9, 0.999), eps=1e-7).

Posterior families (``TrainConfig.posterior``): "meanfield" (the
reference's), "fullcov" (q = N(mu, L L^T), ``models.mlp``) and "flow" (the
coupling flow of ``models.flow``, which draws its samples inside the net);
the latter two need ``pairing="per_sample"``.

optax's and torch's Adam both add eps outside the square root,
``lr * m_hat / (sqrt(v_hat) + eps)``, so the two packages take the same
steps. ``clip_grad_norm`` clips by the global norm with optax's rule before
Adam. As in the reference, the history holds each epoch's last-batch loss,
and ``lr_decay_mode="reference"`` reproduces its check of a not-yet-written
history slot. One epoch is a Python loop over batches; ``update_step1`` and
``update_step2`` are the one-batch updates. Every draw comes from the
caller's ``torch.Generator``: an epoch draws its permutation and then, with
``resample_e``, all its batches' base draws in one call.

Checkpoints (``results_path``): numbered net weights ``{epoch:02d}-
{loss:.8f}.pt`` every ``ckpt_every`` epochs (else ``num_epochs // 5``), and a
``latest.pt`` bundle (net and Adam state, epoch, batches done, history, the
generator's state) from which ``resume=True`` continues the uninterrupted
run's exact trajectory. With ``ckpt_chunk`` a bundle is also written after
every ``scan_chunk`` batches of an epoch. The bundle's generator state is
the one the resumed run goes on from: the epoch's start for a mid-epoch
bundle (the epoch's draws are made again and its banked batches skipped),
the epoch's end for an epoch bundle. Unlike the JAX package, a resume never
applies a banked batch twice (a partial final chunk is skipped by
``min(s + ck, n_full)``), history slots that the numbered-file fallback
cannot rebuild hold NaN (so fixed-mode lr decay does not fire against them),
and the lr decay of an epoch is applied before its bundle is written.
"""
from __future__ import annotations

import dataclasses
import math
import os
import pickle
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..config import ProblemConfig, TrainConfig
from ..model import FemModel
from ..models.flow import ThetaPosteriorFlowNet, flow_moments
from ..models.mlp import (
    ThetaPosteriorFullCovNet,
    ThetaPosteriorNet,
    ZPredictiveNet,
    marginal_variance,
)
from ..solver import make_fh_fun
from ..utils.draws import draw_normal
from ..utils.trace import span
from .elbo import make_loss_step1, make_loss_step1_flow, make_loss_step1_fullcov, make_loss_step2

_FAMILIES = ("meanfield", "fullcov", "flow")
# what torch.load raises on a truncated (RuntimeError), empty (EOFError) or
# garbled (KeyError, UnpicklingError) file
_UNREADABLE = (RuntimeError, EOFError, KeyError, pickle.UnpicklingError)


@dataclasses.dataclass
class TrainResult:
    theta_net: torch.nn.Module
    z_net: ZPredictiveNet
    hist_step1: np.ndarray
    hist_step2: np.ndarray
    logz_mean_post: np.ndarray
    logz_sig_post: np.ndarray
    # host wall time per epoch, each ending in a device sync (the epoch's
    # loss is read back)
    epoch_times_step1: List[float] = dataclasses.field(default_factory=list)
    epoch_times_step2: List[float] = dataclasses.field(default_factory=list)


def _atomic_save(obj, path):
    """``torch.save`` to a temporary file, fsync, then ``os.replace``, so that
    a crash mid-write never leaves a truncated file at ``path``."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.save(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


@dataclasses.dataclass
class _Resume:
    """Where a restored run goes on: epoch ``epoch`` after ``batch`` of its
    batches, with history ``hist`` and the generator state to go on from
    (None after the numbered-file fallback: the caller replays the draws)."""

    epoch: int
    batch: int
    hist: np.ndarray
    generator_state: Optional[torch.Tensor]


class TwoStepTrainer:
    def __init__(
        self,
        model: Optional[FemModel],
        cfg: ProblemConfig = ProblemConfig(),
        tcfg: TrainConfig = TrainConfig(),
        *,
        factor_dtype=None,
        refine_iters: int = 0,
        device=None,
        dtype=torch.float64,
        results_path: Optional[str] = None,
        verbose: bool = False,
        fh_batch: Optional[Callable] = None,
        y_norm=None,
        bridge_chunk: int = 4096,
    ):
        """``device`` defaults to the model's. ``fh_batch`` overrides the
        batched observation operator ``thetas (B, 2) -> (y, h)``.
        ``results_path`` is where checkpoints (and the bridge's targets)
        are written; ``None`` writes nothing.

        ``y_norm=(mean, std)`` bakes frozen input standardization into both
        nets (``models.mlp``); ``None`` keeps the reference's raw inputs.
        ``bridge_chunk`` bounds the batch of the bridge's FEM sweep over the
        n * ne posterior samples."""
        if tcfg.pairing not in ("cross", "per_sample"):
            raise ValueError(f"unknown pairing {tcfg.pairing!r}")
        if tcfg.posterior not in _FAMILIES:
            raise ValueError(f"unknown posterior family {tcfg.posterior!r}")
        self.fullcov = tcfg.posterior == "fullcov"
        self.flow = tcfg.posterior == "flow"
        if (self.fullcov or self.flow) and tcfg.pairing != "per_sample":
            raise ValueError(f'posterior="{tcfg.posterior}" requires pairing="per_sample" (the '
                             "cross-pairing broadcast is a mean-field reference quirk)")
        if device is None:
            if model is None:
                raise ValueError("pass device= when no model is given")
            device = model.device
        self.device = torch.device(device)
        self.cfg = cfg
        self.tcfg = tcfg
        self.dtype = dtype
        self.results_path = results_path
        self.verbose = verbose
        self.bridge_chunk = int(bridge_chunk)
        # the global gradient norm before clipping of the last update (with
        # clip_grad_norm; a device scalar)
        self.last_grad_norm = None
        self.y_shift = self.y_scale = None
        if y_norm is not None:
            self.y_shift = tuple(float(v) for v in np.asarray(y_norm[0]).ravel())
            self.y_scale = tuple(float(v) for v in np.asarray(y_norm[1]).ravel())
        if fh_batch is None:
            fh_batch = make_fh_fun(model, cfg, factor_dtype=factor_dtype, refine_iters=refine_iters)
        self._batch_fh = fh_batch

    # ------------------------------------------------------------------
    def _net_kw(self):
        return dict(dtype=self.dtype, device=self.device, y_shift=self.y_shift,
                    y_scale=self.y_scale)

    def new_theta_net(self, generator: torch.Generator) -> torch.nn.Module:
        """The posterior net of ``tcfg.posterior``, initialized from
        ``generator``."""
        t, c = self.tcfg, self.cfg
        if self.flow:
            net = ThetaPosteriorFlowNet(c.y_dim, t.num_neuron, t.num_layers1, c.theta_dim,
                                        n_couplings=t.flow_couplings, s_cap=t.flow_s_cap,
                                        **self._net_kw())
        else:
            cls = ThetaPosteriorFullCovNet if self.fullcov else ThetaPosteriorNet
            net = cls(c.y_dim, t.num_neuron, t.num_layers1, c.theta_dim, **self._net_kw())
        net.reset_parameters(generator)
        return net

    def new_z_net(self, generator: torch.Generator) -> ZPredictiveNet:
        net = ZPredictiveNet(self.cfg.y_dim, self.tcfg.num_neuron, self.tcfg.num_layers2,
                             self.cfg.z_dim, **self._net_kw())
        net.reset_parameters(generator)
        return net

    def optimizer_step1(self, theta_net) -> torch.optim.Adam:
        return torch.optim.Adam(theta_net.parameters(), lr=self.tcfg.lr,
                                betas=(0.99, 0.999), eps=1e-10)

    def optimizer_step2(self, z_net) -> torch.optim.Adam:
        return torch.optim.Adam(z_net.parameters(), lr=self.tcfg.lr,
                                betas=(0.9, 0.999), eps=1e-7)

    def _tensor(self, x):
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def _lr_decay(self, opt, hist, epoch, loss_val) -> bool:
        """Reference or fixed decay-on-plateau; scales every param group's
        lr by ``decay_rate`` when it fires. The reference reads the current
        epoch's history slot before writing it, so its comparison is
        ``0.0 - hist[epoch - lr_patience]``. A NaN slot (not rebuilt after a
        resume from a numbered file) never fires."""
        t = self.tcfg
        if not t.flg_lr_decay or epoch % t.lr_patience != 0 or epoch == 0:
            return False
        current = 0.0 if t.lr_decay_mode == "reference" else loss_val
        fire = (current - hist[epoch - t.lr_patience]) > 0
        if fire:
            for group in opt.param_groups:
                group["lr"] *= t.decay_rate
        return bool(fire)

    def _step(self, loss, params, opt):
        """Backward, optax's global-norm clip, then Adam."""
        with span("train.backward"):
            loss.backward()
        with span("train.optimizer"):
            max_norm = self.tcfg.clip_grad_norm
            if max_norm is not None:
                grads = [p.grad for p in params if p.grad is not None]
                norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                keep = norm < max_norm
                for g in grads:
                    g.copy_(torch.where(keep, g, (g / norm) * max_norm))
                self.last_grad_norm = norm
            opt.step()
        return loss.detach()

    # ------------------------------------------------------------------
    # checkpoints
    def _ckpt_dir(self, subdir):
        return os.path.join(self.results_path, subdir)

    def _save_ckpt(self, subdir, epoch, loss, net, opt, hist, generator_state, batches_done=0):
        """The ``latest.pt`` bundle, and with ``batches_done == 0`` (a
        completed epoch) the numbered weights file ``{epoch:02d}-
        {loss:.8f}.pt`` too."""
        if self.results_path is None:
            return
        d = self._ckpt_dir(subdir)
        os.makedirs(d, exist_ok=True)
        if batches_done == 0:
            _atomic_save(net.state_dict(), os.path.join(d, f"{epoch:02d}-{loss:.8f}.pt"))
        _atomic_save({"net": net.state_dict(), "opt": opt.state_dict(), "epoch": epoch,
                      "batches_done": batches_done, "hist": torch.as_tensor(hist),
                      "generator": generator_state},
                     os.path.join(d, "latest.pt"))

    def _load_numbered_fallback(self, subdir, net):
        """Restore ``net`` from the newest readable numbered weights file;
        returns (its epoch, the history rebuilt from the file names, NaN
        where no file is) or None when none reads."""
        recs = []
        for name in os.listdir(self._ckpt_dir(subdir)):
            stem, _, ext = name.rpartition(".")
            if ext != "pt" or "-" not in stem:
                continue
            ep_s, _, loss_s = stem.partition("-")
            try:
                recs.append((int(ep_s), float(loss_s), name))
            except ValueError:
                continue
        for ep, _, name in sorted(recs, reverse=True):
            try:
                state = torch.load(os.path.join(self._ckpt_dir(subdir), name),
                                   map_location="cpu", weights_only=True)
            except _UNREADABLE:
                continue
            net.load_state_dict(state)
            hist = np.full(ep + 1, np.nan)
            for e2, loss2, _ in recs:
                if e2 <= ep:
                    hist[e2] = loss2
            return ep, hist
        return None

    def load_ckpt(self, subdir, net, opt) -> Optional[_Resume]:
        """Restore ``net`` and ``opt`` in place from the ``latest.pt`` bundle
        under ``results_path/subdir``; returns where the run goes on, or None
        when there is no bundle. An unreadable bundle falls back to the
        newest numbered weights file: the weights exact, Adam's state fresh,
        the history rebuilt from the file names."""
        if self.results_path is None:
            return None
        path = os.path.join(self._ckpt_dir(subdir), "latest.pt")
        if not os.path.exists(path):
            return None
        try:
            # on the CPU: Adam keeps a non-capturable step count there
            state = torch.load(path, map_location="cpu", weights_only=True)
        except _UNREADABLE:
            fb = self._load_numbered_fallback(subdir, net)
            if fb is None:
                raise
            epoch, hist = fb
            print(f"[ckpt] {path} unreadable; fell back to epoch {epoch}'s weights file "
                  "(optimizer state reset)")
            return _Resume(epoch + 1, 0, hist, None)
        net.load_state_dict(state["net"])
        opt.load_state_dict(state["opt"])
        hist = state["hist"].numpy()
        bd = int(state["batches_done"])
        epoch = int(state["epoch"]) + (0 if bd > 0 else 1)
        return _Resume(epoch, bd, hist, state["generator"])

    # ------------------------------------------------------------------
    def _epoch_draws(self, n, ne, generator):
        """One epoch's draws: the permutation, then with ``resample_e`` every
        batch's ne base draws, (n_batches, ne, d), in one call (None
        without)."""
        perm = torch.randperm(n, generator=generator).to(self.device)
        e_all = None
        if self.tcfg.resample_e:
            n_batches = -(-n // self.tcfg.batch_size)
            e_all = draw_normal(generator, (n_batches, ne, self.cfg.theta_dim), self.dtype,
                                self.device)
        return perm, e_all

    def _epochs(self, n, ne, num_epochs, generator, update, net, opt, subdir, resume):
        """Run the epochs of one step over n observations with ne base draws
        each: ``update(index_batch, e)`` a batch, with checkpoints under
        ``subdir`` and, with ``resume``, from the latest one. Returns
        (history, per-epoch seconds)."""
        t = self.tcfg
        bs = t.batch_size
        hist = np.zeros(num_epochs)
        start_epoch = start_batch = 0
        restored = self.load_ckpt(subdir, net, opt) if resume else None
        if restored is not None:
            start_epoch, start_batch = restored.epoch, restored.batch
            k = min(len(restored.hist), num_epochs)
            hist[:k] = restored.hist[:k]
            if restored.generator_state is not None:
                generator.set_state(restored.generator_state)
            else:  # replay the completed epochs' draws
                for _ in range(start_epoch):
                    self._epoch_draws(n, ne, generator)
        save_freq = t.ckpt_every if t.ckpt_every > 0 else max(1, num_epochs // 5)
        n_full, rem = divmod(n, bs)
        # the JAX package's chunked scan: a bundle after every scan_chunk
        # batches (and after the last full batch when a partial one follows)
        ck = t.scan_chunk if t.scan_chunk > 0 else n_full
        chunked = (t.ckpt_chunk and t.scan_epochs and n_full > 1 and self.results_path is not None)
        times = []
        for epoch in range(start_epoch, num_epochs):
            tic = time.perf_counter()
            epoch_state = generator.get_state()
            perm, e_all = self._epoch_draws(n, ne, generator)
            first = start_batch if epoch == start_epoch else 0
            for b in range(first, n_full + (1 if rem else 0)):
                loss = update(perm[b * bs : (b + 1) * bs], None if e_all is None else e_all[b])
                done = b + 1
                if chunked and done <= n_full and (done % ck == 0 or done == n_full) and (
                        done < n_full or rem):
                    self._save_ckpt(subdir, epoch, float(loss), net, opt, hist, epoch_state,
                                    batches_done=done)
            loss_val = float(loss)
            times.append(time.perf_counter() - tic)
            if self.verbose:
                print(f"[{subdir}] epoch {epoch}: loss {loss_val:.6e} ({times[-1]:.2f}s)")
            hist[epoch] = loss_val
            self._lr_decay(opt, hist, epoch, loss_val)
            if (epoch + 1) % save_freq == 0 or (subdir == "step2" and epoch == num_epochs - 1):
                # step 2's last epoch always: a killed run resumes exactly
                self._save_ckpt(subdir, epoch, loss_val, net, opt, hist, generator.get_state())
        return hist, times

    # ------------------------------------------------------------------
    def _theta_draws(self, theta_net, y, e):
        """(B, ne, d) posterior draws from base draws e: the family's
        reparameterization (the flow's inside the net)."""
        if self.flow:
            return theta_net(y, e)[0]
        theta_mean, theta_sig, _ = theta_net(y)
        if self.fullcov:
            return theta_mean[:, None, :] + torch.einsum("bij,nj->bni", theta_sig, e)
        return e[None, :, :] * torch.sqrt(theta_sig)[:, None, :] + theta_mean[:, None, :]

    def update_step1(self, theta_net, opt, y_batch, e_data, e=None):
        """One (clipped) Adam step of step 1 on one batch; returns the batch
        loss. ``e`` replaces ``e_data`` as this batch's base draws. Spans
        (``utils.trace``): ``train.step`` holding ``train.loss``,
        ``train.backward`` and ``train.optimizer`` (the clip and Adam)."""
        batch_f = lambda th: self._batch_fh(th)[0]  # noqa: E731
        with span("train.step"):
            opt.zero_grad(set_to_none=True)
            with span("train.loss"):
                if self.flow:
                    loss = make_loss_step1_flow(batch_f, self.cfg.sig_e)(
                        y_batch, theta_net(y_batch, e_data if e is None else e))
                else:
                    loss_fn = (make_loss_step1_fullcov(batch_f, e_data, self.cfg.sig_e)
                               if self.fullcov else
                               make_loss_step1(batch_f, e_data, self.cfg.sig_e,
                                               self.tcfg.pairing))
                    loss = loss_fn(y_batch, theta_net(y_batch), e)
            return self._step(loss, theta_net.parameters(), opt)

    def train_step1(self, y_data, e_data, generator, num_epochs=None, theta_net=None,
                    resume=False):
        """Fit q(theta|y). Returns (theta_net, loss history, epoch seconds).
        ``resume=True`` goes on from the latest bundle under
        ``results_path/step1``, if there is one."""
        num_epochs = self.tcfg.num_epoch1 if num_epochs is None else num_epochs
        y_data, e_data = self._tensor(y_data), self._tensor(e_data)
        net = self.new_theta_net(generator) if theta_net is None else theta_net
        opt = self.optimizer_step1(net)
        hist, times = self._epochs(
            y_data.shape[0], e_data.shape[0], num_epochs, generator,
            lambda idx, e: self.update_step1(net, opt, y_data[idx], e_data, e),
            net, opt, "step1", resume)
        return net, hist, times

    # ------------------------------------------------------------------
    def bridge(self, y_data, e_data, theta_net, generator):
        """Posterior-sample sweep -> cached log-z moments (mean, variance)."""
        chunk = self.bridge_chunk
        y_data, e_data = self._tensor(y_data), self._tensor(e_data)
        n, ne = y_data.shape[0], e_data.shape[0]
        with torch.no_grad():
            theta_sam = self._theta_draws(theta_net, y_data, e_data)
            theta_sam = theta_sam.reshape(-1, theta_sam.shape[-1])
            hs = [self._batch_fh(theta_sam[i : i + chunk])[1]
                  for i in range(0, theta_sam.shape[0], chunk)]
            h_sam = torch.cat(hs).reshape(n, ne, -1)
            # one (ne, d_z) noise matrix shared by every y, as the reference
            eta = math.sqrt(self.cfg.sig_eta) * torch.randn(
                (ne, h_sam.shape[-1]), generator=generator, dtype=self.dtype)
            logz = torch.log(h_sam + eta.to(self.device)[None, :, :])
            mean = logz.mean(dim=1)
            var = logz.var(dim=1, correction=0)
        return mean.cpu().numpy(), var.cpu().numpy()

    # ------------------------------------------------------------------
    def update_step2(self, theta_net, z_net, opt, y_b, lm_b, ls_b, e_data, e=None):
        """One (clipped) Adam step of step 2 on one batch; returns the batch
        loss. The theta net and the FEM are frozen: they run without
        autograd. ``e`` replaces ``e_data`` as this batch's base draws."""

        def batch_h(th):
            with torch.no_grad():
                return self._batch_fh(th)[1]

        loss_fn = make_loss_step2(batch_h, e_data, self.cfg.sig_eta, self.tcfg.alpha,
                                  self.tcfg.pairing, fullcov=self.fullcov, flow=self.flow)
        with torch.no_grad():
            if self.flow:
                theta_sam = theta_net(y_b, e_data if e is None else e)[0]
                theta_out = (theta_sam.reshape(-1, theta_sam.shape[-1]),)
            else:
                theta_out = theta_net(y_b)[:2]
        opt.zero_grad(set_to_none=True)
        z_mean, z_sig, log_z_sig = z_net(y_b)
        loss = loss_fn((y_b, lm_b, ls_b), (*theta_out, z_mean, z_sig, log_z_sig), e)
        return self._step(loss, z_net.parameters(), opt)

    def train_step2(self, y_data, e_data, theta_net, logz_mean_post, logz_sig_post, generator,
                    num_epochs=None, z_net=None, resume=False):
        """Fit p(z|y) with the theta net frozen. Returns (z_net, history,
        epoch seconds). ``resume=True`` goes on from the latest bundle under
        ``results_path/step2``, if there is one."""
        num_epochs = self.tcfg.num_epoch2 if num_epochs is None else num_epochs
        y_data, e_data = self._tensor(y_data), self._tensor(e_data)
        lm_post, ls_post = self._tensor(logz_mean_post), self._tensor(logz_sig_post)
        net = self.new_z_net(generator) if z_net is None else z_net
        opt = self.optimizer_step2(net)
        hist, times = self._epochs(
            y_data.shape[0], e_data.shape[0], num_epochs, generator,
            lambda idx, e: self.update_step2(theta_net, net, opt, y_data[idx], lm_post[idx],
                                             ls_post[idx], e_data, e),
            net, opt, "step2", resume)
        return net, hist, times

    # ------------------------------------------------------------------
    def fit(self, y_data, e_data, generator, *, epochs1=None, epochs2=None,
            resume=False) -> TrainResult:
        """Step 1, bridge, step 2; every draw comes from ``generator``.
        ``resume=True`` goes on from each step's latest bundle: a step-1
        bundle restores the generator before the bridge, so the bridge draws
        what the uninterrupted run drew. With ``results_path`` the bridge's
        targets are also written to ``temp_data.mat``, as the reference's."""
        theta_net, hist1, times1 = self.train_step1(y_data, e_data, generator, epochs1,
                                                    resume=resume)
        lm_post, ls_post = self.bridge(y_data, e_data, theta_net, generator)
        if self.results_path is not None:
            import scipy.io

            os.makedirs(self.results_path, exist_ok=True)
            scipy.io.savemat(os.path.join(self.results_path, "temp_data.mat"),
                             {"logz_mean_post": lm_post, "logz_sig_post": ls_post})
        z_net, hist2, times2 = self.train_step2(y_data, e_data, theta_net, lm_post, ls_post,
                                                generator, epochs2, resume=resume)
        return TrainResult(
            theta_net=theta_net,
            z_net=z_net,
            hist_step1=hist1,
            hist_step2=hist2,
            logz_mean_post=lm_post,
            logz_sig_post=ls_post,
            epoch_times_step1=times1,
            epoch_times_step2=times2,
        )

    # ------------------------------------------------------------------
    def predict(self, theta_net, z_net, y, *, generator=None, n_mc=256):
        """(theta_mean, theta_sig, z_mean, z_sig) for observations y. With
        the full-covariance posterior theta_sig is the marginal variance
        diag(L L^T) (:meth:`predict_cholesky` gives L); with the flow the
        theta moments are ``n_mc``-sample Monte-Carlo estimates, the base
        draws from ``generator`` (default: a CPU generator seeded 0)."""
        y = self._tensor(y)
        with torch.no_grad():
            if self.flow:
                generator = torch.Generator().manual_seed(0) if generator is None else generator
                theta_mean, theta_sig = flow_moments(theta_net, y, generator, n_mc=n_mc)
            else:
                theta_mean, theta_sig, _ = theta_net(y)
                if self.fullcov:
                    theta_sig = marginal_variance(theta_sig)
            z_mean, z_sig, _ = z_net(y)
        return theta_mean, theta_sig, z_mean, z_sig

    def predict_cholesky(self, theta_net, y):
        """(theta_mean, L) of the full-covariance posterior."""
        if not self.fullcov:
            raise ValueError("predict_cholesky requires posterior='fullcov'")
        with torch.no_grad():
            theta_mean, L, _ = theta_net(self._tensor(y))
        return theta_mean, L

    def sample_theta(self, theta_net, y, e):
        """Posterior draws theta ~ q(.|y) from base noise ``e (ne, d)``:
        (B, ne, d), differentiable in the net's weights, for every family.
        The sampling surface of the evaluation (comparison, refinement warm
        starts), so that it need not know the posterior's
        parameterization."""
        return self._theta_draws(theta_net, self._tensor(y), self._tensor(e))

    def theta_sampler(self, theta_net, y):
        """``sampler(generator, num_sam) -> theta (n_y, num_sam, d)`` for the
        ``proposed_sampler`` hook of ``eval.comparison.kld_maps`` and
        ``mean_sig_fields``: exact posterior draws, the base noise from
        ``generator``."""
        y = self._tensor(y)

        def sampler(generator, num_sam):
            e = draw_normal(generator, (num_sam, self.cfg.theta_dim), self.dtype, self.device)
            return self.sample_theta(theta_net, y, e)

        return sampler
