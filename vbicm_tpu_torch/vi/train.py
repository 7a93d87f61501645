"""Two-step VI trainer (counterpart of ``vbicm_tpu/vi/train.py``, mean-field
posterior).

  step 1: fit q(theta|y) by the reparameterized ELBO with the FEM inside the
          likelihood, Adam(lr, betas=(0.99, 0.999), eps=1e-10);
  bridge: push posterior samples for every y through one batched FEM sweep
          and cache the log-z moments;
  step 2: fit the lognormal predictive p(z|y) with the step-1 net frozen,
          Adam(lr, betas=(0.9, 0.999), eps=1e-7).

optax's and torch's Adam both add eps outside the square root,
``lr * m_hat / (sqrt(v_hat) + eps)``, so the two packages take the same
steps. As in the reference, the history holds each epoch's last-batch loss,
and ``lr_decay_mode="reference"`` reproduces its check of a not-yet-written
history slot. One epoch is a Python loop over batches; ``update_step1`` and
``update_step2`` are the one-batch updates.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..config import ProblemConfig, TrainConfig
from ..model import FemModel
from ..models.mlp import ThetaPosteriorNet, ZPredictiveNet
from ..solver import make_fh_fun
from ..utils.draws import draw_normal
from .elbo import make_loss_step1, make_loss_step2

# TrainConfig fields this package does not implement yet: the only value it
# accepts, and the ROADMAP Queue 1 item that ports the rest.
_NOT_PORTED = {
    "posterior": ("meanfield", 4),
    "ckpt_every": (0, 2),
    "ckpt_chunk": (False, 2),
    "clip_grad_norm": (None, 2),
    "resample_e": (False, 4),
}


@dataclasses.dataclass
class TrainResult:
    theta_net: ThetaPosteriorNet
    z_net: ZPredictiveNet
    hist_step1: np.ndarray
    hist_step2: np.ndarray
    logz_mean_post: np.ndarray
    logz_sig_post: np.ndarray
    # host wall time per epoch, each ending in a device sync (the epoch's
    # loss is read back)
    epoch_times_step1: List[float] = dataclasses.field(default_factory=list)
    epoch_times_step2: List[float] = dataclasses.field(default_factory=list)


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
        verbose: bool = False,
        fh_batch: Optional[Callable] = None,
        y_norm=None,
        bridge_chunk: int = 4096,
    ):
        """``device`` defaults to the model's. ``fh_batch`` overrides the
        batched observation operator ``thetas (B, 2) -> (y, h)``.

        ``y_norm=(mean, std)`` bakes frozen input standardization into both
        nets (``models.mlp``); ``None`` keeps the reference's raw inputs.
        ``bridge_chunk`` bounds the batch of the bridge's FEM sweep over the
        n * ne posterior samples."""
        for field, (accepted, item) in _NOT_PORTED.items():
            if getattr(tcfg, field) != accepted:
                raise NotImplementedError(
                    f"TrainConfig.{field}={getattr(tcfg, field)!r} is not ported yet "
                    f"(only {accepted!r}); ROADMAP Queue 1 item {item}"
                )
        if tcfg.pairing not in ("cross", "per_sample"):
            raise ValueError(f"unknown pairing {tcfg.pairing!r}")
        if device is None:
            if model is None:
                raise ValueError("pass device= when no model is given")
            device = model.device
        self.device = torch.device(device)
        self.cfg = cfg
        self.tcfg = tcfg
        self.dtype = dtype
        self.verbose = verbose
        self.bridge_chunk = int(bridge_chunk)
        self.y_shift = self.y_scale = None
        if y_norm is not None:
            self.y_shift = tuple(float(v) for v in np.asarray(y_norm[0]).ravel())
            self.y_scale = tuple(float(v) for v in np.asarray(y_norm[1]).ravel())
        if fh_batch is None:
            fh_batch = make_fh_fun(model, cfg, factor_dtype=factor_dtype, refine_iters=refine_iters)
        self._batch_fh = fh_batch

    # ------------------------------------------------------------------
    def new_theta_net(self, generator: torch.Generator) -> ThetaPosteriorNet:
        net = ThetaPosteriorNet(self.cfg.y_dim, self.tcfg.num_neuron, self.tcfg.num_layers1,
                                self.cfg.theta_dim, dtype=self.dtype, device=self.device,
                                y_shift=self.y_shift, y_scale=self.y_scale)
        net.reset_parameters(generator)
        return net

    def new_z_net(self, generator: torch.Generator) -> ZPredictiveNet:
        net = ZPredictiveNet(self.cfg.y_dim, self.tcfg.num_neuron, self.tcfg.num_layers2,
                             self.cfg.z_dim, dtype=self.dtype, device=self.device,
                             y_shift=self.y_shift, y_scale=self.y_scale)
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
        ``0.0 - hist[epoch - lr_patience]``."""
        t = self.tcfg
        if not t.flg_lr_decay or epoch % t.lr_patience != 0 or epoch == 0:
            return False
        current = 0.0 if t.lr_decay_mode == "reference" else loss_val
        fire = (current - hist[epoch - t.lr_patience]) > 0
        if fire:
            for group in opt.param_groups:
                group["lr"] *= t.decay_rate
        return bool(fire)

    def _epochs(self, n, num_epochs, generator, update, opt, label):
        """Run ``num_epochs`` shuffled epochs of ``update(index_batch)``;
        returns (history, per-epoch seconds)."""
        bs = self.tcfg.batch_size
        hist = np.zeros(num_epochs)
        times = []
        for epoch in range(num_epochs):
            tic = time.perf_counter()
            perm = torch.randperm(n, generator=generator).to(self.device)
            for start in range(0, n, bs):
                loss = update(perm[start : start + bs])
            loss_val = float(loss)
            times.append(time.perf_counter() - tic)
            if self.verbose:
                print(f"[{label}] epoch {epoch}: loss {loss_val:.6e} ({times[-1]:.2f}s)")
            hist[epoch] = loss_val
            self._lr_decay(opt, hist, epoch, loss_val)
        return hist, times

    # ------------------------------------------------------------------
    def update_step1(self, theta_net, opt, y_batch, e_data):
        """One Adam step of step 1 on one batch; returns the batch loss."""
        loss_fn = make_loss_step1(lambda th: self._batch_fh(th)[0], e_data,
                                  self.cfg.sig_e, self.tcfg.pairing)
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(y_batch, theta_net(y_batch))
        loss.backward()
        opt.step()
        return loss.detach()

    def train_step1(self, y_data, e_data, generator, num_epochs=None, theta_net=None):
        """Fit q(theta|y). Returns (theta_net, loss history, epoch seconds)."""
        num_epochs = self.tcfg.num_epoch1 if num_epochs is None else num_epochs
        y_data, e_data = self._tensor(y_data), self._tensor(e_data)
        net = self.new_theta_net(generator) if theta_net is None else theta_net
        opt = self.optimizer_step1(net)
        hist, times = self._epochs(
            y_data.shape[0], num_epochs, generator,
            lambda idx: self.update_step1(net, opt, y_data[idx], e_data), opt, "step1")
        return net, hist, times

    # ------------------------------------------------------------------
    def bridge(self, y_data, e_data, theta_net, generator):
        """Posterior-sample sweep -> cached log-z moments (mean, variance)."""
        chunk = self.bridge_chunk
        y_data, e_data = self._tensor(y_data), self._tensor(e_data)
        n, ne = y_data.shape[0], e_data.shape[0]
        with torch.no_grad():
            theta_mean, theta_sig, _ = theta_net(y_data)
            theta_sam = e_data[None, :, :] * torch.sqrt(theta_sig)[:, None, :] + theta_mean[:, None, :]
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
    def update_step2(self, theta_net, z_net, opt, y_b, lm_b, ls_b, e_data):
        """One Adam step of step 2 on one batch; returns the batch loss.
        The theta net and the FEM are frozen: they run without autograd."""

        def batch_h(th):
            with torch.no_grad():
                return self._batch_fh(th)[1]

        loss_fn = make_loss_step2(batch_h, e_data, self.cfg.sig_eta, self.tcfg.alpha,
                                  self.tcfg.pairing)
        with torch.no_grad():
            theta_mean, theta_sig, _ = theta_net(y_b)
        opt.zero_grad(set_to_none=True)
        z_mean, z_sig, log_z_sig = z_net(y_b)
        loss = loss_fn((y_b, lm_b, ls_b), (theta_mean, theta_sig, z_mean, z_sig, log_z_sig))
        loss.backward()
        opt.step()
        return loss.detach()

    def train_step2(self, y_data, e_data, theta_net, logz_mean_post, logz_sig_post, generator,
                    num_epochs=None, z_net=None):
        """Fit p(z|y) with the theta net frozen. Returns (z_net, history,
        epoch seconds)."""
        num_epochs = self.tcfg.num_epoch2 if num_epochs is None else num_epochs
        y_data, e_data = self._tensor(y_data), self._tensor(e_data)
        lm_post, ls_post = self._tensor(logz_mean_post), self._tensor(logz_sig_post)
        net = self.new_z_net(generator) if z_net is None else z_net
        opt = self.optimizer_step2(net)
        hist, times = self._epochs(
            y_data.shape[0], num_epochs, generator,
            lambda idx: self.update_step2(theta_net, net, opt, y_data[idx], lm_post[idx],
                                          ls_post[idx], e_data),
            opt, "step2")
        return net, hist, times

    # ------------------------------------------------------------------
    def fit(self, y_data, e_data, generator, *, epochs1=None, epochs2=None) -> TrainResult:
        """Step 1, bridge, step 2; every draw comes from ``generator``."""
        theta_net, hist1, times1 = self.train_step1(y_data, e_data, generator, epochs1)
        lm_post, ls_post = self.bridge(y_data, e_data, theta_net, generator)
        z_net, hist2, times2 = self.train_step2(y_data, e_data, theta_net, lm_post, ls_post,
                                                generator, epochs2)
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
    def predict(self, theta_net, z_net, y):
        """(theta_mean, theta_sig, z_mean, z_sig) for observations y."""
        y = self._tensor(y)
        with torch.no_grad():
            theta_mean, theta_sig, _ = theta_net(y)
            z_mean, z_sig, _ = z_net(y)
        return theta_mean, theta_sig, z_mean, z_sig

    def sample_theta(self, theta_net, y, e):
        """Posterior draws theta ~ q(.|y) from base noise ``e (ne, d)``:
        (B, ne, d), differentiable in the net's weights. The sampling
        surface of the evaluation (comparison, refinement warm starts), so
        that it need not know the posterior's parameterization; only the
        mean-field family is ported (the trainer refuses the others)."""
        y, e = self._tensor(y), self._tensor(e)
        theta_mean, theta_sig, _ = theta_net(y)
        return e[None, :, :] * torch.sqrt(theta_sig)[:, None, :] + theta_mean[:, None, :]

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
