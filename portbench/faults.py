"""Faults planted under the timed path, to show that the comparison that
decides ``correct`` catches them (``test_portbench_faults.py`` on the CPU,
``calibrate.py --faults`` on the card). Each is a context manager that
patches the port for the block and restores it after.

- ``unchanged``: a step returns its state unchanged (the optimizer does
  not step; the observation operator returns zeros);
- ``half_batch``: half of the batch is left out (the loss is the mean over
  the first half of the observations; half the lanes of every solve are
  left at zero);
- ``altered``: an answer is altered where it is produced (the first lane's
  displacement of every solve off by one part in a thousand).
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patch(obj, name, make):
    old = getattr(obj, name)
    setattr(obj, name, make(old))
    try:
        yield
    finally:
        setattr(obj, name, old)


def _fh_patch(transform):
    """Patch ``make_fh_fun`` so that every fh it builds passes its (y, h)
    through ``transform``."""
    import vbicm_tpu_torch.solver as solver_mod

    def make(old):
        def make_fh_fun(*a, **kw):
            fh = old(*a, **kw)
            return lambda thetas: transform(thetas, *fh(thetas))

        return make_fh_fun

    return _patch(solver_mod, "make_fh_fun", make)


def _altered(thetas, y, h):
    y = y.clone()
    y[0] = y[0] * (1 + 1e-3)
    return y, h


def _half_lanes(thetas, y, h):
    keep = torch.arange(y.shape[0], device=y.device) < (y.shape[0] + 1) // 2
    return y * keep[:, None], h * keep[:, None]


@contextlib.contextmanager
def plant(kind: str, fault: str):
    """Plant ``fault`` under the timed path of a ``kind`` ("train",
    "datagen") cell."""
    from vbicm_tpu_torch.vi.train import TwoStepTrainer

    if fault == "altered":
        with _fh_patch(_altered):
            yield
    elif kind == "train" and fault == "unchanged":
        with _patch(TwoStepTrainer, "_step",
                    lambda old: lambda self, loss, params, opt: loss.detach()):
            yield
    elif kind == "train" and fault == "half_batch":
        def make(old):
            def update(self, net, opt, y, e_data, e=None):
                return old(self, net, opt, y[: y.shape[0] // 2], e_data, e)
            return update

        with _patch(TwoStepTrainer, "update_step1", make):
            yield
    elif kind == "datagen" and fault == "unchanged":
        with _fh_patch(lambda thetas, y, h: (torch.zeros_like(y), torch.zeros_like(h))):
            yield
    elif kind == "datagen" and fault == "half_batch":
        with _fh_patch(_half_lanes):
            yield
    else:
        raise ValueError(f"no fault {fault!r} for a {kind!r} cell")
