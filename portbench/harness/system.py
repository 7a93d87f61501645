"""The system under test: the port's objects built from a configuration file,
through the port's public entry points (the same ones its examples use)."""
from __future__ import annotations

import copy
import dataclasses

import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def merged(config: dict, overrides: dict = None) -> dict:
    """``config`` with the groups of ``overrides`` updated key by key (a
    control's lower-precision path)."""
    out = copy.deepcopy(config)
    for group, values in (overrides or {}).items():
        out[group].update(values)
    return out


def problem_config(config: dict):
    from vbicm_tpu_torch.config import ProblemConfig, ThetaMap

    probe, noise, tm = config["probe"], config["noise"], config["theta_map"]
    return ProblemConfig(node_id=probe["node_id"], ele_id=probe["ele_id"],
                         nipt_id=tuple(probe["nipt_id"]), sig_e=noise["sig_e"],
                         sig_eta=noise["sig_eta"],
                         theta_map=ThetaMap(tuple(tm["mean"]), tuple(tm["std"])))


def build_fh(config: dict, device):
    """``(fh, solver)``: the batched observation operator ``thetas (B, 2)
    -> (y, h)`` over the configuration's two-level solver, and that
    solver's ``MatfreeAffineSolver`` (its ``last_cg_iters``)."""
    from vbicm_tpu_torch.mesh import cooks_membrane_mesh
    from vbicm_tpu_torch.model import build_fem_model
    from vbicm_tpu_torch.solver import make_fh_fun, make_two_level_solver

    nx, ny = config["mesh"]["nx"], config["mesh"]["ny"]
    s = config["solver"]
    if s["kind"] != "two_level":
        raise ValueError(f"unknown solver kind {s['kind']!r}")
    pcfg = problem_config(config)
    r = s["coarse_ratio"]
    model = build_fem_model(cooks_membrane_mesh(nx, ny), device=device, dense=False,
                            dtype=torch.float64)
    coarse = build_fem_model(cooks_membrane_mesh(nx // r, ny // r), device=device, dense=True,
                             dtype=torch.float64)
    solve = make_two_level_solver(model, coarse, nx // r, ny // r, r,
                                  cg_dtype=DTYPES[s["cg_dtype"]], refine_iters=s["refine_iters"],
                                  tol=s["tol"], maxiter=s["maxiter"], omega=s["omega"],
                                  use_stencil=s["use_stencil"],
                                  refine_residual=s["refine_residual"])
    return make_fh_fun(model, pcfg, solve_free=solve), solve.solver


def build_trainer(config: dict, traffic: dict, fh, device):
    """The step-1 trainer of the configuration over ``fh``."""
    from vbicm_tpu_torch.config import TrainConfig
    from vbicm_tpu_torch.vi.train import TwoStepTrainer

    net = config["net"]
    tcfg = TrainConfig(num_neuron=net["hidden"], num_layers1=net["layers"],
                       batch_size=traffic["batch"], pairing=config["pairing"],
                       lr=config["adam"]["lr"], clip_grad_norm=config["adam"]["clip_grad_norm"])
    return TwoStepTrainer(None, problem_config(config), tcfg, fh_batch=fh, device=device,
                          dtype=DTYPES[net["dtype"]])


@dataclasses.dataclass
class SolveRecorder:
    """Keeps the CG iteration counts of every solve of a matrix-free solver
    while ``on``: the solver's own counter, ``last_cg_iters`` (one device
    tensor of per-lane counts a CG run), read after each solve."""

    solver: object
    on: bool = False
    solves: list = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if self.solver is None:
            return
        solve_once = self.solver.solve_once

        def recorded(coeffs, b):
            x = solve_once(coeffs, b)
            if self.on:
                self.solves.append([it.detach() for it in self.solver.last_cg_iters])
            return x

        self.solver.solve_once = recorded

    def counts(self):
        """Per solve, the per-lane counts of each CG run, on the host."""
        return [[it.cpu().numpy() for it in runs] for runs in self.solves]
