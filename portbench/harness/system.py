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


# the problems a configuration can name by its mesh's ``kind``, with the
# solver kind each takes; a mesh without a kind is Cook's membrane
SOLVER_KINDS = {"cooks_membrane": "two_level", "beam_hex8": "two_level_box3d"}


def problem_kind(config: dict) -> str:
    kind = config["mesh"].get("kind", "cooks_membrane")
    if kind not in SOLVER_KINDS:
        raise ValueError(f"unknown mesh kind {kind!r}; known: {sorted(SOLVER_KINDS)}")
    return kind


def y_dim(config: dict) -> int:
    """The observation's width: the probe's ``y_dim``, else Cook's 2."""
    return config["probe"].get("y_dim", 2)


def problem_config(config: dict):
    from vbicm_tpu_torch.config import ProblemConfig, ThetaMap

    probe, noise, tm = config["probe"], config["noise"], config["theta_map"]
    return ProblemConfig(y_dim=y_dim(config), node_id=probe["node_id"], ele_id=probe["ele_id"],
                         nipt_id=tuple(probe["nipt_id"]), sig_e=noise["sig_e"],
                         sig_eta=noise["sig_eta"],
                         theta_map=ThetaMap(tuple(tm["mean"]), tuple(tm["std"])))


def build_fh(config: dict, device):
    """``(fh, solver)``: the batched observation operator ``thetas (B, 2)
    -> (y, h)`` over the configuration's two-level solver (Cook's membrane,
    or the hex8 cantilever's box solver), and that solver's
    ``MatfreeAffineSolver`` (its ``last_cg_iters``)."""
    from vbicm_tpu_torch.mesh import cooks_membrane_mesh
    from vbicm_tpu_torch.model import build_fem_model
    from vbicm_tpu_torch.solver import make_fh_fun, make_two_level_solver

    nx, ny = config["mesh"]["nx"], config["mesh"]["ny"]
    s = config["solver"]
    kind = problem_kind(config)
    if s["kind"] != SOLVER_KINDS[kind]:
        raise ValueError(f"unknown solver kind {s['kind']!r} for a {kind} mesh")
    pcfg = problem_config(config)
    r = s["coarse_ratio"]
    if kind == "beam_hex8":
        model, solve = _box_solver(config, device)
        return make_fh_fun(model, pcfg, solve_free=solve), solve.solver
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


def _box_solver(config: dict, device):
    """``(model, solve)``: the hex8 cantilever's fine model and its box
    two-level solver, built as ``examples/train_scaled_3d_torch.py`` builds
    them."""
    from vbicm_tpu_torch.config import SectionCard
    from vbicm_tpu_torch.mesh import beam_hex8_mesh
    from vbicm_tpu_torch.model import build_fem_model
    from vbicm_tpu_torch.solver import make_two_level_solver_box3d

    m, s = config["mesh"], config["solver"]
    r = s["coarse_ratio"]
    cells = (m["nx"], m["ny"], m["nz"])
    if any(n % r for n in cells):
        raise ValueError(f"the coarse ratio {r} does not divide the cells {cells}")
    cells_c = tuple(n // r for n in cells)
    box = dict(lx=m["lx"], ly=m["ly"], lz=m["lz"], tip_force=tuple(m["tip_force"]))
    sec = SectionCard(stype=config["section"]["stype"])
    model = build_fem_model(beam_hex8_mesh(*cells, **box), sec, device=device, dense=False)
    coarse = build_fem_model(beam_hex8_mesh(*cells_c, **box), sec, device=device, dense=True)
    solve = make_two_level_solver_box3d(model, coarse, cells_c, r,
                                        cg_dtype=DTYPES[s["cg_dtype"]],
                                        refine_iters=s["refine_iters"], tol=s["tol"],
                                        maxiter=s["maxiter"], omega=s["omega"],
                                        refine_residual=s["refine_residual"])
    return model, solve


def build_trainer(config: dict, traffic: dict, fh, device, y_norm=None):
    """The step-1 trainer of the configuration over ``fh``; ``y_norm =
    (mean, std)`` standardises the nets' inputs (a configuration with
    ``y_norm`` set)."""
    from vbicm_tpu_torch.config import TrainConfig
    from vbicm_tpu_torch.vi.train import TwoStepTrainer

    net = config["net"]
    tcfg = TrainConfig(num_neuron=net["hidden"], num_layers1=net["layers"],
                       batch_size=traffic["batch"], pairing=config["pairing"],
                       lr=config["adam"]["lr"], clip_grad_norm=config["adam"]["clip_grad_norm"])
    norm = {} if y_norm is None else {"y_norm": y_norm}
    return TwoStepTrainer(None, problem_config(config), tcfg, fh_batch=fh, device=device,
                          dtype=DTYPES[net["dtype"]], **norm)


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
