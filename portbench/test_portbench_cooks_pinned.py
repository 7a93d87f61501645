"""Cook's membrane path of the harness pinned to the harness as it was before
the 3-D box was added beside it (commit 2c1896e; the goldens are
``golden/cooks_harness.json``, written by running the recorders below on that
commit's ``portbench``): the dataset draws, the counted work of recorded
solves, and the calls that ``build_fh``, ``problem_config`` and
``build_trainer`` make into the port."""
import dataclasses
import hashlib
import json
import os

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden", "cooks_harness.json")
DRAW_SEEDS = [0, 2**31 + 5, 2**62 + 3]


def cooks_config(bench_dir=HERE):
    with open(os.path.join(bench_dir, "configs", "cooks_160x80.json")) as f:
        return json.load(f)


def recorded_solves():
    """Per solve, the per-lane CG counts of its two runs (the first and the
    refinement's), 4 solves of 256 lanes."""
    rng = np.random.default_rng(20)
    return [[rng.integers(18, 90, 256), rng.integers(1, 12, 256)] for _ in range(4)]


def plain(x):
    """``x`` as JSON: port objects replaced by their tags, dtypes and
    devices by their names, dataclasses by their fields."""
    if isinstance(x, _Tag):
        return x.name
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {"type": type(x).__name__,
                **{f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x)}}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, dict):
        return {str(k): plain(v) for k, v in x.items()}
    if isinstance(x, (torch.dtype, torch.device)):
        return str(x)
    if isinstance(x, np.generic):
        return x.item()
    return x


class _Tag:
    """What a recorded entry point returns; a solve's tag carries its
    ``.solver``."""

    def __init__(self, name, solver=None):
        self.name, self.solver = name, solver


def record_draws(cfg, ne=4):
    """The sha256 of each draw of ``_draw_dataset_inputs`` for each seed of
    ``DRAW_SEEDS``, with its shape."""
    from portbench.harness import runners

    out = []
    for seed in DRAW_SEEDS:
        state = torch.Generator().manual_seed(runners.sub_seed(seed, 1)).get_state()
        drawn = runners._draw_dataset_inputs(state, cfg["n_data"], ne, cfg)
        out.append([[list(t.shape), hashlib.sha256(t.numpy().tobytes()).hexdigest()]
                    for t in drawn])
    return out


def record_works(cfg):
    """``_solve_works`` of ``recorded_solves`` at the configuration's own
    size, forward only and with the adjoint."""
    from portbench.harness import runners
    from portbench.reference import fem

    problem = fem.build_problem(cfg, "cpu")
    solves = recorded_solves()
    return {str(adj): [plain([w.op, w.nbytes, w.flops, w.unit])
                       for w in runners._solve_works(cfg, problem, solves, adjoint=adj)]
            for adj in (False, True)}


def record_calls(cfg, traffic):
    """Every call ``build_fh`` and ``build_trainer`` make into the port's
    entry points, with its arguments, the entry points replaced by
    recorders; and ``problem_config``'s result."""
    import vbicm_tpu_torch.mesh as mesh_mod
    import vbicm_tpu_torch.model as model_mod
    import vbicm_tpu_torch.solver as solver_mod
    import vbicm_tpu_torch.vi.train as train_mod

    from portbench.harness import system

    calls = []

    def recorder(name):
        def call(*args, **kwargs):
            calls.append([name, plain(list(args)), plain(dict(sorted(kwargs.items())))])
            tag = f"{name}#{len(calls)}"
            return _Tag(tag, _Tag(tag + ".solver") if name.startswith("solve:") else None)
        return call

    targets = [(mesh_mod, "cooks_membrane_mesh"), (mesh_mod, "beam_hex8_mesh"),
               (model_mod, "build_fem_model"), (solver_mod, "make_two_level_solver"),
               (solver_mod, "make_two_level_solver_box3d"), (solver_mod, "make_fh_fun"),
               (train_mod, "TwoStepTrainer")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]
    try:
        for mod, name in targets:
            label = "solve:" + name if name.startswith("make_two_level_solver") else name
            setattr(mod, name, recorder(label))
        fh, solver = system.build_fh(cfg, "cpu")
        calls.append(["build_fh returns", plain([fh, solver]), {}])
        system.build_trainer(cfg, traffic, fh, "cpu")
    finally:
        for mod, name, old in saved:
            setattr(mod, name, old)
    return {"calls": calls, "problem_config": plain(system.problem_config(cfg))}


def record_all(bench_dir=HERE):
    cfg = cooks_config(bench_dir)
    with open(os.path.join(bench_dir, "traffic", "step1_b64x4.json")) as f:
        traffic = json.load(f)
    return {"draws": record_draws(cfg), "works": record_works(cfg),
            "build": record_calls(cfg, traffic)}


def _golden():
    with open(GOLDEN) as f:
        return json.load(f)


def test_dataset_draws_are_the_parents():
    assert record_draws(cooks_config()) == _golden()["draws"]


def test_counted_work_is_the_parents():
    assert record_works(cooks_config()) == _golden()["works"]


def test_calls_into_the_port_are_the_parents():
    with open(os.path.join(HERE, "traffic", "step1_b64x4.json")) as f:
        traffic = json.load(f)
    assert record_calls(cooks_config(), traffic) == _golden()["build"]
