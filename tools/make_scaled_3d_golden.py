"""Write tests/fixtures/scaled_3d_golden.json: the JAX package's float64
observation operator on the two 3-D hex8 box configurations for 8 thetas,
through its box two-level solver with float64 CG at tol=1e-12:

- "train": the 3-D trainer's cantilever (examples/train_scaled_3d.py),
  32x8x8, lx = 10, tip force (0, 0, -0.02), coarse 16x4x4, ratio 2;
- "bench": the 3-D solve of bench.py, 64x16x16, lx = 4, the mesh's default
  tip force, coarse 16x4x4, ratio 4.

Both take the trainer's probes: y = the 3 displacements of the last node,
h = von Mises at element ((nz-1)*ny + ny//2)*nx + 2, qpts (1, 5). The port's
tests and chip_smoke.py hold the PyTorch port's solve against it;
chip_smoke.py reads the JSON only, since the machine with the GPU has no JAX.

    JAX_PLATFORMS=cpu python tools/make_scaled_3d_golden.py
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
del _os, _sys
import dataclasses
import json
import os

import numpy as np

CONFIGS = {
    "train": {"cells": (32, 8, 8), "ratio": 2, "lx": 10.0, "tip_force": (0.0, 0.0, -0.02)},
    "bench": {"cells": (64, 16, 16), "ratio": 4, "lx": 4.0, "tip_force": (0.0, 0.0, -1.0)},
}
N_THETAS = 8
SEED = 0
SOLVER = {"tol": 1e-12, "maxiter": 2000, "cg_dtype": "float64", "refine_iters": 0,
          "omega": 0.6}
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "tests", "fixtures", "scaled_3d_golden.json")


def probe_config(cls, nnodes, nx, ny, nz):
    """The 3-D trainer's probes (examples/train_scaled_3d.py)."""
    return dataclasses.replace(cls(), y_dim=3, node_id=nnodes,
                               ele_id=((nz - 1) * ny + ny // 2) * nx + 2, nipt_id=(1, 5))


def main():
    import jax
    import jax.numpy as jnp

    import vbicm_tpu
    from vbicm_tpu.config import ProblemConfig, SectionCard
    from vbicm_tpu.mesh.solid3d import beam_hex8_mesh
    from vbicm_tpu.model import build_fem_model
    from vbicm_tpu.solver import make_fh_fun, make_two_level_solver_box3d

    vbicm_tpu.enable_x64()
    sec = SectionCard(stype=4)
    thetas = np.random.default_rng(SEED).normal(size=(N_THETAS, 2))
    golden = {"solver": SOLVER, "seed": SEED, "thetas": thetas.tolist()}
    for name, c in CONFIGS.items():
        nx, ny, nz = c["cells"]
        r = c["ratio"]
        mesh_kw = {"lx": c["lx"], "tip_force": c["tip_force"]}
        model = build_fem_model(beam_hex8_mesh(nx, ny, nz, **mesh_kw), sec, dense=False)
        cells_c = (nx // r, ny // r, nz // r)
        coarse = build_fem_model(beam_hex8_mesh(*cells_c, **mesh_kw), sec, dense=True)
        cfg = probe_config(ProblemConfig, model.nnodes, nx, ny, nz)
        solve = make_two_level_solver_box3d(model, coarse, cells_c, r, tol=SOLVER["tol"],
                                            maxiter=SOLVER["maxiter"], omega=SOLVER["omega"])
        fh = jax.jit(jax.vmap(make_fh_fun(model, cfg, solve_free=solve)))
        y, h = fh(jnp.asarray(thetas))
        golden[name] = {
            "mesh": {"nx": nx, "ny": ny, "nz": nz, "ratio": r, "ndof": model.ndof, **mesh_kw},
            "probe": {"node_id": cfg.node_id, "ele_id": cfg.ele_id, "nipt_id": list(cfg.nipt_id)},
            "y": np.asarray(y).tolist(),
            "h": np.asarray(h).tolist(),
        }
        print(f"{name}: {model.ndof} dofs, y[0] {np.asarray(y)[0]}, h[0] {np.asarray(h)[0]}")
    with open(OUT, "w") as f:
        json.dump(golden, f, indent=1)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
