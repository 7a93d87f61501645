"""Write tests/fixtures/scaled_160x80_golden.json: the JAX package's float64
observation operator on the scaled configuration (Cook's membrane 160x80,
26,082 dofs) for 8 thetas, through its two-level stencil solver with float64
CG at tol=1e-12. The port's tests and chip_smoke.py hold the PyTorch port's
two-level solve against it; chip_smoke.py reads the JSON only, since the
machine with the GPU has no JAX.

    JAX_PLATFORMS=cpu python tools/make_scaled_golden.py
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
del _os, _sys
import dataclasses
import json
import os

import numpy as np

NX, NY, RATIO = 160, 80, 4
N_THETAS = 8
SEED = 0
SOLVER = {"tol": 1e-12, "maxiter": 1000, "cg_dtype": "float64", "refine_iters": 0,
          "use_stencil": True, "omega": 0.6}
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "tests", "fixtures", "scaled_160x80_golden.json")


def main():
    import jax
    import jax.numpy as jnp

    import vbicm_tpu
    from vbicm_tpu.config import ProblemConfig
    from vbicm_tpu.mesh import cooks_membrane_mesh
    from vbicm_tpu.model import build_fem_model
    from vbicm_tpu.solver import make_fh_fun, make_two_level_solver

    vbicm_tpu.enable_x64()
    model = build_fem_model(cooks_membrane_mesh(NX, NY), dense=False)
    coarse = build_fem_model(cooks_membrane_mesh(NX // RATIO, NY // RATIO), dense=True)
    # the scaled configuration's probes (examples/train_scaled_fullorder.py)
    cfg = dataclasses.replace(ProblemConfig(), node_id=model.nnodes,
                              ele_id=(NY // 2) * NX + 12)
    solve = make_two_level_solver(
        model, coarse, NX // RATIO, NY // RATIO, RATIO, tol=SOLVER["tol"],
        maxiter=SOLVER["maxiter"], omega=SOLVER["omega"], use_stencil=True)
    fh = jax.jit(jax.vmap(make_fh_fun(model, cfg, solve_free=solve)))
    thetas = np.random.default_rng(SEED).normal(size=(N_THETAS, 2))
    y, h = fh(jnp.asarray(thetas))
    golden = {
        "mesh": {"nx": NX, "ny": NY, "ratio": RATIO, "ndof": model.ndof},
        "probe": {"node_id": cfg.node_id, "ele_id": cfg.ele_id, "nipt_id": list(cfg.nipt_id)},
        "solver": SOLVER,
        "seed": SEED,
        "thetas": thetas.tolist(),
        "y": np.asarray(y).tolist(),
        "h": np.asarray(h).tolist(),
    }
    with open(OUT, "w") as f:
        json.dump(golden, f, indent=1)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
