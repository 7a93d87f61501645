"""The batched CG's lane use over the profiled datagen chunks (%): the lanes'
float32 CG iterations (``last_cg_iters``) over B times the loop's steps,
which run to the slowest lane rounded up to the loop's next activity check
(``vbicm_tpu_torch.ops.solve.pcg_lane_use``). The config's maxiter, 400, is
a multiple of the check, so it never cuts the loop before that. A program
without ``pcg_lane_use`` reads nothing."""


def read(ctx):
    try:
        from vbicm_tpu_torch.ops.solve import pcg_lane_use
    except ImportError:
        return None
    return pcg_lane_use([it for runs in ctx.cg_solves for it in runs])
