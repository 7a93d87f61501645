"""Mean float32 CG iterations a solve of the profiled steps (forward and adjoint)."""
from portbench.harness.readers import cg_iters as read  # noqa: F401
