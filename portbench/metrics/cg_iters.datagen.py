"""Mean float32 CG iterations a solve of the profiled datagen calls."""
from portbench.harness.readers import cg_iters as read  # noqa: F401
