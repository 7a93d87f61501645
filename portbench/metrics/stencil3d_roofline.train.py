"""The 3-D stencil kernel's share of its roofline in the profiled steps."""
from portbench.harness.readers import stencil3d_roofline as read  # noqa: F401
