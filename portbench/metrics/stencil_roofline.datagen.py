"""The stencil kernel's share of its roofline in the profiled datagen calls."""
from portbench.harness.readers import stencil_roofline as read  # noqa: F401
