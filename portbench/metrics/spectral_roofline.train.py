"""The spectral coarse solve's share of its roofline in the profiled steps."""
from portbench.harness.readers import spectral_roofline as read  # noqa: F401
