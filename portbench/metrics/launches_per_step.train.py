"""Device operations a step-1 step launches."""
from portbench.harness.readers import launches_per_unit as read  # noqa: F401
