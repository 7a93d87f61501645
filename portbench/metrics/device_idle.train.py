"""The device's idle share of the profiled training steps."""
from portbench.harness.readers import device_idle as read  # noqa: F401
