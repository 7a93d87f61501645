"""The device's idle share of the profiled datagen calls."""
from portbench.harness.readers import device_idle as read  # noqa: F401
