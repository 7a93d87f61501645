"""Device ms a step in elementwise kernels (CG's vector updates)."""
from portbench.harness.readers import elementwise_ms as read  # noqa: F401
