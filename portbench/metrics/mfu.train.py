"""The whole step's share of the chip's peak, from its counted solve work."""
from portbench.harness.readers import mfu as read  # noqa: F401
