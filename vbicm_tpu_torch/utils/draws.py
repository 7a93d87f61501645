"""Random draws from an explicit ``torch.Generator`` onto any device.

The port's counterpart of passing a JAX ``key``: the caller's generator
draws on its own device (a CPU generator gives the same numbers whatever
device the work runs on), and the draws move to the device that uses them.
Samplers draw a run's numbers in one call, so no step of their loop copies
from the host.
"""
from __future__ import annotations

import torch


def draw_normal(generator: torch.Generator, shape, dtype, device) -> torch.Tensor:
    """N(0, 1) draws from ``generator``, on ``device``."""
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=generator.device).to(device)


def draw_uniform(generator: torch.Generator, shape, dtype, device) -> torch.Tensor:
    """U[0, 1) draws from ``generator``, on ``device``."""
    return torch.rand(shape, generator=generator, dtype=dtype,
                      device=generator.device).to(device)
