"""Seeded weights, made on the device in a few large draws: the draws a
family's ``weights`` (``families/<family>.py``) builds its tree from.

The numbers are the benchmark's own, drawn from ``torch.Generator`` on the
device keyed on the run's seed, one call a stacked leaf, in float32; the
same tree goes to the program and, drawn again from the same seed, to the
reference.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.noise import splitmix64

_LO, _HI = (0.5 * (1.0 + math.erf(x / math.sqrt(2.0))) for x in (-2.0, 2.0))


def generator(seed: int, device) -> torch.Generator:
    """The generator a family's weights are drawn from, keyed on `seed`."""
    g = torch.Generator(device=device)
    g.manual_seed(splitmix64(int(seed) ^ 0x57E1))
    return g


def truncnormal(g: torch.Generator, shape, std: float, device) -> torch.Tensor:
    """std * a normal truncated to [-2, 2] by its inverse CDF."""
    u = torch.rand(shape, generator=g, device=device, dtype=torch.float64)
    x = math.sqrt(2.0) * torch.erfinv(2.0 * (_LO + u * (_HI - _LO)) - 1.0)
    return (torch.clamp(x, -2.0, 2.0) * std).to(torch.float32)
