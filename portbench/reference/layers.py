"""The plain float32 pieces a family's forward (``families/<family>.py``
``tokens``) is built from: products that the control can round to a lower
precision, and layer norm."""

from __future__ import annotations

from typing import Callable

import torch

Quant = Callable[[torch.Tensor], torch.Tensor] | None


def mm(a: torch.Tensor, b: torch.Tensor, quant: Quant) -> torch.Tensor:
    """a @ b, each operand rounded by `quant` first (the control) or not."""
    if quant is not None:
        a, b = quant(a), quant(b)
    return a @ b


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * scale + bias
