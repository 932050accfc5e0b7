"""Systematic resampling: cumsum plus a rank search.

Semantics follow the JAX package's ``ops/resample.py`` (and its scalar
oracle): idx[i] = min{j : cumsum(w)[j] >= (u + i) / N}, with the last cumsum
entry floored to 1 and indices clipped to N - 1.
"""

from __future__ import annotations

import torch


def ranks_in_sorted(keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """rank[i] = #{j : keys[j] < queries[i]} for ascending keys -> [..., M]
    int64 (leading axes: one sorted row of keys each).

    For sorted keys this is searchsorted(side='left'), which counts exactly.
    """
    return torch.searchsorted(keys.contiguous(), queries.contiguous(), side="left")


def systematic_resample_indices(weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Ancestor indices [..., N] int64, ascending by construction.

    weights: [..., N] normalized probabilities; u: [...] U[0, 1) draws, one a
    row of weights.
    """
    n = weights.shape[-1]
    dtype = weights.dtype
    positions = (u.to(dtype)[..., None] + torch.arange(n, dtype=dtype, device=weights.device)) / n
    cumsum = torch.cumsum(weights, dim=-1)
    # Guard against cumsum[-1] < 1 from float undersum (the oracle does the same).
    last = torch.clamp(cumsum[..., -1:], min=1.0)
    cumsum = torch.cat([cumsum[..., :-1], last], dim=-1)
    idx = ranks_in_sorted(cumsum, positions)
    return torch.clamp(idx, 0, n - 1)

