"""Seeded ViT weights, made on the device in a few large draws.

The distributions are the program's random init (the JAX package's
``init_vit_params``): weights truncated normal on [-2, 2] sigma with
standard deviation fan_in^-1/2 (patch embed (p*p*3)^-1/2, qkv, out and the
MLP's first product d^-1/2, its second mlp^-1/2; position embedding 0.02),
biases zero, layer norms one and zero. The numbers are the benchmark's own,
drawn from ``torch.Generator`` on the device keyed on the run's seed, one
call a stacked leaf, in float32; the same tree goes to the program and,
drawn again from the same seed, to the reference.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.noise import splitmix64

_LO, _HI = (0.5 * (1.0 + math.erf(x / math.sqrt(2.0))) for x in (-2.0, 2.0))


def _truncnormal(g: torch.Generator, shape, std: float, device) -> torch.Tensor:
    """std * a normal truncated to [-2, 2] by its inverse CDF."""
    u = torch.rand(shape, generator=g, device=device, dtype=torch.float64)
    x = math.sqrt(2.0) * torch.erfinv(2.0 * (_LO + u * (_HI - _LO)) - 1.0)
    return (torch.clamp(x, -2.0, 2.0) * std).to(torch.float32)


def vit_weights(seed: int, dims: dict, device) -> dict:
    """The tracker's ViT tree (no class token, no head) for `dims` (depth,
    dim, mlp_dim, patch_size, image_size) from `seed`."""
    g = torch.Generator(device=device)
    g.manual_seed(splitmix64(int(seed) ^ 0x57E1))
    depth, d, mlp, p = dims["depth"], dims["dim"], dims["mlp_dim"], dims["patch_size"]
    seq = (dims["image_size"] // p) ** 2
    patch_in = p * p * 3

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    def ones(*shape):
        return torch.ones(shape, device=device)

    return {
        "patch_embed": {"kernel": _truncnormal(g, (patch_in, d), patch_in ** -0.5, device), "bias": zeros(d)},
        "pos_embed": _truncnormal(g, (seq, d), 0.02, device),
        "ln_final": {"scale": ones(d), "bias": zeros(d)},
        "blocks": {
            "ln1": {"scale": ones(depth, d), "bias": zeros(depth, d)},
            "attn": {"wqkv": _truncnormal(g, (depth, d, 3 * d), d ** -0.5, device), "bqkv": zeros(depth, 3 * d),
                     "wo": _truncnormal(g, (depth, d, d), d ** -0.5, device), "bo": zeros(depth, d)},
            "ln2": {"scale": ones(depth, d), "bias": zeros(depth, d)},
            "mlp": {"w1": _truncnormal(g, (depth, d, mlp), d ** -0.5, device), "b1": zeros(depth, mlp),
                    "w2": _truncnormal(g, (depth, mlp, d), mlp ** -0.5, device), "b2": zeros(depth, d)},
        },
    }
