"""The plain ViT family (Dosovitskiy et al., arXiv:2010.11929): pre-LN
blocks with exact GELU and a two-product MLP, no class token or other prefix
token, the tracker's dense features. A configuration without a ``family``
key is of this family.

The four functions every family module has (``harness.load_family``):
``weights``, ``tokens``, ``flops_per_frame``, ``attention``.
"""

from __future__ import annotations

import math

import torch

from portbench import counts
from portbench.reference.layers import Quant, layer_norm, mm
from portbench.weights import generator, truncnormal


def weights(seed: int, dims: dict, device) -> dict:
    """The tracker's ViT tree (no class token, no head) for `dims` (depth,
    dim, mlp_dim, patch_size, image_size) from `seed`, with the program's
    random init distributions (the JAX package's ``init_vit_params``):
    weights truncated normal on [-2, 2] sigma with standard deviation
    fan_in^-1/2 (patch embed (p*p*3)^-1/2, qkv, out and the MLP's first
    product d^-1/2, its second mlp^-1/2; position embedding 0.02), biases
    zero, layer norms one and zero."""
    g = generator(seed, device)
    depth, d, mlp, p = dims["depth"], dims["dim"], dims["mlp_dim"], dims["patch_size"]
    seq = (dims["image_size"] // p) ** 2
    patch_in = p * p * 3

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    def ones(*shape):
        return torch.ones(shape, device=device)

    return {
        "patch_embed": {"kernel": truncnormal(g, (patch_in, d), patch_in ** -0.5, device), "bias": zeros(d)},
        "pos_embed": truncnormal(g, (seq, d), 0.02, device),
        "ln_final": {"scale": ones(d), "bias": zeros(d)},
        "blocks": {
            "ln1": {"scale": ones(depth, d), "bias": zeros(depth, d)},
            "attn": {"wqkv": truncnormal(g, (depth, d, 3 * d), d ** -0.5, device), "bqkv": zeros(depth, 3 * d),
                     "wo": truncnormal(g, (depth, d, d), d ** -0.5, device), "bo": zeros(depth, d)},
            "ln2": {"scale": ones(depth, d), "bias": zeros(depth, d)},
            "mlp": {"w1": truncnormal(g, (depth, d, mlp), d ** -0.5, device), "b1": zeros(depth, mlp),
                    "w2": truncnormal(g, (depth, mlp, d), mlp ** -0.5, device), "b2": zeros(depth, d)},
        },
    }


def tokens(params: dict, images: torch.Tensor, rc, quant: Quant = None) -> torch.Tensor:
    """Normalized images [B, S, S, 3] -> grid token features [B, g*g, D]
    after the final LN: patches in (row, column, channel) order, no position
    embedding and no class token (the tracker's dense features), pre-LN
    blocks with exact GELU; the fused qkv columns are head-major (head,
    q/k/v, head dim). `rc`: the reference's configuration (``dims``,
    ``ln_eps``)."""
    dims = rc.dims
    b, s, _, c = images.shape
    p, d, h = dims["patch_size"], dims["dim"], dims["heads"]
    g, hd = s // p, d // h
    x = images.reshape(b, g, p, g, p, c).permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, p * p * c)
    x = mm(x, params["patch_embed"]["kernel"].float(), quant) + params["patch_embed"]["bias"].float()
    blocks = params["blocks"]
    for i in range(dims["depth"]):
        def w(group: str, name: str) -> torch.Tensor:
            return blocks[group][name][i].float()

        y = layer_norm(x, w("ln1", "scale"), w("ln1", "bias"), rc.ln_eps)
        qkv = (mm(y, w("attn", "wqkv"), quant) + w("attn", "bqkv")).reshape(b, g * g, h, 3, hd)
        q, k, v = (qkv[:, :, :, j].transpose(1, 2) for j in range(3))  # [B, H, T, hd]
        att = torch.softmax(mm(q, k.transpose(-1, -2), quant) / math.sqrt(hd), dim=-1)
        o = mm(att, v, quant).transpose(1, 2).reshape(b, g * g, d)
        x = x + mm(o, w("attn", "wo"), quant) + w("attn", "bo")
        y = layer_norm(x, w("ln2", "scale"), w("ln2", "bias"), rc.ln_eps)
        y = torch.nn.functional.gelu(mm(y, w("mlp", "w1"), quant) + w("mlp", "b1"))
        x = x + mm(y, w("mlp", "w2"), quant) + w("mlp", "b2")
    return layer_norm(x, params["ln_final"]["scale"].float(), params["ln_final"]["bias"].float(), rc.ln_eps)


def flops_per_frame(dims: dict, tracker_config: dict) -> float:
    """Matmul FLOPs of one dense tracking step of one filter: the ViT
    forward of the search window (2 FLOPs a MAC: per token and block 8 d^2
    for qkv and out, 4 T d for QK^T and PV, 4 d mlp; plus the patch
    embedding) and the ROI cell scoring (``counts.scoring_flops``). A
    frozen copy of ``vitparticlefiltertracker_tpu_torch/runtime/benchmark.py``
    ``estimate_flops_per_frame`` (the JAX package's count term for term)."""
    d, mlp, depth, p = dims["dim"], dims["mlp_dim"], dims["depth"], dims["patch_size"]
    g = tracker_config["model"]["image_size"] // p
    t = g * g
    vit = depth * t * (8 * d * d + 4 * t * d + 4 * d * mlp) + t * 2 * (p * p * 3) * d
    return float(vit + counts.scoring_flops(g, d, tracker_config))


def attention(dims: dict, tracker_config: dict) -> tuple[int, int, int]:
    """(heads, tokens, head dim) of K1's launch for one search window: every
    patch of the grid, no prefix token."""
    g = tracker_config["model"]["image_size"] // dims["patch_size"]
    return dims["heads"], g * g, dims["dim"] // dims["heads"]
