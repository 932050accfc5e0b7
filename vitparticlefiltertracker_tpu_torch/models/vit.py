"""Pre-LN Vision Transformer encoder — the port of the JAX package's
``models/vit.py``.

Parameters are the same nested dict as in the JAX package (blocks stacked on
a leading depth axis), holding torch tensors. Layer norm takes its statistics
in f32 whatever the compute dtype; the fused ``wqkv`` columns are laid out
head-major (h, 3, hd); GELU is the exact (erf) form. Attention goes through
``ops.attention.multi_head_attention`` (kernel K1 on CUDA tensors, the plain
version on CPU tensors; forward only), or, in a spec with
``use_flash_attention`` False (the trainer's), through the plain version on
any device, which autograd differentiates. With ``VitSpec.mesh`` set, the
blocks run tensor-parallel over the mesh's "model" axis on this rank's
share of the weights (parallel/mesh.py ``vit_param_shard``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vitparticlefiltertracker_tpu_torch.ops.attention import (
    multi_head_attention,
    reference_attention,
    split_fused_qkv,
)
from vitparticlefiltertracker_tpu_torch.parallel.mesh import all_reduce


class VitSpec(NamedTuple):
    depth: int = 12
    dim: int = 768
    heads: int = 12
    mlp_dim: int = 3072
    patch_size: int = 16
    image_size: int = 224
    pooling: str = "mean"  # "mean" | "cls"
    dtype: torch.dtype = torch.bfloat16  # compute dtype
    use_cls_token: bool = False
    ln_eps: float = 1e-6
    # Dense tracking needs translation-equivariant token features, so the
    # tracker turns position embeddings off (see the JAX VitSpec).
    use_pos_embed: bool = True
    # False: attention as the plain, differentiable torch composition
    # (reference_attention), as the JAX package's trainer sets it; True:
    # ops.attention.multi_head_attention (K1 on the card, forward only).
    # from_config leaves it True: every tracker attention on the card is K1.
    use_flash_attention: bool = True
    # Residual head: head_depth extra blocks continue the trunk's stream
    # before its final LN, with their own LN; encode_tokens then returns
    # concat(trunk, head) [B, T, 2 * dim]. 0 = no head.
    head_depth: int = 0
    # A parallel.mesh.Mesh: tensor parallelism over its "model" axis. The
    # parameters are this rank's (parallel.mesh.vit_param_shard): H / M
    # heads and mlp_dim / M hidden columns; each block all-reduces its two
    # row-parallel products over "model" before adding their biases. None:
    # the whole ViT here.
    mesh: object = None

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def seq_len(self) -> int:
        return self.num_patches + (1 if self.use_cls_token else 0)

    @property
    def out_dim(self) -> int:
        return self.dim * (2 if self.head_depth > 0 else 1)

    @classmethod
    def from_config(cls, m) -> "VitSpec":
        """Build from config.ModelConfig."""
        return cls(
            depth=m.depth,
            dim=m.dim,
            heads=m.heads,
            mlp_dim=m.mlp_dim,
            patch_size=m.patch_size,
            image_size=m.image_size,
            pooling=m.pooling,
            dtype=torch.bfloat16 if m.dtype == "bfloat16" else torch.float32,
            use_cls_token=(m.pooling == "cls") or not m.drop_cls_token,
            ln_eps=m.ln_eps,
            head_depth=m.head_depth,
        )


def _layer_norm(x: torch.Tensor, p: dict, dtype: torch.dtype, eps: float = 1e-6) -> torch.Tensor:
    """LN with f32 statistics regardless of compute dtype (population var)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(dtype)


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, T, p*p*C] token pixels, (py, px, c) order."""
    b, hh, ww, c = images.shape
    p = patch_size
    gh, gw = hh // p, ww // p
    x = images.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, p * p * c)


def _row_parallel(y: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, spec: VitSpec) -> torch.Tensor:
    """y @ w + bias; under a mesh, y @ w is this rank's partial sum, so the
    sum over "model" comes first and the (replicated) bias is added once."""
    y = y @ w.to(spec.dtype)
    if spec.mesh is not None:
        y = all_reduce(y, spec.mesh, "model")
    return y + bias.to(spec.dtype)


def _block(x: torch.Tensor, p: dict, spec: VitSpec) -> torch.Tensor:
    b, t, d = x.shape
    h = spec.heads if spec.mesh is None else spec.heads // spec.mesh.shape["model"]
    dtype = spec.dtype

    y = _layer_norm(x, p["ln1"], dtype, spec.ln_eps)
    qkv = y @ p["attn"]["wqkv"].to(dtype) + p["attn"]["bqkv"].to(dtype)
    # Fused qkv columns are head-major (h, 3, hd), as in the JAX package; q,
    # k and v are [B, H, T, hd] views of it. On the card K1 reads them in
    # place and writes [B, T, H, hd] memory, so the reshape below is a view.
    attend = multi_head_attention if spec.use_flash_attention else reference_attention
    o = attend(*split_fused_qkv(qkv, h))  # [B, H, T, hd]
    o = o.transpose(1, 2).reshape(b, t, -1)
    x = x + _row_parallel(o, p["attn"]["wo"], p["attn"]["bo"], spec)

    y = _layer_norm(x, p["ln2"], dtype, spec.ln_eps)
    y = y @ p["mlp"]["w1"].to(dtype) + p["mlp"]["b1"].to(dtype)
    y = torch.nn.functional.gelu(y, approximate="none")
    return x + _row_parallel(y, p["mlp"]["w2"], p["mlp"]["b2"], spec)


def _block_params(blocks: dict, i: int) -> dict:
    """Layer i of the depth-stacked block parameters."""
    return {g: {n: w[i] for n, w in leaves.items()} for g, leaves in blocks.items()}


def vit_forward_tokens(params: dict, images: torch.Tensor, spec: VitSpec) -> torch.Tensor:
    """Full encoder -> token features [B, T, D] (post final LN).

    images: [B, H, W, 3], already normalized float.
    """
    dtype = spec.dtype
    tokens = patchify(images.to(dtype), spec.patch_size)
    x = tokens @ params["patch_embed"]["kernel"].to(dtype) + params["patch_embed"]["bias"].to(dtype)
    return encode_tokens(params, x, spec)


def encode_tokens(params: dict, x: torch.Tensor, spec: VitSpec) -> torch.Tensor:
    """Encoder over already patch-embedded tokens [B, T_patches, D] ->
    [B, T, spec.out_dim]."""
    dtype = spec.dtype
    b = x.shape[0]
    if spec.use_cls_token:
        cls = params["cls_token"].to(dtype).expand(b, 1, spec.dim)
        x = torch.cat([cls, x], dim=1)
    if spec.use_pos_embed:
        x = x + params["pos_embed"].to(dtype)[None, : x.shape[1]]
    for i in range(spec.depth):
        x = _block(x, _block_params(params["blocks"], i), spec)
    trunk = _layer_norm(x, params["ln_final"], dtype, spec.ln_eps)
    if spec.head_depth <= 0:
        return trunk
    # The head continues the stream from before the final LN (a readout, not
    # part of the pre-LN stream) and ends in its own LN; the trunk half is
    # the headless forward's output.
    for i in range(spec.head_depth):
        x = _block(x, _block_params(params["head"]["blocks"], i), spec)
    head = _layer_norm(x, params["head"]["ln"], dtype, spec.ln_eps)
    return torch.cat([trunk, head], dim=-1)


def pool_tokens(tokens: torch.Tensor, spec: VitSpec) -> torch.Tensor:
    """[B, T, D] -> [B, D] appearance embedding."""
    if spec.pooling == "cls":
        return tokens[:, 0]
    start = 1 if spec.use_cls_token else 0
    return tokens[:, start:].mean(dim=1)

