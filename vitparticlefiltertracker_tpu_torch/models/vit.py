"""Pre-LN Vision Transformer encoder — the port of the JAX package's
``models/vit.py``.

Parameters are the same nested dict as in the JAX package (blocks stacked on
a leading depth axis), holding torch tensors. Layer norm takes its statistics
in f32 whatever the compute dtype; the fused ``wqkv`` columns are laid out
head-major (h, 3, hd); GELU is the exact (erf) form. Each LayerNorm is a
pre-norm junction (``ops.prenorm_junction``): it adds the residual branch
still pending from before it (the previous product and its bias) and
normalises the sum, one kernel on CUDA tensors, today's torch chain on CPU
tensors and in a spec with ``use_flash_attention`` False. Attention goes through
``ops.attention.multi_head_attention`` (kernel K1 on CUDA tensors, the plain
version on CPU tensors; forward only), or, in a spec with
``use_flash_attention`` False (the trainer's), through the plain version on
any device, which autograd differentiates.

``VitSpec.ffn`` "swiglu" and ``registers`` give the DINOv2 block and prefix
(Oquab et al., arXiv:2304.07193; Darcet et al., arXiv:2309.16588): a fused
SwiGLU FFN (``w12`` to the gate and up halves, ``ops.swiglu``, then ``w3``)
and the sequence [class token, registers, patches], the position embedding
on the class token and the patches alone. LayerScale, a per-channel gamma on
each residual branch, is applied wherever the tree holds it (leaves
``ls1``/``ls2``, as a DINOv2 checkpoint brings them; ``models/params.py``
``cast_for_inference`` folds them into ``wo``/``bo`` and ``w3``/``b3``, so
an inference tree has none). With ``VitSpec.mesh`` set, the
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
from vitparticlefiltertracker_tpu_torch.ops.prenorm_junction import prenorm_junction, prenorm_junction_plain
from vitparticlefiltertracker_tpu_torch.ops.swiglu import swiglu, swiglu_plain
from vitparticlefiltertracker_tpu_torch.parallel.mesh import row_parallel_sum


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
    # heads and mlp_dim / M hidden columns; each block sums its two
    # row-parallel products over "model" before adding their biases. None:
    # the whole ViT here.
    mesh: object = None
    # The FFN: "gelu" (w1, exact GELU, w2) or "swiglu" (w12 to [gate | up]
    # of mlp_dim columns each, silu(gate) * up, w3).
    ffn: str = "gelu"
    # Register tokens after the class token, ahead of the patches.
    registers: int = 0

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def seq_len(self) -> int:
        """Tokens the position embedding covers: the class token and the patches."""
        return self.num_patches + (1 if self.use_cls_token else 0)

    @property
    def num_prefix(self) -> int:
        """Tokens ahead of the patches in the encoder's output: the class
        token and the registers."""
        return (1 if self.use_cls_token else 0) + self.registers

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
            ffn=m.ffn,
            registers=m.registers,
        )


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, T, p*p*C] token pixels, (py, px, c) order."""
    b, hh, ww, c = images.shape
    p = patch_size
    gh, gw = hh // p, ww // p
    x = images.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, p * p * c)


def _residual(y: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, ls: dict | None,
              spec: VitSpec) -> tuple[torch.Tensor, torch.Tensor | None]:
    """A branch's residual y @ w + bias as (branch, bias) for the next
    junction, which adds the bias where the plain chain did. Under a mesh
    y @ w is this rank's partial sum, so the sum over "model" comes first
    (parallel/mesh.py row_parallel_sum: in f32, in rank order) and adds the
    (replicated) bias once; a LayerScale gamma, where the tree holds one,
    scales the branch with its bias. In both cases the branch carries the
    bias and the bias returned is None."""
    if spec.mesh is not None:
        branch, bias = row_parallel_sum(y, w.to(spec.dtype), bias.to(spec.dtype), spec.mesh), None
    else:
        branch, bias = y @ w.to(spec.dtype), bias.to(spec.dtype)
    if ls is None:
        return branch, bias
    branch = branch if bias is None else branch + bias
    return branch * ls["gamma"].to(branch.dtype), None


def _junction(x: torch.Tensor, branch: torch.Tensor | None, bias: torch.Tensor | None, ln: dict,
              spec: VitSpec) -> tuple[torch.Tensor, torch.Tensor]:
    """(x + (branch + bias), its LN ln) in one pass (ops/prenorm_junction.py:
    the kernel on the card, the plain chain on the CPU; the plain,
    differentiable chain where attention is plain too)."""
    op = prenorm_junction if spec.use_flash_attention else prenorm_junction_plain
    return op(x, branch, bias, ln["scale"], ln["bias"], spec.dtype, spec.ln_eps)


def _block(x: torch.Tensor, pending: tuple, p: dict, spec: VitSpec) -> tuple[torch.Tensor, tuple]:
    """One block on the stream x, whose last residual `pending` (branch,
    bias; None, None for none) the block's first junction adds -> (the
    stream with the attention residual added, the FFN's residual, left
    pending for the next junction)."""
    b, t, d = x.shape
    h = spec.heads if spec.mesh is None else spec.heads // spec.mesh.shape["model"]
    dtype = spec.dtype

    x, y = _junction(x, *pending, p["ln1"], spec)
    qkv = y @ p["attn"]["wqkv"].to(dtype) + p["attn"]["bqkv"].to(dtype)
    # Fused qkv columns are head-major (h, 3, hd), as in the JAX package; q,
    # k and v are [B, H, T, hd] views of it. On the card K1 reads them in
    # place and writes [B, T, H, hd] memory, so the reshape below is a view.
    attend = multi_head_attention if spec.use_flash_attention else reference_attention
    o = attend(*split_fused_qkv(qkv, h))  # [B, H, T, hd]
    o = o.transpose(1, 2).reshape(b, t, -1)

    x, y = _junction(x, *_residual(o, p["attn"]["wo"], p["attn"]["bo"], p.get("ls1"), spec), p["ln2"], spec)
    mlp = p["mlp"]
    if spec.ffn == "swiglu":
        # [gate | up] of this rank's hidden columns (parallel/mesh.py cuts
        # w12 as matching halves), silu(gate) * up in f32 (ops/swiglu.py;
        # the plain, differentiable form where attention is plain too).
        gate = swiglu if spec.use_flash_attention else swiglu_plain
        y = gate(y @ mlp["w12"].to(dtype) + mlp["b12"].to(dtype))
        return x, _residual(y, mlp["w3"], mlp["b3"], p.get("ls2"), spec)
    y = y @ mlp["w1"].to(dtype) + mlp["b1"].to(dtype)
    y = torch.nn.functional.gelu(y, approximate="none")
    return x, _residual(y, mlp["w2"], mlp["b2"], p.get("ls2"), spec)


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
    [B, T, spec.out_dim], T = spec.num_prefix + T_patches (the prefix
    tokens first)."""
    dtype = spec.dtype
    b = x.shape[0]
    if spec.use_cls_token:
        cls = params["cls_token"].to(dtype).expand(b, 1, spec.dim)
        x = torch.cat([cls, x], dim=1)
    if spec.use_pos_embed:
        x = x + params["pos_embed"].to(dtype)[None, : x.shape[1]]
    if spec.registers:
        # Registers take no position embedding: they go in after it, behind
        # the class token (Darcet et al.'s DINOv2 order).
        cls_part = 1 if spec.use_cls_token else 0
        reg = params["reg_tokens"].to(dtype).expand(b, spec.registers, spec.dim)
        x = torch.cat([x[:, :cls_part], reg, x[:, cls_part:]], dim=1)
    # Each block leaves its FFN residual pending: the next block's first
    # junction, or the final LN's, adds it.
    pending = (None, None)
    for i in range(spec.depth):
        x, pending = _block(x, pending, _block_params(params["blocks"], i), spec)
    x, trunk = _junction(x, *pending, params["ln_final"], spec)
    if spec.head_depth <= 0:
        return trunk
    # The head continues the stream from before the final LN (a readout, not
    # part of the pre-LN stream) and ends in its own LN; the trunk half is
    # the headless forward's output.
    pending = (None, None)
    for i in range(spec.head_depth):
        x, pending = _block(x, pending, _block_params(params["head"]["blocks"], i), spec)
    _, head = _junction(x, *pending, params["head"]["ln"], spec)
    return torch.cat([trunk, head], dim=-1)


def pool_tokens(tokens: torch.Tensor, spec: VitSpec) -> torch.Tensor:
    """[B, T, D] -> [B, D] appearance embedding."""
    if spec.pooling == "cls":
        return tokens[:, 0]
    return tokens[:, spec.num_prefix:].mean(dim=1)

