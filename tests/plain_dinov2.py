"""A plain float32 DINOv2 forward with registers, for the port's tests: the
published block (Oquab et al., arXiv:2304.07193, ``NestedTensorBlock`` with
``SwiGLUFFNFused`` and ``LayerScale``; Darcet et al., arXiv:2309.16588, the
registers) written from the papers' description with torch's functional
ops, importing neither the port nor JAX.

    x = [cls, reg_1 .. reg_R, patches]      (no position embedding)
    x = x + gamma1 * attn(norm1(x))
    x = x + gamma2 * (w3 (silu(x w12[:, :h] + b12[:h]) * (x w12[:, h:] + b12[h:])) + b3)   on norm2(x)
    features = norm(x)[:, 1 + R:]           (the patch grid, row-major)

The patch embedding is a stride-p convolution whose kernel reads the
tracker's [p*p*3, D] rows in (row, column, channel) order; the fused qkv
columns are head-major (head, q/k/v, head dim), the port's layout.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def full_f32():
    """float32 products and convolutions without TF32, restored on exit."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def draw_tree(seed: int, depth: int, dim: int, heads: int, ffn: int, patch: int, registers: int) -> dict:
    """A seeded DINOv2 tree in the port's layout, every leaf drawn away from
    a value that would hide a fault: weights normal at fan_in^-1/2, biases
    and layer norms' shifts normal at 0.1, norms' scales about 1, class and
    register tokens normal at 0.5, LayerScale gammas uniform on [0.1, 1]
    (DINOv2's training init of 1e-5 would make every branch vanish)."""
    g = torch.Generator().manual_seed(seed)

    def n(*shape, std=1.0):
        return torch.randn(shape, generator=g) * std

    def ln(*lead):
        return {"scale": 1.0 + n(*lead, dim, std=0.1), "bias": n(*lead, dim, std=0.1)}

    d, pin = dim, patch * patch * 3
    return {
        "patch_embed": {"kernel": n(pin, d, std=pin ** -0.5), "bias": n(d, std=0.1)},
        "cls_token": n(d, std=0.5),
        "reg_tokens": n(registers, d, std=0.5),
        "ln_final": ln(),
        "blocks": {
            "ln1": ln(depth),
            "attn": {"wqkv": n(depth, d, 3 * d, std=d ** -0.5), "bqkv": n(depth, 3 * d, std=0.1),
                     "wo": n(depth, d, d, std=d ** -0.5), "bo": n(depth, d, std=0.1)},
            "ls1": {"gamma": 0.1 + 0.9 * torch.rand(depth, d, generator=g)},
            "ln2": ln(depth),
            "mlp": {"w12": n(depth, d, 2 * ffn, std=d ** -0.5), "b12": n(depth, 2 * ffn, std=0.1),
                    "w3": n(depth, ffn, d, std=ffn ** -0.5), "b3": n(depth, d, std=0.1)},
            "ls2": {"gamma": 0.1 + 0.9 * torch.rand(depth, d, generator=g)},
        },
    }


def _norm(x, p, eps):
    return F.layer_norm(x, x.shape[-1:], p["scale"].float(), p["bias"].float(), eps)


def forward(tree: dict, images: torch.Tensor, heads: int, patch: int, eps: float = 1e-6) -> torch.Tensor:
    """Normalized images [B, S, S, 3] -> the patch grid's features [B, g*g,
    D] after the final norm, the class token and registers dropped."""
    with full_f32():
        b = images.shape[0]
        kern = tree["patch_embed"]["kernel"].float()
        d = kern.shape[1]
        conv_w = kern.reshape(patch, patch, 3, d).permute(3, 2, 0, 1)  # [D, C, p, p]
        x = F.conv2d(images.float().permute(0, 3, 1, 2), conv_w, tree["patch_embed"]["bias"].float(), stride=patch)
        x = x.flatten(2).transpose(1, 2)  # [B, g*g, D], row-major
        reg = tree["reg_tokens"].float()
        prefix = torch.cat([tree["cls_token"].float()[None], reg]).expand(b, -1, -1)
        x = torch.cat([prefix, x], dim=1)
        t, hd = x.shape[1], d // heads
        blocks = tree["blocks"]
        for i in range(blocks["attn"]["wqkv"].shape[0]):
            def w(group, name):
                return blocks[group][name][i].float()

            y = F.layer_norm(x, (d,), w("ln1", "scale"), w("ln1", "bias"), eps)
            qkv = (y @ w("attn", "wqkv") + w("attn", "bqkv")).reshape(b, t, heads, 3, hd)
            q, k, v = (qkv[:, :, :, j].transpose(1, 2) for j in range(3))
            att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
            o = (att @ v).transpose(1, 2).reshape(b, t, d)
            x = x + w("ls1", "gamma") * (o @ w("attn", "wo") + w("attn", "bo"))
            y = F.layer_norm(x, (d,), w("ln2", "scale"), w("ln2", "bias"), eps)
            gate, up = (y @ w("mlp", "w12") + w("mlp", "b12")).chunk(2, dim=-1)
            x = x + w("ls2", "gamma") * ((F.silu(gate) * up) @ w("mlp", "w3") + w("mlp", "b3"))
        x = _norm(x, tree["ln_final"], eps)
        return x[:, 1 + reg.shape[0]:]
