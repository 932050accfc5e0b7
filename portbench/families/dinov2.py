"""DINOv2 with registers (Oquab et al., arXiv:2304.07193; Darcet et al.,
arXiv:2309.16588): pre-LN blocks with LayerScale on both residual branches
and a fused SwiGLU FFN, the sequence [class token, registers, patches] with
no position embedding (the tracker's dense convention for every backbone),
the tracker's dense features the patch grid's tokens after the final norm.

The four functions every family module has (``harness.load_family``):
``weights``, ``tokens``, ``flops_per_frame``, ``attention``. ``dims`` holds
``depth``, ``dim``, ``heads``, ``mlp_dim`` (the SwiGLU hidden width),
``patch_size``, ``image_size`` and ``registers``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench import counts
from portbench.reference.layers import Quant, layer_norm, mm
from portbench.weights import generator, truncnormal

GAMMA_RANGE = (0.1, 1.0)  # LayerScale gammas, uniform (not DINOv2's training init of 1e-5: see weights)


def weights(seed: int, dims: dict, device) -> dict:
    """The tracker's DINOv2 tree for `dims` from `seed`, with the program's
    random init distributions (models/params.py ``init_vit_params``):
    weights truncated normal on [-2, 2] sigma at fan_in^-1/2 (patch embed
    (p*p*3)^-1/2, qkv, out and w12 d^-1/2, w3 mlp^-1/2), class token and
    registers at 0.02, biases zero, layer norms one and zero. LayerScale
    gammas are uniform on GAMMA_RANGE, a channel each: at DINOv2's training
    init of 1e-5 every branch would vanish and no comparison could see a
    wrong block. The stacked leaves are drawn a block at a time, so the
    float64 draw of the largest (w12, 2 mlp x d) stays small beside the
    tree."""
    g = generator(seed, device)
    depth, d, mlp, p, regs = (dims[k] for k in ("depth", "dim", "mlp_dim", "patch_size", "registers"))
    patch_in = p * p * 3

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    def ones(*shape):
        return torch.ones(shape, device=device)

    def stacked(shape, std):
        out = torch.empty((depth, *shape), device=device)
        for i in range(depth):
            out[i] = truncnormal(g, shape, std, device)
        return out

    def gammas():
        lo, hi = GAMMA_RANGE
        return lo + (hi - lo) * torch.rand((depth, d), generator=g, device=device)

    return {
        "patch_embed": {"kernel": truncnormal(g, (patch_in, d), patch_in ** -0.5, device), "bias": zeros(d)},
        "cls_token": truncnormal(g, (d,), 0.02, device),
        "reg_tokens": truncnormal(g, (regs, d), 0.02, device),
        "ln_final": {"scale": ones(d), "bias": zeros(d)},
        "blocks": {
            "ln1": {"scale": ones(depth, d), "bias": zeros(depth, d)},
            "attn": {"wqkv": stacked((d, 3 * d), d ** -0.5), "bqkv": zeros(depth, 3 * d),
                     "wo": stacked((d, d), d ** -0.5), "bo": zeros(depth, d)},
            "ls1": {"gamma": gammas()},
            "ln2": {"scale": ones(depth, d), "bias": zeros(depth, d)},
            "mlp": {"w12": stacked((d, 2 * mlp), d ** -0.5), "b12": zeros(depth, 2 * mlp),
                    "w3": stacked((mlp, d), mlp ** -0.5), "b3": zeros(depth, d)},
            "ls2": {"gamma": gammas()},
        },
    }


def tokens(params: dict, images: torch.Tensor, rc, quant: Quant = None) -> torch.Tensor:
    """Normalized images [B, S, S, 3] -> grid token features [B, g*g, D]
    after the final LN, the class token and the registers dropped: patches
    in (row, column, channel) order, then [cls, registers, patches], each
    block x + gamma1 (attn(LN x) W_o + b_o), x + gamma2 (SwiGLU(LN x) W_3 +
    b_3) with SwiGLU(y) = silu(y W_12[:, :h] + b) * (y W_12[:, h:] + b);
    the fused qkv columns are head-major (head, q/k/v, head dim). Every
    product goes through ``mm``, so the control rounds its operands."""
    dims = rc.dims
    b, s, _, c = images.shape
    p, d, h, regs = dims["patch_size"], dims["dim"], dims["heads"], dims["registers"]
    g, hd = s // p, d // h
    x = images.reshape(b, g, p, g, p, c).permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, p * p * c)
    x = mm(x, params["patch_embed"]["kernel"].float(), quant) + params["patch_embed"]["bias"].float()
    prefix = torch.cat([params["cls_token"].float()[None], params["reg_tokens"].float()])
    x = torch.cat([prefix.expand(b, -1, -1), x], dim=1)
    t = x.shape[1]
    blocks = params["blocks"]
    for i in range(dims["depth"]):
        def w(group: str, name: str) -> torch.Tensor:
            return blocks[group][name][i].float()

        y = layer_norm(x, w("ln1", "scale"), w("ln1", "bias"), rc.ln_eps)
        qkv = (mm(y, w("attn", "wqkv"), quant) + w("attn", "bqkv")).reshape(b, t, h, 3, hd)
        q, k, v = (qkv[:, :, :, j].transpose(1, 2) for j in range(3))  # [B, H, T, hd]
        att = torch.softmax(mm(q, k.transpose(-1, -2), quant) / math.sqrt(hd), dim=-1)
        o = mm(att, v, quant).transpose(1, 2).reshape(b, t, d)
        x = x + w("ls1", "gamma") * (mm(o, w("attn", "wo"), quant) + w("attn", "bo"))
        y = layer_norm(x, w("ln2", "scale"), w("ln2", "bias"), rc.ln_eps)
        gate, up = (mm(y, w("mlp", "w12"), quant) + w("mlp", "b12")).chunk(2, dim=-1)
        x = x + w("ls2", "gamma") * (mm(F.silu(gate) * up, w("mlp", "w3"), quant) + w("mlp", "b3"))
    x = layer_norm(x, params["ln_final"]["scale"].float(), params["ln_final"]["bias"].float(), rc.ln_eps)
    return x[:, 1 + regs:]


def flops_per_frame(dims: dict, tracker_config: dict) -> float:
    """Matmul FLOPs of one dense tracking step of one filter: the forward of
    the search window over T = g*g + 1 + registers tokens (2 FLOPs a MAC:
    per token and block 8 d^2 for qkv and out, 4 T d for QK^T and PV, 6 d
    mlp for w12 (2 mlp columns) and w3), the patch embedding of the g*g
    patches, and the ROI cell scoring (``counts.scoring_flops``)."""
    d, mlp, depth, p = dims["dim"], dims["mlp_dim"], dims["depth"], dims["patch_size"]
    g = tracker_config["model"]["image_size"] // p
    t = g * g + 1 + dims["registers"]
    vit = depth * t * (8 * d * d + 4 * t * d + 6 * d * mlp) + g * g * 2 * (p * p * 3) * d
    return float(vit + counts.scoring_flops(g, d, tracker_config))


def attention(dims: dict, tracker_config: dict) -> tuple[int, int, int]:
    """(heads, tokens, head dim) of K1's launch for one search window: the
    grid's patches, the class token and the registers."""
    g = tracker_config["model"]["image_size"] // dims["patch_size"]
    return dims["heads"], g * g + 1 + dims["registers"], dims["dim"] // dims["heads"]
