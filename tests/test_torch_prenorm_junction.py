"""The pre-norm junction (ops/prenorm_junction.py, csrc/prenorm_junction.cu)
on the CPU: its plain form is the residual add then models/vit.py's
LayerNorm bit for bit; the encoder on CPU tensors is bitwise a frozen copy of
the block loop as it was before the junction (GELU, SwiGLU with registers
and LayerScale gammas, a class token, a residual head); the forward reaches
the op 2 depth + 1 times (2 head_depth + 1 more with a head) and the
trainer's spec never, differentiating through the plain form; the kernel's
pure-Python launch geometry. The kernel itself: tests/test_torch_cuda.py.
"""

import plain_dinov2 as plain
import pytest
import test_torch_tracker_e2e  # noqa: F401  (one intra-op thread a test worker)
import torch
import torch.nn.functional as F

from vitparticlefiltertracker_tpu_torch.models import jax_random
from vitparticlefiltertracker_tpu_torch.models import params as tparams
from vitparticlefiltertracker_tpu_torch.models import vit
from vitparticlefiltertracker_tpu_torch.models.vit import VitSpec, encode_tokens, vit_forward_tokens
from vitparticlefiltertracker_tpu_torch.ops import prenorm_junction as pj
from vitparticlefiltertracker_tpu_torch.ops.attention import reference_attention, split_fused_qkv
from vitparticlefiltertracker_tpu_torch.ops.swiglu import swiglu_plain

DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])


def _rows(shape, dtype, seed, scale=1.0):
    return (torch.randn(shape, generator=torch.Generator().manual_seed(seed)) * scale).to(dtype)


@DTYPES
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no-bias"])
@pytest.mark.parametrize("with_branch", [True, False], ids=["branch", "no-branch"])
def test_plain_junction_is_the_residual_add_then_layer_norm(dtype, with_branch, with_bias):
    """x + (branch + bias), then the LayerNorm (layer_norm_plain, held to
    its formula below): bit for bit, through the op on CPU tensors too
    (which counts no launch). A bias without its branch is refused: no
    caller leaves one pending alone."""
    m, d = 37, 64
    x = _rows((3, m, d), dtype, 1, 4.0)
    branch = _rows((3, m, d), dtype, 2) if with_branch else None
    bias = _rows((d,), dtype, 3) if with_bias else None
    ln = {"scale": 1.0 + 0.1 * _rows((d,), torch.float32, 4), "bias": 0.1 * _rows((d,), torch.float32, 5)}
    before = pj.prenorm_junction.launches
    if with_bias and not with_branch:
        for op in (pj.prenorm_junction_plain, pj.prenorm_junction):
            with pytest.raises(ValueError, match="bias comes with its branch"):
                op(x, branch, bias, ln["scale"], ln["bias"], dtype, 1e-6)
        return
    want_x = x
    if with_branch:
        want_x = want_x + (branch + bias if with_bias else branch)
    want_y = pj.layer_norm_plain(want_x, ln["scale"], ln["bias"], dtype, 1e-6)
    for op in (pj.prenorm_junction_plain, pj.prenorm_junction):
        got_x, got_y = op(x, branch, bias, ln["scale"], ln["bias"], dtype, 1e-6)
        assert got_x.dtype == got_y.dtype == dtype
        assert torch.equal(got_x, want_x) and torch.equal(got_y, want_y)
        if not with_branch:
            assert got_x is x
    assert pj.prenorm_junction.launches == before


def test_plain_layer_norm_keeps_its_formula():
    """f32 statistics, population variance, eps inside the rsqrt, then scale
    and shift, rounded once to the compute dtype; bf16 scale and shift (as a
    checkpoint may store them) promote to f32."""
    x = _rows((5, 48), torch.bfloat16, 6, 3.0)
    scale, shift = _rows((48,), torch.bfloat16, 7), _rows((48,), torch.bfloat16, 8)
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    want = ((xf - mu) * torch.rsqrt(var + 1e-5) * scale.float() + shift.float()).to(torch.bfloat16)
    assert torch.equal(pj.layer_norm_plain(x, scale, shift, torch.bfloat16, 1e-5), want)


@pytest.mark.parametrize("head", [False, True], ids=["trunk", "head"])
def test_cast_for_inference_widens_layer_norms_exactly(head):
    """cast_for_inference leaves every LayerNorm's scale and bias in f32 (the
    kernel's one parameter form), the same values as stored in bf16 (as the
    committed ViT-B/16 checkpoint holds them), and the bf16 forward on the
    cast tree is bitwise the forward with the bf16 parameters."""
    spec = GELU._replace(dtype=torch.bfloat16, head_depth=2 if head else 0)
    tree = tparams._map(tparams.init_vit_params(jax_random.key(7), spec), lambda t: t.to(torch.bfloat16))
    cast = tparams.cast_for_inference(tree, spec)
    lns = [("blocks", "ln1"), ("blocks", "ln2"), ("ln_final",)] + ([("head", "blocks", "ln1"), ("head", "ln")] if head
                                                                  else [])
    for path in lns:
        got, want = cast, tree
        for k in path:
            got, want = got[k], want[k]
        for k in ("scale", "bias"):
            assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k].float()), path
    bf16_lns = dict(cast, ln_final=tree["ln_final"], blocks=dict(cast["blocks"], ln1=tree["blocks"]["ln1"],
                                                                 ln2=tree["blocks"]["ln2"]))
    if head:
        bf16_lns["head"] = dict(cast["head"], ln=tree["head"]["ln"],
                                blocks=dict(cast["head"]["blocks"], ln1=tree["head"]["blocks"]["ln1"],
                                            ln2=tree["head"]["blocks"]["ln2"]))
    x = _rows((2, spec.num_patches, spec.dim), torch.bfloat16, 11)
    assert torch.equal(encode_tokens(cast, x, spec), encode_tokens(bf16_lns, x, spec))


# -- the encoder, bitwise as it was before the junction


def _frozen_encode_tokens(params, x, spec):
    """models/vit.py's encode_tokens as it was before the junction (a frozen
    copy): each LayerNorm on the finished stream, each residual added as
    x + (y @ w + bias), times the LayerScale gamma where the tree holds one."""
    dtype = spec.dtype

    def ln(x, p):
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + spec.ln_eps)
        return (y * p["scale"] + p["bias"]).to(dtype)

    def scaled(branch, ls):
        return branch if ls is None else branch * ls["gamma"].to(branch.dtype)

    def block(x, p):
        b, t, _ = x.shape
        y = ln(x, p["ln1"])
        qkv = y @ p["attn"]["wqkv"].to(dtype) + p["attn"]["bqkv"].to(dtype)
        o = reference_attention(*split_fused_qkv(qkv, spec.heads)).transpose(1, 2).reshape(b, t, -1)
        x = x + scaled(o @ p["attn"]["wo"].to(dtype) + p["attn"]["bo"].to(dtype), p.get("ls1"))
        y = ln(x, p["ln2"])
        mlp = p["mlp"]
        if spec.ffn == "swiglu":
            y = swiglu_plain(y @ mlp["w12"].to(dtype) + mlp["b12"].to(dtype))
            return x + scaled(y @ mlp["w3"].to(dtype) + mlp["b3"].to(dtype), p.get("ls2"))
        y = F.gelu(y @ mlp["w1"].to(dtype) + mlp["b1"].to(dtype), approximate="none")
        return x + scaled(y @ mlp["w2"].to(dtype) + mlp["b2"].to(dtype), p.get("ls2"))

    def layers(blocks, n):
        return [{g: {k: w[i] for k, w in leaves.items()} for g, leaves in blocks.items()} for i in range(n)]

    b = x.shape[0]
    if spec.use_cls_token:
        x = torch.cat([params["cls_token"].to(dtype).expand(b, 1, spec.dim), x], dim=1)
    if spec.use_pos_embed:
        x = x + params["pos_embed"].to(dtype)[None, : x.shape[1]]
    if spec.registers:
        cls_part = 1 if spec.use_cls_token else 0
        reg = params["reg_tokens"].to(dtype).expand(b, spec.registers, spec.dim)
        x = torch.cat([x[:, :cls_part], reg, x[:, cls_part:]], dim=1)
    for p in layers(params["blocks"], spec.depth):
        x = block(x, p)
    trunk = ln(x, params["ln_final"])
    if spec.head_depth <= 0:
        return trunk
    for p in layers(params["head"]["blocks"], spec.head_depth):
        x = block(x, p)
    return torch.cat([trunk, ln(x, params["head"]["ln"])], dim=-1)


GELU = VitSpec(depth=3, dim=64, heads=2, mlp_dim=128, patch_size=8, image_size=32, dtype=torch.float32)
# name -> (spec, tree maker): the GELU ViT without and with a class token
# (and position embedding), with a residual head, and DINOv2's SwiGLU block
# with a class token and registers, its LayerScale gammas folded or held.
CASES = {
    "gelu": (GELU._replace(use_pos_embed=False), "vit"),
    "gelu-cls": (GELU._replace(use_cls_token=True), "vit"),
    "gelu-head": (GELU._replace(head_depth=2), "vit"),
    "swiglu-registers": (VitSpec(depth=3, dim=128, heads=2, mlp_dim=256, patch_size=14, image_size=56,
                                 dtype=torch.float32, use_cls_token=True, use_pos_embed=False, ffn="swiglu",
                                 registers=2), "dinov2"),
    "swiglu-gammas": (VitSpec(depth=3, dim=128, heads=2, mlp_dim=256, patch_size=14, image_size=56,
                              dtype=torch.float32, use_cls_token=True, use_pos_embed=False, ffn="swiglu",
                              registers=2), "dinov2-gammas"),
}


def _case(name, dtype):
    spec, kind = CASES[name]
    spec = spec._replace(dtype=dtype)
    if kind == "vit":
        tree = tparams.init_vit_params(jax_random.key(5), spec)
    else:
        tree = plain.draw_tree(9, spec.depth, spec.dim, spec.heads, spec.mlp_dim, spec.patch_size, spec.registers)
    prm = tree if kind == "dinov2-gammas" else tparams.cast_for_inference(tree, spec)
    if kind == "dinov2-gammas":
        assert "ls1" in prm["blocks"]
    x = _rows((2, spec.num_patches, spec.dim), dtype, 10)
    return spec, prm, x


@DTYPES
@pytest.mark.parametrize("name", list(CASES))
def test_encode_tokens_is_bitwise_the_frozen_block_loop(name, dtype):
    spec, prm, x = _case(name, dtype)
    got = encode_tokens(prm, x, spec)
    assert got.shape == (2, spec.num_prefix + spec.num_patches, spec.out_dim) and got.dtype == dtype
    assert torch.equal(got, _frozen_encode_tokens(prm, x, spec))


def _junction_calls(monkeypatch) -> list:
    """The (M, D, pending branch, pending bias) of every call the forward
    makes to the op (which on CPU tensors runs its plain form)."""
    calls, op = [], pj.prenorm_junction

    def counted(x, branch, bias, scale, shift, dtype, eps):
        calls.append((x.numel() // x.shape[-1], x.shape[-1], branch is not None, bias is not None))
        return op(x, branch, bias, scale, shift, dtype, eps)

    monkeypatch.setattr(vit, "prenorm_junction", counted)
    return calls


@pytest.mark.parametrize("name", ["gelu", "gelu-head", "swiglu-registers", "swiglu-gammas"])
def test_forward_reaches_the_junction_twice_a_block_and_once_a_final_norm(name, monkeypatch):
    """2 depth + 1 calls (2 head_depth + 1 more with a head): the first of the
    trunk's and of the head's with nothing pending, every other with the
    branch before it; its bias pending too unless a LayerScale gamma took it
    into the branch."""
    spec, prm, x = _case(name, torch.float32)
    calls = _junction_calls(monkeypatch)
    encode_tokens(prm, x, spec)
    m = 2 * (spec.num_prefix + spec.num_patches)
    gammas = "ls1" in prm["blocks"]
    trunk = [(m, spec.dim, False, False)] + [(m, spec.dim, True, not gammas)] * (2 * spec.depth)
    head = [(m, spec.dim, False, False)] + [(m, spec.dim, True, True)] * (2 * spec.head_depth)
    assert calls == trunk + (head if spec.head_depth else [])


def test_trainer_spec_differentiates_through_the_plain_form(monkeypatch):
    """use_flash_attention False (the trainer's spec): the forward never
    reaches the op, and autograd reaches every LayerNorm leaf and the
    biases the junctions add; the op itself refuses a tensor that requires
    grad."""
    spec = GELU._replace(use_flash_attention=False, head_depth=1)
    prm = tparams.init_vit_params(jax_random.key(3), spec)
    leaves = [prm["blocks"]["ln1"]["scale"], prm["blocks"]["ln2"]["bias"], prm["ln_final"]["scale"],
              prm["head"]["ln"]["bias"], prm["blocks"]["attn"]["bo"], prm["blocks"]["mlp"]["b2"]]
    for leaf in leaves:
        leaf.requires_grad_(True)
    calls = _junction_calls(monkeypatch)
    images = _rows((2, 32, 32, 3), torch.float32, 12)
    out = vit_forward_tokens(prm, images, spec)
    assert not calls
    out.square().mean().backward()
    for leaf in leaves:
        assert leaf.grad is not None and torch.isfinite(leaf.grad).all() and leaf.grad.abs().sum() > 0
    x = torch.zeros(4, 64, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        pj.prenorm_junction(x, None, None, torch.ones(64), torch.zeros(64), torch.float32, 1e-6)


@pytest.mark.parametrize("m,d,dtype,want", [
    (3136, 768, torch.bfloat16, (3, 4, 784)),  # b16-serve16: 16 windows of 196
    (4096, 768, torch.bfloat16, (3, 4, 1024)),  # the crop path's particles
    (196, 1024, torch.bfloat16, (4, 1, 196)),  # l16: a window
    (261, 1536, torch.bfloat16, (6, 1, 261)),  # g14reg: 256 patches, a class token, 4 registers
    (196, 768, torch.float32, (6, 1, 196)),  # eval1's f32 ViT-B/16
    (392, 1024, torch.bfloat16, (4, 2, 196)),  # 2 rows a block still give every SM one
    (38, 64, torch.bfloat16, (1, 1, 38)),  # the tests' small widths: a masked lane
    (38, 128, torch.bfloat16, (1, 1, 38)),
    (38, 32, torch.float32, (1, 1, 38)),
    (5, 1408, torch.bfloat16, (6, 1, 5)),  # ViT-g/14 of Zhai et al.: 5.5 vectors a lane, masked
    (1, 2048, torch.float32, (16, 1, 1)),
])
def test_launch_geometry(m, d, dtype, want):
    """A warp a row holding the smallest instance's vectors that cover D; 4
    rows a block while that leaves a block for every one of 132 SMs, else
    2, else 1."""
    assert tuple(pj.launch_geometry(m, d, dtype, sms=132)) == want


def test_launch_geometry_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="multiple of 8"):
        pj.launch_geometry(4, 100, torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 4"):
        pj.launch_geometry(4, 102, torch.float32)
    with pytest.raises(ValueError, match="wider"):
        pj.launch_geometry(4, 4104, torch.bfloat16)
    assert pj.launch_geometry(4, 4096, torch.bfloat16).vpl == 16


def test_every_configured_width_fits_the_kernel():
    """Every ViT preset the port ships, every configuration under configs/
    and every benchmark configuration, in both compute dtypes: the width
    has a geometry."""
    import json
    from pathlib import Path

    from vitparticlefiltertracker_tpu_torch.config import VIT_PRESETS, load_config

    root = Path(__file__).resolve().parent.parent
    widths = {p["dim"] for p in VIT_PRESETS.values()}
    widths |= {load_config(str(f)).model.dim for f in (root / "configs").glob("*.yaml")}
    widths |= {json.loads(f.read_text())["dims"]["dim"] for f in (root / "portbench" / "configs").glob("*.json")}
    assert {192, 384, 768, 1024, 1536} <= widths
    for d in sorted(widths):
        for dtype in (torch.float32, torch.bfloat16):
            assert pj.launch_geometry(196, d, dtype).vpl * 32 * pj._VEC[dtype] >= d
