"""DINOv2 ViT-g/14 with registers as the port's backbone (config preset
``dinov2-g14-reg``: SwiGLU FFN, class token and registers; LayerScale where
the weights hold its gammas), on the CPU at a tiny size: the port's dense
features against the plain float32 forward of tests/plain_dinov2.py,
planted faults that the comparison catches, the SwiGLU op's plain form and
its calls a forward (its kernel's launches are counted on the card:
tests/test_torch_cuda.py), the new leaves
through init, the inference cast, the npz files and the "model" mesh's
slices, the benchmark's DINOv2 family against the same plain forward, and
the GELU presets' forward bitwise as it was before the DINOv2 block existed.
"""

import copy
import math
from collections import Counter

import numpy as np
import plain_dinov2 as plain
import pytest
import test_torch_tracker_e2e  # noqa: F401  (one intra-op thread a test worker)
import torch
import torch.nn.functional as F
import torch_mesh_workers as W

from vitparticlefiltertracker_tpu_torch.config import PORT_MODEL_DEFAULTS, VIT_PRESETS, Config
from vitparticlefiltertracker_tpu_torch.models import jax_random
from vitparticlefiltertracker_tpu_torch.models import params as tparams
from vitparticlefiltertracker_tpu_torch.models.embedder import (
    DenseEmbedSpec,
    grid_tokens,
    make_dense_embedder,
    normalize_window,
    score_from_feat,
)
from vitparticlefiltertracker_tpu_torch.models.vit import VitSpec, patchify, vit_forward_tokens
from vitparticlefiltertracker_tpu_torch.ops import swiglu as sg
from vitparticlefiltertracker_tpu_torch.ops.attention import reference_attention, split_fused_qkv
from vitparticlefiltertracker_tpu_torch.ops.image import full_view, view_extract_window_mxu
from vitparticlefiltertracker_tpu_torch.parallel import mesh as tmesh

# The tiny DINOv2: 4 blocks, width 128, 2 heads of 64, FFN 256, patch 14, 2
# registers, 56-px windows (a 4 x 4 grid, T 19).
DEPTH, DIM, HEADS, FFN, PATCH, REGS, IMAGE = 4, 128, 2, 256, 14, 2, 56
SPEC = VitSpec(depth=DEPTH, dim=DIM, heads=HEADS, mlp_dim=FFN, patch_size=PATCH, image_size=IMAGE,
               dtype=torch.float32, use_cls_token=True, use_pos_embed=False, ffn="swiglu", registers=REGS)
# Tolerances on the features (unit scale after the final norm).
# f32: the port and the plain forward take their products and norms in other
# orders (a convolution against a patch product, four blocks): about 3e-6
# max abs observed; 1e-4 leaves 30x.
F32_MAX_ABS = 1e-4
# bf16 against the f32 plain forward: relative RMS error of the features.
# bf16 keeps 8 bits (0.4 % a rounding) and the path rounds about two dozen
# times; 0.009 observed at this size, folded or not; 0.03 leaves over 3x,
# and each planted fault below reads 0.14 or more.
BF16_REL_RMS = 0.03


def _tree(seed=7):
    return plain.draw_tree(seed, DEPTH, DIM, HEADS, FFN, PATCH, REGS)


def _images(b=2, seed=1):
    return torch.randn(b, IMAGE, IMAGE, 3, generator=torch.Generator().manual_seed(seed))


def _port(tree, images, dtype, fold=True, **spec_kw):
    spec = SPEC._replace(dtype=dtype, **spec_kw)
    prm = tparams.cast_for_inference(tree, spec) if fold else tree
    return grid_tokens(vit_forward_tokens(prm, images, spec), spec).float()


def _rel_rms(got, want):
    return float((got - want).norm() / want.norm())


@pytest.mark.parametrize("fold", [True, False], ids=["folded", "gammas"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_dense_features_match_the_plain_forward(dtype, fold):
    tree, images = _tree(), _images()
    want = plain.forward(tree, images, HEADS, PATCH)
    got = _port(tree, images, dtype, fold)
    assert got.shape == want.shape == (2, (IMAGE // PATCH) ** 2, DIM)
    if dtype == torch.float32:
        assert float((got - want).abs().max()) < F32_MAX_ABS
    else:
        assert _rel_rms(got, want) < BF16_REL_RMS


def _no_gamma2_in_block_1(tree):
    tree["blocks"]["ls2"]["gamma"][1] = 1.0
    return tree, {}


def _gate_and_up_swapped(tree):
    for k in ("w12", "b12"):
        gate, up = tree["blocks"]["mlp"][k].chunk(2, dim=-1)
        tree["blocks"]["mlp"][k] = torch.cat([up, gate], dim=-1)
    return tree, {}


def _registers_left_out(tree):
    del tree["reg_tokens"]
    return tree, {"registers": 0}


@pytest.mark.parametrize("plant", [_no_gamma2_in_block_1, _gate_and_up_swapped, _registers_left_out],
                         ids=["gamma2-left-out", "gate-up-swapped", "registers-left-out"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_planted_faults_fail_the_comparison(dtype, plant):
    tree, images = _tree(), _images()
    want = plain.forward(tree, images, HEADS, PATCH)
    broken, spec_kw = plant(copy.deepcopy(tree))
    got = _port(broken, images, dtype, **spec_kw)
    # Each fails the looser (bf16) limit, and so the f32 one too.
    assert _rel_rms(got, want) > BF16_REL_RMS
    assert float((got - want).abs().max()) > F32_MAX_ABS


def test_prefix_dropped_and_grid_order_kept():
    """The encoder's output is [cls, registers, grid]; grid_tokens keeps the
    grid's row-major tokens, and the dense embedder scores from them: its
    scores equal score_from_feat on the plain forward's grid."""
    tree = _tree()
    spec = SPEC
    prm = tparams.cast_for_inference(tree, spec)
    images = _images(1)
    out = vit_forward_tokens(prm, images, spec)
    assert out.shape == (1, 1 + REGS + 16, DIM)
    assert torch.equal(grid_tokens(out, spec), out[:, 1 + REGS:])
    # A feature that differs by grid cell: the token of cell (r, c) is the
    # r * 4 + c'th of the grid, as the plain forward's convolution orders it.
    torch.testing.assert_close(grid_tokens(out, spec), plain.forward(tree, images, HEADS, PATCH), atol=F32_MAX_ABS,
                               rtol=0)
    es = DenseEmbedSpec(vit=spec, s_img=IMAGE, patch=PATCH, appearance="cells", roi_grid=3, center_features=True)
    g = torch.Generator().manual_seed(5)
    frame = torch.rand(96, 128, 3, generator=g) * 255.0
    center, side = torch.tensor([60.0, 50.0]), torch.tensor(70.0)
    pool = make_dense_embedder(prm, frame, center, side, es)
    window = normalize_window(view_extract_window_mxu(full_view(frame), center, side, IMAGE))
    feat = plain.forward(tree, window.reshape(1, IMAGE, IMAGE, 3), HEADS, PATCH)[0]
    boxes_xy = torch.tensor([[60.0, 50.0], [45.0, 40.0], [75.0, 62.0]])
    boxes_wh = torch.tensor([[20.0, 20.0], [16.0, 24.0], [30.0, 18.0]])
    tmpl, _ = pool(boxes_xy[:1], boxes_wh[:1])
    tmpl = F.normalize(tmpl[0].reshape(-1), dim=-1).reshape(tmpl.shape[1:])
    got, _ = pool.score(tmpl, boxes_xy, boxes_wh)
    want, _ = score_from_feat(feat.reshape(4, 4, DIM), feat.mean(dim=0), center[None], side[None, None], es, tmpl,
                              boxes_xy, boxes_wh)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_swiglu_plain_form_is_silu_times_up(dtype):
    g = torch.Generator().manual_seed(3)
    a, b = (torch.randn(5, 7, 64, generator=g) * 4).to(dtype), torch.randn(5, 7, 64, generator=g).to(dtype)
    out = sg.swiglu(torch.cat([a, b], dim=-1))
    assert out.dtype == dtype and out.shape == (5, 7, 64)
    assert torch.equal(out, (F.silu(a.float()) * b.float()).to(dtype))
    assert torch.equal(sg.swiglu_plain(torch.cat([a, b], dim=-1)), out)


def test_swiglu_refuses_grad_and_plans_its_grid():
    x = torch.zeros(2, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        sg.swiglu(x)
    # A thread a 16-byte group of output columns, 8 blocks of 256 a SM at most.
    assert sg.launch_blocks(261, 4096, torch.bfloat16) == 522
    assert sg.launch_blocks(261, 4096, torch.float32) == 1044
    assert sg.launch_blocks(16 * 261, 4096, torch.bfloat16) == 132 * 8
    assert sg.launch_blocks(1, 8, torch.bfloat16) == 1


def _gate_calls(monkeypatch) -> Counter:
    """The SwiGLU op's calls on CPU tensors by (M, h), counted where it runs
    its plain form: the op counts launches of its kernel alone."""
    calls, plain_form = Counter(), sg.swiglu_plain

    def counted(x):
        calls[(x.numel() // x.shape[-1], x.shape[-1] // 2)] += 1
        return plain_form(x)

    monkeypatch.setattr(sg, "swiglu_plain", counted)
    return calls


def test_swiglu_launches_count_depth_a_forward(monkeypatch):
    """The forward calls the SwiGLU op once a block at (M, h); on the CPU it
    runs the plain form and counts no launch."""
    calls = _gate_calls(monkeypatch)
    prm = tparams.cast_for_inference(_tree(), SPEC)
    before = sg.swiglu.launches
    vit_forward_tokens(prm, _images(), SPEC)
    assert calls == {(2 * (1 + REGS + 16), FFN): DEPTH}
    assert sg.swiglu.launches == before
    # The trainer's spec (plain attention) takes the plain, differentiable
    # gate directly, not the op.
    vit_forward_tokens(prm, _images(), SPEC._replace(use_flash_attention=False))
    assert sum(calls.values()) == DEPTH and sg.swiglu.launches == before


def test_fold_layer_scale_is_the_branch_times_gamma():
    tree = _tree()
    folded = tparams.fold_layer_scale(tree["blocks"])
    assert "ls1" not in folded and "ls2" not in folded
    g1, g2 = tree["blocks"]["ls1"]["gamma"], tree["blocks"]["ls2"]["gamma"]
    torch.testing.assert_close(folded["attn"]["wo"], tree["blocks"]["attn"]["wo"] * g1[:, None, :])
    torch.testing.assert_close(folded["mlp"]["b3"], tree["blocks"]["mlp"]["b3"] * g2)
    cast = tparams.cast_for_inference(tree, SPEC._replace(dtype=torch.bfloat16))
    assert cast["reg_tokens"].dtype == cast["cls_token"].dtype == torch.bfloat16
    assert cast["blocks"]["mlp"]["w12"].dtype == torch.bfloat16 and "ls1" not in cast["blocks"]
    assert cast["blocks"]["ln1"]["scale"].dtype == torch.float32


def test_init_draws_the_new_leaves():
    prm = tparams.init_vit_params(jax_random.key(3), SPEC)
    assert prm["reg_tokens"].shape == (REGS, DIM) and prm["cls_token"].shape == (DIM,)
    assert prm["pos_embed"].shape == (16 + 1, DIM)  # the class token and the patches; registers take none
    mlp = prm["blocks"]["mlp"]
    assert set(mlp) == {"w12", "b12", "w3", "b3"}
    assert mlp["w12"].shape == (DEPTH, DIM, 2 * FFN) and mlp["w3"].shape == (DEPTH, FFN, DIM)
    # No LayerScale gammas: a random tree runs each branch unscaled.
    assert "ls1" not in prm["blocks"] and "ls2" not in prm["blocks"]
    # The registers come from the spare key 3: the other leaves are the GELU
    # tree's draws on the same keys.
    gelu = tparams.init_vit_params(jax_random.key(3), SPEC._replace(ffn="gelu", registers=0))
    assert torch.equal(prm["cls_token"], gelu["cls_token"])
    assert torch.equal(prm["blocks"]["attn"]["wqkv"], gelu["blocks"]["attn"]["wqkv"])
    assert not torch.equal(prm["reg_tokens"][0], prm["cls_token"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_npz_round_trip_keeps_every_new_leaf(tmp_path, dtype):
    tree = tparams._map(_tree(), lambda x: x.to(dtype))
    path = str(tmp_path / "dinov2.npz")
    tparams.save_params(path, tree)
    back = tparams.load_params(path)
    want, got = tparams._flatten(tree), tparams._flatten(back)
    assert set(got) == set(want)
    for k in ("cls_token", "reg_tokens", "blocks/ls1/gamma", "blocks/ls2/gamma", "blocks/mlp/w12",
              "blocks/mlp/b12", "blocks/mlp/w3", "blocks/mlp/b3"):
        assert k in got
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_config_preset_and_keys():
    cfg = Config.from_dict({"model": {"variant": "dinov2-g14-reg"}})
    m = cfg.model
    assert (m.depth, m.dim, m.heads, m.mlp_dim, m.patch_size) == (40, 1536, 24, 4096, 14)
    assert (m.ffn, m.registers, m.drop_cls_token, m.ln_eps) == ("swiglu", 4, False, 1e-6)
    spec = DenseEmbedSpec.from_config(cfg).vit
    assert spec.num_prefix == 5 and spec.grid == 16 and not spec.use_pos_embed
    # The GELU presets keep the defaults of the new keys.
    for name in ("vit-t16", "vit-s16", "vit-b16", "vit-l16"):
        m = Config.from_dict({"model": {"variant": name}}).model
        assert {k: getattr(m, k) for k in PORT_MODEL_DEFAULTS} == PORT_MODEL_DEFAULTS
        assert not set(VIT_PRESETS[name]) & set(PORT_MODEL_DEFAULTS)
    for bad in ({"ffn": "relu"}, {"registers": -1}):
        with pytest.raises(ValueError):
            Config.from_dict({"model": {"variant": "custom", **bad}})


TINY_CFG = {
    "model": {"variant": "custom", "depth": 2, "dim": 128, "heads": 2, "mlp_dim": 256, "patch_size": 14,
              "image_size": 56, "dtype": "float32", "checkpoint": "", "ffn": "swiglu", "registers": 2,
              "drop_cls_token": False},
    "filter": {"num_particles": 64},
}


def test_dense_tracker_runs_on_a_dinov2_backbone(monkeypatch):
    from vitparticlefiltertracker_tpu_torch.io.video import open_source
    from vitparticlefiltertracker_tpu_torch.runtime.tracker import Tracker

    calls = _gate_calls(monkeypatch)
    cfg = Config.from_dict(copy.deepcopy(TINY_CFG))
    src = open_source("synthetic:moving-square", 5, (224, 224))
    before = sg.swiglu.launches
    recs = list(Tracker(cfg, device="cpu").run(src))
    # depth x (init + 4 steps), each at one window's 16 + 1 + 2 tokens; none launched on the CPU.
    assert len(recs) == 4 and calls == {(19, 256): 2 * 5} and sg.swiglu.launches == before
    assert np.all(np.isfinite([r["position"] for r in recs])) and np.all(np.isfinite([r["conf"] for r in recs]))


# -- "model" tensor parallelism


def _unjoined(model, rank):
    return tmesh.Mesh(tmesh.AXES, (1, 1, model), rank, {}, "gloo", 0)


def test_vit_param_shard_cuts_w12_as_matching_halves():
    tree = _tree()
    w12, b12 = tree["blocks"]["mlp"]["w12"], tree["blocks"]["mlp"]["b12"]
    for rank in range(2):
        part = tmesh.vit_param_shard(_unjoined(2, rank), tree)["blocks"]
        cols = torch.arange(rank * FFN // 2, (rank + 1) * FFN // 2)
        assert torch.equal(part["mlp"]["w12"], torch.cat([w12[..., cols], w12[..., FFN + cols]], dim=-1))
        assert torch.equal(part["mlp"]["b12"], torch.cat([b12[..., cols], b12[..., FFN + cols]], dim=-1))
        assert torch.equal(part["mlp"]["w3"], tree["blocks"]["mlp"]["w3"][:, cols])
        assert part["ls2"]["gamma"] is tree["blocks"]["ls2"]["gamma"]
        assert part["mlp"]["b3"] is tree["blocks"]["mlp"]["b3"]


def test_model_mesh_of_two_is_the_unsharded_forward():
    """Two gloo ranks on "model" 2, each with its slices of the folded f32
    tree: the forward equals the unsharded one. A rank's products over half
    the heads and hidden columns round otherwise than the whole product's,
    so the tolerance is f32 rounding (the mesh tests' own: 1e-5)."""
    tree = tparams.cast_for_inference(_tree(), SPEC)
    tree_np = tparams._map(tree, lambda x: x.numpy())
    images = _images().numpy()
    spec_kw = {k: v for k, v in SPEC._asdict().items() if k != "mesh"}
    ranks = W.spawn(2, W.dinov2_tp_forward, tree_np, spec_kw, images)
    want = vit_forward_tokens(tree, torch.from_numpy(images), SPEC).numpy()
    for got in ranks:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# -- the benchmark's DINOv2 family


def _family():
    from portbench import harness

    return harness.load_family("dinov2")


def test_benchmark_family_tokens_are_the_plain_forward():
    from portbench.reference import step as ref

    fam = _family()
    dims = {"depth": DEPTH, "dim": DIM, "heads": HEADS, "mlp_dim": FFN, "patch_size": PATCH, "image_size": IMAGE,
            "registers": REGS}
    tc = {"model": {"image_size": IMAGE, "ln_eps": 1e-6}, "filter": {}, "tracker": {}}

    class Rc:  # what a family's tokens reads of the reference's configuration
        pass

    rc = Rc()
    rc.dims, rc.ln_eps = dims, tc["model"]["ln_eps"]
    tree, images = _tree(), _images()
    with ref.full_f32():
        got = fam.tokens(tree, images, rc)
    torch.testing.assert_close(got, plain.forward(tree, images, HEADS, PATCH), atol=F32_MAX_ABS, rtol=0)
    # Its own seeded tree runs through the port as the program loads it.
    drawn = fam.weights(2**33 + 5, dims, "cpu")
    assert 0.1 <= float(drawn["blocks"]["ls1"]["gamma"].min()) and float(drawn["blocks"]["ls2"]["gamma"].max()) <= 1.0
    with ref.full_f32():
        want = fam.tokens(drawn, images, rc)
    assert float((_port(drawn, images, torch.float32) - want).abs().max()) < F32_MAX_ABS


def test_benchmark_family_counts_and_attention_shape():
    from portbench import harness

    fam = _family()
    wl, cfg = harness.cell_files("g14reg-offline-1080p")
    assert cfg["family"] == "dinov2" and wl["config"] == "dinov2-g14reg-dense-4k"
    dims, tc = cfg["dims"], cfg["tracker_config"]
    assert fam.attention(dims, tc) == (24, 261, 64)
    d, h, t = 1536, 4096, 261
    vit = 40 * t * (8 * d * d + 4 * t * d + 6 * d * h) + 256 * 2 * (14 * 14 * 3) * d
    assert vit == 608_349_044_736
    assert fam.flops_per_frame(dims, tc) == 629_488_336_896
    # The configuration runs the preset at its published widths.
    m = Config.from_dict(copy.deepcopy(tc)).model
    assert {k: getattr(m, k) for k in ("depth", "dim", "heads", "mlp_dim", "patch_size", "registers")} == \
        {k: dims[k] for k in ("depth", "dim", "heads", "mlp_dim", "patch_size", "registers")}


# -- the GELU presets, bitwise as before


def _frozen_gelu_tokens(params, images, spec):
    """models/vit.py's forward as it was before the DINOv2 block (a frozen
    copy): no prefix token, no gamma, w1 / exact GELU / w2."""
    dtype = spec.dtype

    def ln(x, p):
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        return ((xf - mu) * torch.rsqrt(var + spec.ln_eps) * p["scale"] + p["bias"]).to(dtype)

    x = patchify(images.to(dtype), spec.patch_size)
    x = x @ params["patch_embed"]["kernel"].to(dtype) + params["patch_embed"]["bias"].to(dtype)
    b, t, _ = x.shape
    blocks = params["blocks"]
    for i in range(spec.depth):
        p = {g: {n: w[i] for n, w in leaves.items()} for g, leaves in blocks.items()}
        y = ln(x, p["ln1"])
        qkv = y @ p["attn"]["wqkv"].to(dtype) + p["attn"]["bqkv"].to(dtype)
        o = reference_attention(*split_fused_qkv(qkv, spec.heads)).transpose(1, 2).reshape(b, t, -1)
        x = x + (o @ p["attn"]["wo"].to(dtype) + p["attn"]["bo"].to(dtype))
        y = ln(x, p["ln2"])
        y = F.gelu(y @ p["mlp"]["w1"].to(dtype) + p["mlp"]["b1"].to(dtype), approximate="none")
        x = x + (y @ p["mlp"]["w2"].to(dtype) + p["mlp"]["b2"].to(dtype))
    return ln(x, params["ln_final"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("variant", ["vit-b16", "vit-l16"])
def test_gelu_presets_are_bitwise_as_before(variant, dtype, monkeypatch):
    """At the preset's widths, cut to one block on 64-px windows: the same
    leaves as before, no SwiGLU call, and the forward bit for bit the frozen
    copy's."""
    cfg = Config.from_dict({"model": {"variant": variant, "image_size": 64}})
    spec = DenseEmbedSpec.from_config(cfg).vit._replace(depth=1, dtype=dtype)
    prm = tparams.init_vit_params(jax_random.key(11), spec)
    assert set(tparams._flatten(prm)) == {
        "patch_embed/kernel", "patch_embed/bias", "pos_embed", "ln_final/scale", "ln_final/bias",
        *(f"blocks/{g}/{n}" for g, ns in (("ln1", ("scale", "bias")), ("ln2", ("scale", "bias")),
                                           ("attn", ("wqkv", "bqkv", "wo", "bo")), ("mlp", ("w1", "b1", "w2", "b2")))
          for n in ns)}
    cast = tparams.cast_for_inference(prm, spec)
    if dtype == torch.float32:
        assert cast is prm
    images = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(4))
    calls = _gate_calls(monkeypatch)
    got = vit_forward_tokens(cast, images, spec)
    assert not calls and spec.num_prefix == 0
    assert torch.equal(grid_tokens(got, spec), got)
    assert torch.equal(got, _frozen_gelu_tokens(cast, images, spec))
    assert math.isfinite(float(got.float().abs().max()))
