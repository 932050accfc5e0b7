"""Model families (``families/<family>.py``), on the CPU at a tiny size: the
``vit`` family gives bitwise what the benchmark computed before families
existed; a family added as new files alone is the one a run uses for the
weights, the reference, the FLOPs and K1's shape; an unknown family is
refused at set-up."""

import json
import math
import textwrap

import pytest
import torch

from portbench import check, counts, harness, trace
from portbench.reference import step as ref
from portbench.reference.noise import splitmix64
from tiny import BENCH, DIMS, make

# -- the ViT as the benchmark computed it before families existed (a frozen copy
# of portbench/weights.py vit_weights and portbench/reference/step.py vit_tokens)

_LO, _HI = (0.5 * (1.0 + math.erf(x / math.sqrt(2.0))) for x in (-2.0, 2.0))


def _truncnormal(g, shape, std, device):
    u = torch.rand(shape, generator=g, device=device, dtype=torch.float64)
    x = math.sqrt(2.0) * torch.erfinv(2.0 * (_LO + u * (_HI - _LO)) - 1.0)
    return (torch.clamp(x, -2.0, 2.0) * std).to(torch.float32)


def frozen_weights(seed, dims, device):
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


def _mm(a, b, quant):
    if quant is not None:
        a, b = quant(a), quant(b)
    return a @ b


def _layer_norm(x, scale, bias, eps):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * scale + bias


def frozen_tokens(params, images, dims, ln_eps, quant=None):
    b, s, _, c = images.shape
    p, g, d, h = dims["patch_size"], s // dims["patch_size"], dims["dim"], dims["heads"]
    hd = d // h
    x = images.reshape(b, g, p, g, p, c).permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, p * p * c)
    x = _mm(x, params["patch_embed"]["kernel"].float(), quant) + params["patch_embed"]["bias"].float()
    blocks = params["blocks"]
    for i in range(dims["depth"]):
        def w(group, name):
            return blocks[group][name][i].float()

        y = _layer_norm(x, w("ln1", "scale"), w("ln1", "bias"), ln_eps)
        qkv = (_mm(y, w("attn", "wqkv"), quant) + w("attn", "bqkv")).reshape(b, g * g, h, 3, hd)
        q, k, v = (qkv[:, :, :, j].transpose(1, 2) for j in range(3))
        att = torch.softmax(_mm(q, k.transpose(-1, -2), quant) / math.sqrt(hd), dim=-1)
        o = _mm(att, v, quant).transpose(1, 2).reshape(b, g * g, d)
        x = x + _mm(o, w("attn", "wo"), quant) + w("attn", "bo")
        y = _layer_norm(x, w("ln2", "scale"), w("ln2", "bias"), ln_eps)
        y = torch.nn.functional.gelu(_mm(y, w("mlp", "w1"), quant) + w("mlp", "b1"))
        x = x + _mm(y, w("mlp", "w2"), quant) + w("mlp", "b2")
    return _layer_norm(x, params["ln_final"]["scale"].float(), params["ln_final"]["bias"].float(), ln_eps)


def _leaves(tree):
    if isinstance(tree, dict):
        return [(f"{k}/{n}", v) for k in sorted(tree) for n, v in _leaves(tree[k])]
    return [("", tree)]


def _config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


# At the tiny size, and at each configuration's widths cut to one block on
# 64-px windows (the full trees are hundreds of MB on the host).
SHAPES = {"tiny": DIMS, **{name: {**_config(name)["dims"], "depth": 1, "image_size": 64}
                           for name in ("vitb16-dense-1k", "vitl16-dense-4k")}}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("quant", [None, check.fp8_quant], ids=["f32", "fp8"])
def test_vit_family_is_bitwise_the_benchmarks_vit(shape, quant):
    dims = SHAPES[shape]
    vit = harness.load_family("vit")
    seed = 2**33 + 19
    ours, theirs = vit.weights(seed, dims, "cpu"), frozen_weights(seed, dims, "cpu")
    assert [k for k, _ in _leaves(ours)] == [k for k, _ in _leaves(theirs)]
    for (name, a), (_, b) in zip(_leaves(ours), _leaves(theirs)):
        assert torch.equal(a, b), name
    tc = _config("vitb16-dense-1k")["tracker_config"]
    rc = ref.RefConfig(tc, dims, vit.tokens)
    images = torch.randn(2, dims["image_size"], dims["image_size"], 3, generator=torch.Generator().manual_seed(3))
    with ref.full_f32():
        got = vit.tokens(ours, images, rc, quant)
        want = frozen_tokens(theirs, images, dims, tc["model"]["ln_eps"], quant)
    assert got.shape == (2, (dims["image_size"] // dims["patch_size"]) ** 2, dims["dim"])
    assert torch.equal(got, want)


@pytest.mark.parametrize("cell, flops, k1_shape", [
    ("b16-serve16-480p", 37_033_672_704, [16, 12, 196, 64]),
    ("l16-offline-1080p", 133_621_612_544, [1, 16, 196, 64]),
])
def test_vit_family_counts_and_k1_shape_of_each_configuration(cell, flops, k1_shape):
    wl, cfg = harness.cell_files(cell)
    assert "family" not in cfg  # a configuration without the key is of the vit family
    vit = harness.load_family("vit")
    assert vit.flops_per_frame(cfg["dims"], cfg["tracker_config"]) == flops
    assert [wl["feeds"], *vit.attention(cfg["dims"], cfg["tracker_config"])] == k1_shape


# -- a family added as new files alone

PROBE = '''
"""A test family: the vit family's tree drawn from another key, its forward,
a FLOP count of its own and five prefix tokens in K1's launch. Each call is
written to probe.calls beside this file."""

from pathlib import Path

from portbench import harness

HERE = Path(__file__).resolve().parent
VIT = harness.load_family("vit", HERE.parent)


def _log(name):
    with open(HERE / "probe.calls", "a") as f:
        f.write(name + "\\n")


def weights(seed, dims, device):
    _log("weights")
    return VIT.weights(seed ^ 0x5EED, dims, device)


def tokens(params, images, rc, quant=None):
    _log("tokens")
    return VIT.tokens(params, images, rc, quant)


def flops_per_frame(dims, tracker_config):
    _log("flops_per_frame")
    return 1234.0


def attention(dims, tracker_config):
    _log("attention")
    heads, t, dh = VIT.attention(dims, tracker_config)
    return heads, t + 5, dh
'''


def _probe_bench(tmp_path):
    """The tiny benchmark with the probe family and a cell on it, as new
    files and entries alone."""
    bd = make(tmp_path, feeds=2, cell="tiny-cell")
    (bd / "families" / "probe.py").write_text(PROBE)
    cfg = json.loads((bd / "configs" / "tiny-config.json").read_text())
    cfg.update(name="tiny-probe", family="probe")
    (bd / "configs" / "tiny-probe.json").write_text(json.dumps(cfg))
    wl = json.loads((bd / "workloads" / "tiny-cell.json").read_text())
    wl["config"] = "tiny-probe"
    (bd / "workloads" / "tiny-probe-cell.json").write_text(json.dumps(wl))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("tiny-probe-cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return bd


def test_a_family_added_as_files_is_the_one_a_run_uses(tmp_path):
    bd = _probe_bench(tmp_path)
    probe, vit = harness.load_family("probe", bd), harness.load_family("vit", bd)
    # Its tree differs from the vit family's: a run whose program and
    # reference loaded different trees would not be correct.
    assert not torch.equal(probe.weights(7, DIMS, "cpu")["blocks"]["attn"]["wqkv"],
                           vit.weights(7, DIMS, "cpu")["blocks"]["attn"]["wqkv"])
    (bd / "families" / "probe.calls").unlink()
    out = harness.run_cell("tiny-probe-cell", 2**31 + 23, 1.5, True, "cpu", bench_dir=bd)
    assert out["correct"], out["checks"]
    calls = (bd / "families" / "probe.calls").read_text().split()
    assert calls.count("weights") == 2  # the program's tree and the reference's
    assert "tokens" in calls and "flops_per_frame" in calls and "attention" in calls
    notes = out["notes"]
    # run.flops_per_frame, which step_mfu_pct reads, and K1's shape.
    assert notes["family"] == "probe" and notes["flops_per_frame"] == 1234.0
    assert notes["k1_shape"] == [2, 3, 21, 64]
    # k1_roofline_pct reads K1's shape from the family: a launch on the grid
    # of [2, 3, 21, 64] counts, one on the vit family's [2, 3, 16, 64] not.
    wl, cfg = harness.cell_files("tiny-probe-cell", bd)
    run = harness.Run("tiny-probe-cell", wl, cfg, 1.0, True)
    run.family = probe
    k1 = "(anonymous namespace)::attn_tiled_bf16_kernel((anonymous namespace)::Problem)"
    events = [{"ph": "X", "cat": "cuda_runtime", "name": trace.ANCHOR_CUDA, "ts": 900.0, "dur": 2.0}]
    events += [{"ph": "X", "cat": "kernel", "name": k1, "ts": ts, "dur": 10.0, "args": {"grid": [grid, 1, 1]}}
               for ts, grid in ((1000.0, counts.k1_grid(2, 3, 21)), (1100.0, counts.k1_grid(2, 3, 16)))]
    run.slice = trace.Slice(events, (100_000, 1_100_000), [], (trace.ANCHOR_CUDA, 0))
    assert counts.k1_grid(2, 3, 21) != counts.k1_grid(2, 3, 16)
    assert harness.load_reader("k1_roofline_pct", bd)(run) == pytest.approx(
        100.0 * counts.k1_least_s(2, 3, 21, 64) / 10e-6)


def test_an_unknown_family_is_refused_at_set_up(tmp_path):
    bd = make(tmp_path, feeds=1, cell="tiny-cell")
    path = bd / "configs" / "tiny-config.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), "family": "no_such_family"}))
    with pytest.raises(FileNotFoundError, match="families/no_such_family.py"):
        harness.run_cell("tiny-cell", 1, 1.0, False, "cpu", bench_dir=bd)


def test_a_family_without_its_four_functions_is_refused(tmp_path):
    bd = make(tmp_path, feeds=1, cell="tiny-cell")
    (bd / "families" / "half.py").write_text(textwrap.dedent('''
        def weights(seed, dims, device):
            return {}
    '''))
    with pytest.raises(ValueError, match="tokens.*flops_per_frame.*attention"):
        harness.load_family("half", bd)
