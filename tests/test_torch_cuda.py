"""On-card tests of the port (marker `cuda`): kernels K1 and K2 against
their plain versions, the tracker's dense and crop paths through them, and
the tracker's captured step graphs against the same step run eagerly.

Whether a card is present is decided inside the `cuda_device` fixture, never
at import or collection, so every worker collects the same tests; without a
card each test skips. Run on the card with:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import copy

import numpy as np
import pytest
import torch

# K2's cases, inputs and tolerances (as tests/test_patchify_pallas.py)
from chip_smoke import JUNCTION_SHAPES, K2_DIMS, K2_NS, K2_SWINS, K2_TOL, k2_inputs
from vitparticlefiltertracker_tpu_torch.config import Config
from vitparticlefiltertracker_tpu_torch.ops import attention
from vitparticlefiltertracker_tpu_torch.ops import patchify_window as pw

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}  # as tests/test_attention.py


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv_views(shape, dtype, layout, seed, device):
    """q, k, v of `shape` [B, H, T, 64]: views of one fused [B, T, H*3*64]
    activation, as models/vit.py passes them, or three contiguous tensors."""
    b, h, t, d = shape
    g = torch.Generator(device=device).manual_seed(seed)
    if layout == "fused":
        fused = torch.randn((b, t, h * 3 * d), generator=g, device=device).to(dtype)
        return attention.split_fused_qkv(fused, h)
    return tuple(torch.randn(shape, generator=g, device=device).to(dtype) for _ in range(3))


@pytest.mark.parametrize("layout", ["fused", "contiguous"])
@pytest.mark.parametrize("h", [3, 12, 16])
@pytest.mark.parametrize("t", [1, 4, 9, 16, 17, 32, 64, 128, 130, 196, 197, 256, 389])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(cuda_device, t, dtype, h, layout):
    """Every path (small T <= 16; tiled above, and in f32 the split path
    where the call has few query tiles: all of these) on fused-layout views
    and on contiguous tensors, T on and off the 16-row and 64-key tile
    edges; the output lands in [B, T, H, 64] memory."""
    q, k, v = _qkv_views((2, h, t, 64), dtype, layout, seed=t + h, device=cuda_device)
    before = attention.flash_attention.launches
    out = attention.multi_head_attention(q, k, v)
    torch.cuda.synchronize()
    assert attention.flash_attention.launches == before + 1
    assert out.shape == (2, h, t, 64) and out.transpose(1, 2).is_contiguous()
    ref = attention.reference_attention(q, k, v)
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("layout", ["fused", "contiguous"])
@pytest.mark.parametrize("shape", [(1024, 12, 4, 64), (1, 12, 4, 64), (6000, 12, 4, 64)],
                         ids=["particles-1024", "template-1", "bh-72000"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_at_crop_mode_shape(cuda_device, dtype, shape, layout):
    """K1 as crop mode runs it: T = 4 tokens, a batch of 1024 crops and the
    template's single crop; and B*H = 72,000 (over a grid.y's 65,535)."""
    q, k, v = _qkv_views(shape, dtype, layout, seed=shape[0], device=cuda_device)
    out = attention.flash_attention(q, k, v)
    torch.cuda.synchronize()
    ref = attention.reference_attention(q, k, v)
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("layout", ["fused", "contiguous"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_at_redetection_shape(cuda_device, dtype, layout):
    """[49, 12, 196, 64]: global re-detection's batch of tile windows."""
    q, k, v = _qkv_views((49, 12, 196, 64), dtype, layout, seed=49, device=cuda_device)
    out = attention.flash_attention(q, k, v)
    torch.cuda.synchronize()
    ref = attention.reference_attention(q, k, v)
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("n", K2_NS)
@pytest.mark.parametrize("crop", [32, 48])
@pytest.mark.parametrize("swin", K2_SWINS)
@pytest.mark.parametrize("d", K2_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("raw", [False, True])
def test_window_patchify_kernel_matches_plain_version(cuda_device, n, crop, swin, d, dtype, raw):
    """Every edge of the launch plan's tiles (chip_smoke.K2_NS, K2_DIMS):
    both tensor-core tiles and the scalar kernel, ragged row and column
    tiles, one box and eval5's 16384."""
    window, centers, sizes, kernel, bias = k2_inputs(n, swin, 16, d, dtype, raw, seed=n, device=cuda_device)
    before = pw.gather_patchify_window.launches
    out = pw.window_gather_patchify(window, centers, sizes, crop, 16, kernel, bias)
    torch.cuda.synchronize()
    assert pw.gather_patchify_window.launches == before + 1
    ref = pw.window_gather_patchify_plain(window, centers, sizes, crop, 16, kernel, bias)
    assert out.shape == ref.shape == (n, (crop // 16) ** 2, d) and out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), **K2_TOL[dtype])


def test_window_patchify_kernel_refuses_what_it_does_not_take(cuda_device):
    window, centers, sizes, kernel, bias = k2_inputs(3, 64, 16, 128, torch.float32, False, seed=3, device=cuda_device)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        pw.gather_patchify_window(window, centers, sizes, 32, 16, kernel.half(), bias.half())
    with pytest.raises(ValueError, match="multiple"):
        pw.gather_patchify_window(window, centers, sizes, 40, 16, kernel, bias)
    with pytest.raises(ValueError, match="contiguous"):
        pw.gather_patchify_window(window, centers.t().contiguous().t(), sizes, 32, 16, kernel, bias)


@pytest.mark.parametrize("keys", ["uniform", "peaked"])
@pytest.mark.parametrize("b", [1, 49])
def test_kernel_extreme_logits_finite(cuda_device, b, keys):
    """Logits of 7200 (q = k = 30: every key alike) and of up to about 110
    apart (integer keys in [-4, 4]: a softmax peaked on a few keys), exact
    in TF32, so the 3xTF32 logits are exact too; B 1 takes the f32 split
    path, B 49 the tiled one."""
    g = torch.Generator(device=cuda_device).manual_seed(b)
    q = torch.full((b, 1, 256, 64), 30.0, device=cuda_device)
    k = q if keys == "uniform" else torch.randint(-4, 5, q.shape, generator=g, device=cuda_device).float()
    v = torch.randn(q.shape, generator=g, device=cuda_device)
    out = attention.flash_attention(q, k, v)
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, attention.reference_attention(q, k, v), rtol=1e-5, atol=1e-5)


def test_kernel_refuses_what_it_does_not_take(cuda_device):
    q = torch.zeros((1, 1, 8, 32), device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        attention.flash_attention(q, q, q)
    q = torch.zeros((1, 1, 8, 64), device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="bfloat16"):
        attention.flash_attention(q, q, q)


def test_tracker_main_path_launches_kernel(cuda_device):
    from vitparticlefiltertracker_tpu_torch.io.video import open_source
    from vitparticlefiltertracker_tpu_torch.runtime.tracker import Tracker

    cfg = Config.from_dict({
        "model": {"variant": "custom", "depth": 2, "dim": 128, "heads": 2, "mlp_dim": 256,
                  "image_size": 64, "dtype": "bfloat16", "checkpoint": ""},
        "filter": {"num_particles": 256},
    })
    src = open_source("synthetic:moving-square", 6, (224, 224))
    tr = Tracker(copy.deepcopy(cfg), device="cuda")
    attention.flash_attention.launches = 0
    recs = list(tr.run(src))
    assert attention.flash_attention.launches == 2 * 6  # depth x (init + 5 steps)
    assert np.all(np.isfinite([r["position"] for r in recs]))


def test_crop_tracker_launches_both_kernels(cuda_device):
    """Crop mode, window-pallas: K2 once per forward (init, every step, every
    template update), K1 depth times per forward; no lost-probe."""
    from vitparticlefiltertracker_tpu_torch.io.video import open_source
    from vitparticlefiltertracker_tpu_torch.runtime.tracker import Tracker

    cfg = Config.from_dict({
        "model": {"variant": "custom", "depth": 2, "dim": 128, "heads": 2, "mlp_dim": 256,
                  "image_size": 64, "dtype": "bfloat16", "checkpoint": ""},
        "filter": {"num_particles": 256},
        "tracker": {"mode": "crop", "crop_impl": "window-pallas"},
    })
    src = open_source("synthetic:moving-square", 6, (224, 224))
    tr = Tracker(copy.deepcopy(cfg), device="cuda")
    attention.flash_attention.launches = 0
    pw.gather_patchify_window.launches = 0
    recs = list(tr.run(src))
    forwards = 1 + 2 * len(recs)  # init, then a particle forward and a template forward a step
    assert pw.gather_patchify_window.launches == forwards
    assert attention.flash_attention.launches == 2 * forwards
    assert np.all(np.isfinite([r["position"] for r in recs]))


@pytest.mark.parametrize("name", ["TINY_HEAD_REDETECT", "TINY_CROP_REDETECT"])
def test_redetecting_tracker_on_card_matches_cpu(cuda_device, name):
    """Tiny global re-detection configs (dense with the head and its
    automatic blend; crop through K2) on the card against the CPU, same
    weights and draws: every step within 0.5 px, the same scans and
    accepted matches, at least one of each (chip_smoke.check_tracker_small)."""
    import chip_smoke

    chip_smoke.check_tracker_small(getattr(chip_smoke, name), name)


def test_threefry_init_on_card_equals_cpu(cuda_device):
    """The port's JAX random init gives the same bits on the card as on the
    CPU (every float rounding is written out; no library transcendental)."""
    from vitparticlefiltertracker_tpu_torch.models import params as tparams
    from vitparticlefiltertracker_tpu_torch.models.vit import VitSpec

    spec = VitSpec(depth=2, dim=128, heads=2, mlp_dim=256, image_size=64, head_depth=2)
    cpu = tparams.init_vit_params(tparams.trunk_key(4), spec, "cpu")
    card = tparams.init_vit_params(tparams.trunk_key(4), spec, cuda_device)

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else [(f"{prefix}{k}", v)]

    got = dict(leaves(card))
    for k, v in leaves(cpu):
        assert torch.equal(got[k].cpu(), v), k


def _kernel_counts(counts: dict, steps: int, graphs: bool) -> dict:
    """chip_smoke.read_counts() but the step noise kernel's, after checking
    those: one launch a step through the graphs (which draw the noise on the
    card), none in the eager step (whose noise the host draws)."""
    assert counts["noise_launches"] == (steps if graphs else 0), (counts["noise_shapes"], steps, graphs)
    return {k: v for k, v in counts.items() if not k.startswith("noise_")}


def _graph_and_eager_runs(cfg_dict, sources):
    """The same tiny tracker through Tracker.run on the card twice, eagerly
    (graphs=False) and through its captured graphs, with the same weights:
    -> {graphs: (records, launch counts)}. Each source after the first
    continues the run from its first frame on (steps only)."""
    import chip_smoke
    from vitparticlefiltertracker_tpu_torch.runtime.tracker import Tracker

    cfg = Config.from_dict(copy.deepcopy(cfg_dict))
    prm = Tracker(copy.deepcopy(cfg), device="cpu").vit_params
    out = {}
    for graphs in (False, True):
        tr = Tracker(copy.deepcopy(cfg), vit_params=prm, device="cuda", graphs=graphs)
        chip_smoke.reset_counts()
        recs = list(tr.run(sources[0]))
        for src in sources[1:]:
            recs += [tr.step(f) for f in src.frames]
        torch.cuda.synchronize()
        out[graphs] = ([{k: v for k, v in r.items() if k != "step_ms"} for r in recs],
                       _kernel_counts(chip_smoke.read_counts(), len(recs), graphs), tr)
    return out


@pytest.mark.parametrize("name", ["TINY", "TINY_CROP_NO_RESAMPLE", "TINY_HEAD_REDETECT", "TINY_CROP_REDETECT"])
def test_graph_step_matches_eager_step(cuda_device, name):
    """Each step one replay of a captured graph against the same step run
    eagerly: every record equal (the same kernels on the same inputs; the
    noise is drawn outside the graph from the same (seed, frame) keys), and
    the kernels' launch counts by shape equal when counted per replay."""
    import chip_smoke
    from vitparticlefiltertracker_tpu_torch.io.video import open_source

    cfg = getattr(chip_smoke, name)
    src = open_source(cfg["io"]["source"], cfg["io"]["num_frames"], tuple(cfg["io"]["frame_size"]))
    runs = _graph_and_eager_runs(cfg, [src])
    (eager, eager_counts, _), (graph, graph_counts, tr) = runs[False], runs[True]
    assert graph == eager
    assert graph_counts == eager_counts and graph_counts["launches"] > 0
    assert tr.graphs and len(tr._step_graphs) == 1


def test_graph_recaptures_for_a_new_frame_shape(cuda_device):
    """A frame of another shape captures its own graphs (as a jit would
    retrace); the steps on it equal the eager ones."""
    import chip_smoke
    from vitparticlefiltertracker_tpu_torch.io.video import open_source

    cfg = chip_smoke.TINY
    a = open_source("synthetic:moving-square", 5, (224, 224))
    b = open_source("synthetic:moving-square", 4, (192, 256))
    runs = _graph_and_eager_runs(cfg, [a, b])
    assert runs[True][0] == runs[False][0] and runs[True][1] == runs[False][1]
    assert sorted(k[0] for k in runs[True][2]._step_graphs) == [(192, 256, 3), (224, 224, 3)]


def test_graph_tracker_never_steps_eagerly(cuda_device, monkeypatch):
    """With graphs (the default on the card) every step is a replay: the
    step function is never called after init, and a step that cannot be
    captured makes init raise instead of running eagerly."""
    from vitparticlefiltertracker_tpu_torch.io.video import open_source
    from vitparticlefiltertracker_tpu_torch.runtime.tracker import Tracker

    import chip_smoke

    cfg = Config.from_dict(copy.deepcopy(chip_smoke.TINY_HEAD_REDETECT))
    src = open_source(cfg.io.source, cfg.io.num_frames, tuple(cfg.io.frame_size))
    tr = Tracker(copy.deepcopy(cfg), device="cuda")
    tr.init(src.frames[0], src.init_bbox)
    assert len(tr._step_graphs) == 1 and len(next(iter(tr._step_graphs.values())).branch_counts) == 2

    def boom(*a, **k):
        raise AssertionError("an eager step ran")

    tr._fns = tr._fns._replace(step=boom)
    recs = [tr.step(f) for f in src.frames[1:]]
    assert any(r["lost"] for r in recs) and np.all(np.isfinite([r["position"] for r in recs]))
    frames = torch.from_numpy(np.stack(src.frames[1:4])).cuda()
    assert tuple(tr.track_clip_device(frames).position.shape) == (3, 2)

    bad = Tracker(copy.deepcopy(cfg), device="cuda")
    body = bad._body

    def reads_back(*a):
        new, row = body(*a)
        return new, row * float(row[0])  # a host read: not capturable

    monkeypatch.setattr(bad, "_body", reads_back)
    with pytest.raises(RuntimeError):
        bad.init(src.frames[0], src.init_bbox)


@pytest.mark.parametrize("donate", [True, False])
def test_graph_state_donation(cuda_device, donate):
    """runtime.donate_state true: Tracker.state is the graphs' buffers,
    updated in place by each step; false: a copy after each step, which the
    next step leaves alone."""
    from vitparticlefiltertracker_tpu_torch.io.video import open_source
    from vitparticlefiltertracker_tpu_torch.runtime.step_graph import state_leaves
    from vitparticlefiltertracker_tpu_torch.runtime.tracker import Tracker

    import chip_smoke

    d = copy.deepcopy(chip_smoke.TINY)
    d["runtime"] = {"donate_state": donate}
    src = open_source("synthetic:moving-square", 4, (224, 224))
    tr = Tracker(Config.from_dict(d), device="cuda")
    tr.init(src.frames[0], src.init_bbox)
    tr.step(src.frames[1])
    before = tr.state
    kept = [x.clone() for x in state_leaves(before)]
    tr.step(src.frames[2])
    unchanged = torch.equal(state_leaves(before)[0], kept[0])
    assert (tr.state is before and not unchanged) if donate else (tr.state is not before and unchanged)
    if not donate:
        assert all(torch.equal(a, b) for a, b in zip(state_leaves(before), kept))


@pytest.mark.parametrize("layout", ["fused", "contiguous"])
@pytest.mark.parametrize("shape", [(8, 12, 196, 64), (4, 12, 196, 64)], ids=["banked-8", "streams-4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_at_banked_shapes(cuda_device, dtype, shape, layout):
    """K1 at the banked path's forward (8 search windows) and the
    multi-stream path's (4)."""
    q, k, v = _qkv_views(shape, dtype, layout, seed=shape[0] + 196, device=cuda_device)
    out = attention.flash_attention(q, k, v)
    torch.cuda.synchronize()
    ref = attention.reference_attention(q, k, v)
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("layout", ["fused", "contiguous"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_at_dinov2_shape(cuda_device, dtype, layout):
    """K1 at DINOv2 ViT-g/14 with 4 registers on a 224-px window: [1, 24,
    261, 64] (256 patches, the class token and 4 registers; T off every
    16-row and 64-key tile edge), against torch's scaled_dot_product_attention
    in f32 and the plain version; bf16 on the tiled path's 2-warp grid of 216
    (portbench/counts.py k1_grid, which the benchmark's k1_roofline_pct
    matches launches by)."""
    shape = (1, 24, 261, 64)
    q, k, v = _qkv_views(shape, dtype, layout, seed=261, device=cuda_device)
    out = attention.flash_attention(q, k, v)
    torch.cuda.synchronize()
    sdpa = torch.nn.functional.scaled_dot_product_attention(q.float(), k.float(), v.float())
    torch.testing.assert_close(out.float(), sdpa, rtol=TOL[dtype], atol=TOL[dtype])
    torch.testing.assert_close(out.float(), attention.reference_attention(q, k, v).float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    if dtype == torch.bfloat16:
        plan = attention.launch_plan(q, k, v, out, torch.cuda.get_device_properties(0).multi_processor_count)
        assert (plan.path, plan.warps, plan.grid) == ("tiled", 2, 216)


@pytest.mark.parametrize("m,h", [(261, 4096), (16 * 261, 4096), (3, 8), (1000, 1368)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swiglu_kernel_matches_plain_version(cuda_device, m, h, dtype):
    """The SwiGLU gate kernel (csrc/swiglu.cu) at DINOv2 ViT-g/14's FFN for
    one window (M 261, h 4096) and 16, and ragged small shapes, against its
    plain version: the same formula in the same order, so equal within one
    rounding of the output (torch's exp and the kernel's may differ in the
    last bit of the f32 silu). One launch counted."""
    from vitparticlefiltertracker_tpu_torch.ops import swiglu as sg

    g = torch.Generator(device=cuda_device).manual_seed(m + h)
    x = (torch.randn((m, 2 * h), generator=g, device=cuda_device) * 3.0).to(dtype)
    before = sg.swiglu.launches
    out = sg.swiglu(x)
    torch.cuda.synchronize()
    assert sg.swiglu.launches == before + 1 and out.shape == (m, h) and out.dtype == dtype
    rtol = 2**-7 if dtype == torch.bfloat16 else 1e-6
    torch.testing.assert_close(out.float(), sg.swiglu_plain(x).float(), rtol=rtol, atol=1e-6)


def test_swiglu_kernel_refuses_what_it_does_not_take(cuda_device):
    from vitparticlefiltertracker_tpu_torch.ops import swiglu as sg

    x = torch.zeros((4, 32), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        sg.swiglu(x[:, ::2])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        sg.swiglu(x.half())
    with pytest.raises(ValueError, match="multiple of 8"):
        sg.swiglu(torch.zeros((4, 24), device=cuda_device, dtype=torch.bfloat16))


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no-bias"])
@pytest.mark.parametrize("with_branch", [True, False], ids=["branch", "no-branch"])
@pytest.mark.parametrize("m,d,dtype", JUNCTION_SHAPES, ids=[f"{m}x{d}-{str(t)[6:]}" for m, d, t in JUNCTION_SHAPES])
def test_prenorm_junction_matches_plain_form(cuda_device, m, d, dtype, with_branch, with_bias):
    """The pre-norm junction kernel (csrc/prenorm_junction.cu) at the
    benchmark cells' forwards ([3136, 768], [196, 1024], [261, 1536], [196,
    768]), the crop path's [4096, 768], f32 at [196, 768] and a width of 64,
    with and without the branch and its bias, against its plain form: x_new
    bitwise, y within one bf16 ulp (the same formulas, the two sums in
    another order; f32 within 8 ulps of the row's unit scale:
    chip_smoke.JUNCTION_ULP), under 0.1 % of y not bitwise in bf16; one
    launch counted under (M, D). A bias without its branch is refused, and
    nothing launched."""
    from chip_smoke import JUNCTION_ULP, junction_errors, junction_inputs

    from vitparticlefiltertracker_tpu_torch.ops import prenorm_junction as pj

    before = pj.prenorm_junction.shapes[(m, d)]
    if with_bias and not with_branch:
        with pytest.raises(ValueError, match="bias comes with its branch"):
            pj.prenorm_junction(*junction_inputs(m, d, dtype, False, True), dtype, 1e-6)
        assert pj.prenorm_junction.shapes[(m, d)] == before
        return
    e = junction_errors(junction_inputs(m, d, dtype, with_branch, with_bias, seed=m + d), dtype)
    assert pj.prenorm_junction.shapes[(m, d)] == before + 1
    assert e["x_new_bitwise"]
    assert e["max_ulp"] <= JUNCTION_ULP[dtype][2], e
    assert dtype == torch.float32 or e["differ"] < 1e-3, e


def test_prenorm_junction_reads_bf16_layer_norm_parameters(cuda_device, monkeypatch):
    """The committed ViT-B/16 checkpoint stores its LayerNorms' scale and
    shift in bf16. cast_for_inference widens them to f32, the one form the
    kernel reads; the forward on the card is then within the bf16 tolerance
    of the same forward with the plain LayerNorm chain on the checkpoint's
    bf16 parameters, the junction launched 2 depth + 1 times."""
    from vitparticlefiltertracker_tpu_torch.config import load_config
    from vitparticlefiltertracker_tpu_torch.models import params as tparams
    from vitparticlefiltertracker_tpu_torch.models import vit
    from vitparticlefiltertracker_tpu_torch.ops import prenorm_junction as pj

    spec = vit.VitSpec.from_config(load_config("configs/eval2-tpu-occlusion.yaml").model)._replace(head_depth=0)
    stored = tparams.load_params("checkpoints/vit_b16_tracking.npz", cuda_device)
    stored = {k: v for k, v in stored.items() if k != "head"}
    assert stored["blocks"]["ln1"]["scale"].dtype == torch.bfloat16
    prm = tparams.cast_for_inference(stored, spec)
    assert prm["blocks"]["ln1"]["scale"].dtype == prm["ln_final"]["bias"].dtype == torch.float32
    images = torch.rand(2, spec.image_size, spec.image_size, 3, generator=torch.Generator().manual_seed(5)).to(
        cuda_device)
    before = pj.prenorm_junction.launches
    got = vit.vit_forward_tokens(prm, images, spec)
    torch.cuda.synchronize()
    assert pj.prenorm_junction.launches - before == 2 * spec.depth + 1
    bf16_lns = dict(prm, ln_final=stored["ln_final"],
                    blocks=dict(prm["blocks"], ln1=stored["blocks"]["ln1"], ln2=stored["blocks"]["ln2"]))
    monkeypatch.setattr(vit, "prenorm_junction", pj.prenorm_junction_plain)
    want = vit.vit_forward_tokens(bf16_lns, images, spec)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[torch.bfloat16], atol=TOL[torch.bfloat16])


def test_prenorm_junction_refuses_what_it_does_not_take(cuda_device):
    from chip_smoke import junction_inputs

    from vitparticlefiltertracker_tpu_torch.ops import prenorm_junction as pj

    x, br, bi, sc, sh = junction_inputs(8, 64, torch.bfloat16)
    bf = torch.bfloat16
    with pytest.raises(RuntimeError, match="no backward"):
        pj.prenorm_junction(x.clone().requires_grad_(True), br, bi, sc, sh, bf, 1e-6)
    with pytest.raises(RuntimeError, match="no backward"):
        pj.prenorm_junction(x, br, bi, sc.clone().requires_grad_(True), sh, bf, 1e-6)
    wide = torch.zeros((8, 128), device=cuda_device, dtype=bf)
    with pytest.raises(ValueError, match="contiguous"):
        pj.prenorm_junction(wide[:, ::2], br, bi, sc, sh, bf, 1e-6)
    with pytest.raises(ValueError, match="contiguous"):
        pj.prenorm_junction(x, wide[:, ::2], bi, sc, sh, bf, 1e-6)
    with pytest.raises(ValueError, match="compute dtype"):
        pj.prenorm_junction(x.float(), br, bi, sc, sh, bf, 1e-6)
    with pytest.raises(ValueError, match="multiple of 8"):
        pj.prenorm_junction(torch.zeros((4, 60), device=cuda_device, dtype=bf), None, None,
                            torch.ones(60, device=cuda_device), torch.zeros(60, device=cuda_device), bf, 1e-6)
    with pytest.raises(ValueError, match="must be float32"):
        pj.prenorm_junction(x, br, bi, sc.to(bf), sh.to(bf), bf, 1e-6)
    with pytest.raises(ValueError, match="bias comes with its branch"):
        pj.prenorm_junction(x, None, bi, sc, sh, bf, 1e-6)


@pytest.mark.parametrize("family", ["vit-b16", "dinov2-g14"])
def test_forward_with_junctions_matches_the_plain_layer_norm_forward(cuda_device, family, monkeypatch):
    """vit_forward_tokens on the card at ViT-B/16's widths (with a residual
    head) and DINOv2 ViT-g/14's (SwiGLU, a class token and 4 registers on a
    224-px window), cut to 2 blocks: the junction kernel 2 depth + 1 times a
    forward (2 head_depth + 1 more with the head), and the tokens within the
    bf16 tolerance of the same forward with the plain LayerNorm chain."""
    import plain_dinov2

    from vitparticlefiltertracker_tpu_torch.models import params as tparams
    from vitparticlefiltertracker_tpu_torch.models import vit
    from vitparticlefiltertracker_tpu_torch.ops import prenorm_junction as pj

    if family == "vit-b16":
        spec = vit.VitSpec(depth=2, head_depth=1, use_pos_embed=False)
        prm = tparams.init_vit_params(tparams.jax_random.key(3), spec, "cuda")
        junctions = 2 * 2 + 1 + 2 * 1 + 1
    else:
        spec = vit.VitSpec(depth=2, dim=1536, heads=24, mlp_dim=4096, patch_size=14, use_cls_token=True,
                           use_pos_embed=False, ffn="swiglu", registers=4)
        tree = plain_dinov2.draw_tree(3, 2, 1536, 24, 4096, 14, 4)
        prm = tparams._map(tree, lambda t: t.to(cuda_device))
        junctions = 2 * 2 + 1
    prm = tparams.cast_for_inference(prm, spec)
    images = torch.randn(2, 224, 224, 3, generator=torch.Generator().manual_seed(3)).to(cuda_device)
    before = pj.prenorm_junction.launches
    got = vit.vit_forward_tokens(prm, images, spec)
    torch.cuda.synchronize()
    assert pj.prenorm_junction.launches - before == junctions
    t = spec.num_prefix + spec.num_patches
    assert pj.prenorm_junction.shapes[(2 * t, spec.dim)] >= junctions
    monkeypatch.setattr(vit, "prenorm_junction", pj.prenorm_junction_plain)
    want = vit.vit_forward_tokens(prm, images, spec)
    assert pj.prenorm_junction.launches - before == junctions
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[torch.bfloat16], atol=TOL[torch.bfloat16])


def test_dinov2_tracker_launches_both_kernels(cuda_device):
    """A tiny DINOv2 backbone (SwiGLU FFN, LayerScale gammas in the weights,
    class token and 2 registers, patch 14; tests/plain_dinov2.py's seeded
    tree) on the dense main path through the step graphs:
    K1 and the SwiGLU kernel once a block a forward, at T 19 and M 19, and
    finite records. (The features against the plain forward on the card:
    tools/port_dinov2_features.py; the card's generator draws other noise
    than the CPU's, so the records are not compared across devices.)"""
    import plain_dinov2

    from vitparticlefiltertracker_tpu_torch.io.video import open_source
    from vitparticlefiltertracker_tpu_torch.ops import swiglu as sg
    from vitparticlefiltertracker_tpu_torch.runtime.tracker import Tracker

    from vitparticlefiltertracker_tpu_torch.runtime import step_graph

    cfg = Config.from_dict({
        "model": {"variant": "custom", "depth": 2, "dim": 128, "heads": 2, "mlp_dim": 256, "patch_size": 14,
                  "image_size": 56, "dtype": "bfloat16", "checkpoint": "", "ffn": "swiglu", "registers": 2,
                  "drop_cls_token": False},
        "filter": {"num_particles": 256},
    })
    src = open_source("synthetic:moving-square", 6, (224, 224))
    tr = Tracker(cfg, vit_params=plain_dinov2.draw_tree(7, 2, 128, 2, 256, 14, 2), device="cuda")
    k1, gate = attention.flash_attention.launches, sg.swiglu.launches
    recs = list(tr.run(src))
    step_graph.settle_counts()
    assert attention.flash_attention.launches - k1 == 2 * 6  # depth x (init + 5 steps)
    assert sg.swiglu.launches - gate == 2 * 6
    assert sg.swiglu.shapes[(19, 256)] >= 2 * 6
    assert np.all(np.isfinite([r["position"] for r in recs])) and np.all(np.isfinite([r["conf"] for r in recs]))


@pytest.mark.parametrize("windows,n", [(1, 1024), (2, 1024), (8, 1024), (2, 1), (3, 17)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_patchify_kernel_over_windows(cuda_device, windows, n, dtype):
    """K2 over K windows, each with its own boxes, in one launch (crop-mode
    banks) against the plain version; one launch counted, under (K, N)."""
    from chip_smoke import k2_window_inputs

    window, centers, sizes, kernel, bias = k2_window_inputs(windows, n, dtype, seed=windows + n)
    before = pw.gather_patchify_window.sizes[(windows, n)]
    out = pw.window_gather_patchify(window, centers, sizes, 32, 16, kernel, bias)
    torch.cuda.synchronize()
    assert pw.gather_patchify_window.sizes[(windows, n)] == before + 1
    ref = pw.window_gather_patchify_plain(window, centers, sizes, 32, 16, kernel, bias)
    assert out.shape == ref.shape == (windows, n, 4, 768) and out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), **K2_TOL[dtype])


@pytest.mark.parametrize("name,kind,k", [("TINY_BANKED_REDETECT", "banked", 3), ("TINY_BANKED_CROP", "banked", 2),
                                         ("TINY_NO_RESAMPLE", "streams", 3)])
def test_banked_tracker_on_card_matches_cpu(cuda_device, name, kind, k):
    """Banked and multi-stream steps on the card against the CPU, the CPU's
    draws injected (chip_smoke.check_banked_small)."""
    import chip_smoke

    chip_smoke.check_banked_small(getattr(chip_smoke, name), kind, k, name)


@pytest.mark.parametrize("kind", ["banked", "streams"])
def test_banked_graph_step_matches_eager_step(cuda_device, kind):
    """MultiTracker (3 banks with the lost gate and re-detection: one graph
    with two IF nodes) and MultiStreamTracker (3 streams) through their captured graphs
    against the same steps eagerly: every packed row equal, launch counts by
    shape equal, K1 at B 3."""
    import chip_smoke
    from vitparticlefiltertracker_tpu_torch.io.video import open_source
    from vitparticlefiltertracker_tpu_torch.runtime import banked
    from vitparticlefiltertracker_tpu_torch.runtime.tracker import Tracker

    d = copy.deepcopy(chip_smoke.TINY_BANKED_REDETECT if kind == "banked" else chip_smoke.TINY_NO_RESAMPLE)
    d["runtime"] = {"banks": 3}
    cfg = Config.from_dict(d)
    size = tuple(cfg.io.frame_size)
    if kind == "banked":
        src = open_source(cfg.io.source, cfg.io.num_frames, size)
        first, steps, boxes = src.frames[0], np.stack(src.frames[1:]), banked.banked_bboxes(src.init_bbox, 3)
    else:
        srcs = [open_source(cfg.io.source, cfg.io.num_frames, size, seed=i) for i in range(3)]
        clips = np.stack([np.stack(s.frames) for s in srcs], axis=1)
        first, steps, boxes = clips[0], clips[1:], np.stack([s.init_bbox for s in srcs])
    prm = Tracker(copy.deepcopy(cfg), device="cpu").vit_params
    out = {}
    for graphs in (False, True):
        tr = (banked.MultiTracker(copy.deepcopy(cfg), prm, "cuda", graphs) if kind == "banked"
              else banked.MultiStreamTracker(copy.deepcopy(cfg), 3, prm, "cuda", graphs))
        chip_smoke.reset_counts()
        tr.init(first, boxes)
        rows = torch.stack([tr.step_packed(torch.from_numpy(f).cuda()) for f in steps]).cpu()
        out[graphs] = (rows, _kernel_counts(chip_smoke.read_counts(), len(steps), graphs), tr)
    assert torch.equal(out[True][0], out[False][0])
    assert out[True][1] == out[False][1] and out[True][1]["k1_shapes"].get((3, 2, 16), 0) > 0
    assert out[True][2].graphs and not out[False][2].graphs
    if kind == "banked":
        graphs = out[True][2]._step_graphs
        assert len(graphs) == 1 and len(next(iter(graphs.values())).branch_counts) == 2
        assert bool(out[True][0][:, 27:30].any())  # some bank was lost


def test_robust_track_clip_device_waits_for_nothing(cuda_device):
    """F1: with the lost gate and global re-detection (tiny dense tracker
    with the head, its automatic blend and re-detection), the branches are
    chosen on the card: track_clip_device over the teleport clip's lost and
    scanning frames makes no host wait, and its records equal the eager
    Tracker.run's."""
    import chip_smoke
    from vitparticlefiltertracker_tpu_torch.io.video import open_source
    from vitparticlefiltertracker_tpu_torch.runtime.tracker import Tracker

    cfg = Config.from_dict(copy.deepcopy(chip_smoke.TINY_HEAD_REDETECT))
    src = open_source(cfg.io.source, cfg.io.num_frames, tuple(cfg.io.frame_size))
    prm = Tracker(copy.deepcopy(cfg), device="cpu").vit_params
    eager = list(Tracker(copy.deepcopy(cfg), vit_params=prm, device="cuda", graphs=False).run(src))
    tr = Tracker(copy.deepcopy(cfg), vit_params=prm, device="cuda")
    tr.init(src.frames[0], src.init_bbox)
    clip = torch.from_numpy(np.stack(src.frames[1:])).cuda()
    torch.cuda.synchronize()
    stacks = []
    outs = []
    waits = chip_smoke.count_waits(lambda: outs.append(tr.track_clip_device(clip)), stacks)
    assert waits == 0, stacks
    got = chip_smoke.pack_rows(outs[0])
    want = [[*r["position"], *r["box"], *r["velocity"], r["conf"], r["ess"], r["resampled"], r["lost"]]
            for r in eager]
    assert np.array_equal(got, np.array(want, np.float64))
    assert got[:, 9].any()  # the lost branch ran



def _roi_chunks(src, roi, glob_stride, device):
    """The teleport clip's frames after the first as ROI StreamFrames on the
    card: a crop of `roi` px around the truth, the global view refreshed
    at frames 1, 5, 9, ... (a new tensor each refresh, reused in between;
    one a chunk of 4)."""
    from vitparticlefiltertracker_tpu_torch.ops.image import FrameView, StreamFrame

    h, w = src.frames[0].shape[:2]
    out, glob = [], None
    for i in range(1, len(src.frames)):
        frame = src.frames[i]
        if (i - 1) % 4 == 0:
            glob = FrameView(torch.from_numpy(np.ascontiguousarray(frame[::glob_stride, ::glob_stride])).to(device),
                             torch.zeros(2, device=device), float(glob_stride))
        cx, cy = src.truth[i]
        ox, oy = int(np.clip(round(cx - roi / 2), 0, w - roi)), int(np.clip(round(cy - roi / 2), 0, h - roi))
        pixels = torch.from_numpy(np.ascontiguousarray(frame[oy:oy + roi, ox:ox + roi])).to(device)
        out.append(StreamFrame(FrameView(pixels, torch.tensor([ox, oy], dtype=torch.float32, device=device), 1.0),
                               glob))
    return out


def test_roi_chunk_graph_equals_sequential_replays(cuda_device):
    """ROI streaming's chunk graph (tiny dense tracker with the head, its
    automatic blend and re-detection, on the teleport clip): chunks of 4
    StreamFrames sharing a global view through step_chunk_packed equal the
    same frames one step_packed each (the one-frame ROI graph) and the eager
    steps; each chunk graph has its two IF nodes a step; a scan ran."""
    import chip_smoke
    from vitparticlefiltertracker_tpu_torch.io.video import open_source
    from vitparticlefiltertracker_tpu_torch.ops.image import FrameView, StreamFrame
    from vitparticlefiltertracker_tpu_torch.runtime.tracker import Tracker

    cfg = Config.from_dict(copy.deepcopy(chip_smoke.TINY_HEAD_REDETECT))
    src = open_source(cfg.io.source, 13, tuple(cfg.io.frame_size))
    sfs = _roi_chunks(src, 128, 3, cuda_device)[:12]
    prm = Tracker(copy.deepcopy(cfg), device="cpu").vit_params
    rows = {}
    for kind in ("chunks", "steps", "eager"):
        tr = Tracker(copy.deepcopy(cfg), vit_params=prm, device="cuda", graphs=kind != "eager")
        tr.init(src.frames[0], src.init_bbox)
        if kind == "chunks":
            out = []
            for i in range(0, 12, 4):
                part = sfs[i:i + 4]
                chunk = StreamFrame(FrameView(torch.stack([s.track.pixels for s in part]),
                                              torch.stack([s.track.origin for s in part]), 1.0), part[0].glob)
                out.append(tr.step_chunk_packed(chunk))
            rows[kind] = torch.cat(out).cpu()
            (key,) = [k for k in tr._chunk_graphs if k[0][0] == 4]
            assert len(tr._chunk_graphs[key].branch_counts) == 8
            assert sum(tr._chunk_graphs[key].taken.tolist()[1::2]) >= 1  # a scan ran in a chunk graph
        else:
            rows[kind] = torch.stack([tr.step_packed(s) for s in sfs]).cpu()
    assert torch.equal(rows["chunks"], rows["steps"])
    torch.testing.assert_close(rows["chunks"][:, :2], rows["eager"][:, :2], rtol=0, atol=chip_smoke.GRAPH_POS_TOL_PX)
    assert torch.equal(rows["chunks"][:, 8:], rows["eager"][:, 8:])
    assert bool(rows["chunks"][:, 9].any())  # some frame was lost


def test_chunked_roi_stream_submitter_waits_for_nothing(cuda_device):
    """stream_track with ROI shipping, chunk 4 and a one-frame tail on the
    card (tiny tracker with re-detection on the teleport clip): the
    submitting thread waits for the card only in init and capture and once
    at the end, never in the loop; records complete and in order."""
    import chip_smoke
    from vitparticlefiltertracker_tpu_torch.io.video import open_source
    from vitparticlefiltertracker_tpu_torch.runtime.streaming import stream_track
    from vitparticlefiltertracker_tpu_torch.runtime.tracker import Tracker

    cfg = Config.from_dict(copy.deepcopy(chip_smoke.TINY_HEAD_REDETECT))
    src = open_source(cfg.io.source, 23, tuple(cfg.io.frame_size))
    tr = Tracker(copy.deepcopy(cfg), device="cuda")
    recs, stats = [], {}

    def go():
        stats.update(stream_track(tr, src, src.init_bbox, on_record=recs.append, roi_px=128, glob_stride=3,
                                  glob_every=4, chunk=4, steer_lag=8, readback_window=8))

    where, _ = chip_smoke.stream_waits(go, "tiny chunked ROI stream")
    assert where["loop"] == 0 and where["final"] == 1
    assert stats["dispatches"] == {4: 5, 1: 2} and stats["staging_waits"] == 0
    assert stats["graph_captures"] == 0  # init captured every size the stream uses
    assert sorted(r["frame"] for r in recs) == list(range(1, 23))


def test_stream_spans_on_the_traces_clock(cuda_device, tmp_path):
    """utils/profiling.py trace around a tiny stream on the card: its chrome
    trace holds a step.launch span a dispatch, each overlapping the graph
    launch (cudaGraphLaunch) it made, so the program's spans sit on the
    profiler's clock; no graph is captured inside the stream."""
    import json

    import chip_smoke
    from vitparticlefiltertracker_tpu_torch.io.video import open_source
    from vitparticlefiltertracker_tpu_torch.runtime.streaming import stream_track
    from vitparticlefiltertracker_tpu_torch.runtime.tracker import Tracker
    from vitparticlefiltertracker_tpu_torch.utils.profiling import trace

    cfg = Config.from_dict(copy.deepcopy(chip_smoke.TINY))
    src = open_source("synthetic:moving-square", 24, (128, 128))
    with trace(str(tmp_path)):
        stats = stream_track(Tracker(cfg, device="cuda"), src, src.init_bbox, on_record=lambda r: None)
    assert stats["graph_captures"] == 0 and stats["spans"]["step.launch"]["n"] == 23
    (path,) = tmp_path.glob("*.json")
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    launches = [e for e in events if e.get("cat") == "program_span" and e["name"] == "step.launch"]
    graphs = [e for e in events if str(e.get("name", "")).startswith("cudaGraphLaunch")]
    assert len(launches) == 23 and len(graphs) >= 23
    for span in launches:
        assert any(g["ts"] < span["ts"] + span["dur"] and span["ts"] < g["ts"] + g["dur"] for g in graphs), span


def test_run_benchmark_on_the_card(cuda_device, tmp_path):
    """The bench harness on eval2 (tools/port_bench_evals.py's config) with
    small counts: the device span from CUDA events, at most the host-clock
    p50, an MFU in (0, 1) against the card's bf16 basis, and the offline
    phase's trace in runtime.profile_dir."""
    import chip_smoke
    from vitparticlefiltertracker_tpu_torch.runtime.benchmark import run_benchmark

    cfg = chip_smoke._bench_evals.config(2)
    cfg.runtime.profile_dir = str(tmp_path)
    r = run_benchmark(cfg, warmup=2, measure_frames=10, latency_frames=4, stage_frames=2, verbose=False)
    assert len(list(tmp_path.glob("*.json"))) == 1
    assert r["config"]["backend"] == "cuda" and r["config"]["device"] == torch.cuda.get_device_name(0)
    assert r["p50_device_source"] == "cuda_events" and 0 < r["p50_device_ms"] <= r["p50_ms"]
    assert r["peak_memory_mib"] > 0
    if "H100" in torch.cuda.get_device_name(0):
        assert r["peak_tflops"] == 989.0 and 0 < r["mfu"] < 1


def test_branch_launches_count_after_the_tracker_is_gone(cuda_device):
    """The probe's launches (an IF-node body) count at the next
    settle_counts although the tracker that ran them was dropped before it,
    as run_benchmark drops its own: K1 launches by shape equal one forward
    at init, one a step and one a lost step."""
    import gc

    import chip_smoke
    from vitparticlefiltertracker_tpu_torch.io.video import open_source
    from vitparticlefiltertracker_tpu_torch.models.vit import VitSpec
    from vitparticlefiltertracker_tpu_torch.runtime.tracker import Tracker

    cfg = Config.from_dict(copy.deepcopy(chip_smoke.TINY_TELEPORT))
    src = open_source(cfg.io.source, cfg.io.num_frames, tuple(cfg.io.frame_size))
    chip_smoke.reset_counts()
    recs = list(Tracker(cfg, device="cuda").run(src))
    gc.collect()
    counts = chip_smoke.read_counts()
    probes = sum(r["lost"] for r in recs[:-1])
    assert probes > 0
    t = VitSpec.from_config(cfg.model).seq_len
    assert counts["k1_shapes"] == {(1, cfg.model.heads, t): cfg.model.depth * (1 + len(recs) + probes)}


def test_trace_reads_device_time_by_kernel(cuda_device, tmp_path):
    """utils/profiling.py on the card: trace() dumps a chrome trace, and
    device_time_by_kernel finds K1's kernel with a device time."""
    from vitparticlefiltertracker_tpu_torch.utils.profiling import device_time_by_kernel, trace

    q, k, v = _qkv_views((1, 12, 196, 64), torch.bfloat16, "fused", seed=3, device=cuda_device)
    attention.flash_attention(q, k, v)
    torch.cuda.synchronize()
    with trace(str(tmp_path)) as prof:
        for _ in range(4):
            attention.flash_attention(q, k, v)
        torch.cuda.synchronize()
    assert len(list(tmp_path.glob("*.json"))) == 1
    times = device_time_by_kernel(prof)
    assert any("attn_" in name and ms > 0 for name, ms in times.items()), sorted(times)


def test_flash_attention_refuses_inputs_that_require_grad(cuda_device):
    """K1 writes through ctypes into a tensor with no grad_fn: both entry
    points raise on an input that requires grad (a gradient would be cut
    silently), and launch nothing."""
    q, k, v = _qkv_views((1, 12, 196, 64), torch.bfloat16, "fused", seed=3, device=cuda_device)
    before = attention.flash_attention.launches
    for fn in (attention.flash_attention, attention.multi_head_attention):
        with pytest.raises(RuntimeError, match="no backward"):
            fn(q.detach().requires_grad_(), k, v)
    assert attention.flash_attention.launches == before
    with torch.no_grad():
        attention.flash_attention(q.detach().requires_grad_(), k, v)  # no gradient asked for
    assert attention.flash_attention.launches == before + 1


def test_load_weights_reaches_the_captured_step_graphs(cuda_device):
    """Tracker.load_weights after the step graph was captured on other
    weights: track_clip_device equals a fresh tracker built on the new ones.
    Binding a new tree to vit_params instead leaves the graph reading the
    old tensors."""
    import chip_smoke
    from vitparticlefiltertracker_tpu_torch.io.video import open_source
    from vitparticlefiltertracker_tpu_torch.models import params as tparams
    from vitparticlefiltertracker_tpu_torch.models.vit import VitSpec
    from vitparticlefiltertracker_tpu_torch.runtime.tracker import Tracker

    cfg = Config.from_dict(copy.deepcopy(chip_smoke.TINY_NO_RESAMPLE))
    spec = VitSpec.from_config(cfg.model)
    w1, w2 = (tparams.init_vit_params(tparams.jax_random.key(s), spec, "cuda") for s in (1, 2))
    src = open_source(cfg.io.source, cfg.io.num_frames, tuple(cfg.io.frame_size))
    clip = torch.from_numpy(np.stack(src.frames[1:])).cuda()

    def run(tracker):
        tracker.init(src.frames[0], src.init_bbox)
        return chip_smoke.pack_rows(tracker.track_clip_device(clip))

    own = lambda w: {g: (own(x) if isinstance(x, dict) else x.clone()) for g, x in w.items()}  # noqa: E731
    want = run(Tracker(cfg, vit_params=w2, device="cuda"))
    loaded = Tracker(cfg, vit_params=own(w1), device="cuda")
    first = run(loaded)
    loaded.load_weights(w2)
    got = run(loaded)
    np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=0, atol=chip_smoke.GRAPH_POS_TOL_PX)
    assert np.array_equal(got[:, 8:], want[:, 8:])
    rebound = Tracker(cfg, vit_params=own(w1), device="cuda")
    run(rebound)
    rebound.vit_params = tparams.resolve_vit_params(cfg, w2, "cuda")
    stale = run(rebound)
    # The rebound tracker's graph still reads the tensors it was captured on,
    # which nothing holds any more: the old weights, or whatever their freed
    # memory holds by then (NaN in one run on the card).
    assert not np.allclose(stale[:, :2], want[:, :2], rtol=0, atol=chip_smoke.GRAPH_POS_TOL_PX)
    assert np.abs(first[:, :2] - want[:, :2]).max() > 1.0  # the two weights track apart


def test_train_step_on_the_card_matches_the_cpu(cuda_device):
    """One f32 train step of the tiny config on the card against the CPU on
    the same injected batch and draws: loss, metrics, every gradient leaf;
    the trainer's attention forward; K1's refusal (chip_smoke's train
    phase (a))."""
    import chip_smoke

    out = chip_smoke.check_train_parity()
    assert out["grad_max_abs_err"] <= chip_smoke.TRAIN_GRAD_ATOL


@pytest.fixture
def nccl_mesh(cuda_device, tmp_path):
    """make_mesh(1, 1, 1) over a one-rank NCCL group (a file store in the
    test's directory), destroyed after the test."""
    import torch.distributed as dist
    from vitparticlefiltertracker_tpu_torch.parallel.mesh import init_distributed, make_mesh

    init_distributed("cuda", store=str(tmp_path / "store"))
    try:
        yield make_mesh(1, 1, 1)
    finally:
        dist.destroy_process_group()


def _mesh_and_plain_runs(cfg_dict, mesh, clip: bool = False):
    """A tiny tracker through its captured graphs on the card with the
    one-rank mesh and without: (records or track_clip_device rows, counts,
    tracker) for each; the host's waits inside track_clip_device with clip."""
    import chip_smoke
    from vitparticlefiltertracker_tpu_torch.io.video import open_source
    from vitparticlefiltertracker_tpu_torch.runtime.tracker import Tracker

    cfg = Config.from_dict(copy.deepcopy(cfg_dict))
    src = open_source(cfg.io.source, cfg.io.num_frames, tuple(cfg.io.frame_size))
    prm = Tracker(copy.deepcopy(cfg), device="cpu").vit_params
    out = {}
    for m in (None, mesh):
        tr = Tracker(copy.deepcopy(cfg), vit_params=prm, device="cuda", mesh=m)
        chip_smoke.reset_counts()
        if clip:
            tr.init(src.frames[0], src.init_bbox)
            frames = torch.from_numpy(np.stack(src.frames[1:])).cuda()
            torch.cuda.synchronize()
            outs, stacks = [], []
            waits = chip_smoke.count_waits(lambda: outs.append(tr.track_clip_device(frames)), stacks)
            assert waits == 0, stacks
            recs = chip_smoke.pack_rows(outs[0])
        else:
            recs = [{k: v for k, v in r.items() if k != "step_ms"} for r in tr.run(src)]
        out[m is not None] = (recs, chip_smoke.read_counts(), tr)
    return out


def test_mesh_world_one_dense_step_equals_unsharded(nccl_mesh):
    """The dense step on make_mesh(1, 1, 1) over NCCL, its collectives
    captured in the step's graph (1 all-gather of the scores and 2 peer
    all-reduce launches a block a replay), gives mesh=None's records."""
    import chip_smoke

    out = _mesh_and_plain_runs(chip_smoke.TINY, nccl_mesh)
    (plain, pc, _), (mesh, mc, tr) = out[False], out[True]
    assert mesh == plain
    depth = tr.cfg.model.depth
    assert mc["k1_shapes"] == pc["k1_shapes"] and mc["all_gathers"] == len(mesh)
    assert mc["peer_launches"] == 2 * mc["launches"] and pc["peer_launches"] == pc["all_gathers"] == 0
    tally = chip_smoke.replay_tally(tr)
    assert (tally["all_gathers"], tally["peer_launches"]) == (1, 2 * depth)


def test_mesh_world_one_if_bodies_hold_collectives(nccl_mesh):
    """With the lost gate and re-detection (the head, its automatic blend)
    the probe's and the scan's IF-node bodies hold the forward's peer
    all-reduce launches: captured and replayed, no host wait in
    track_clip_device, the rows equal mesh=None's."""
    import chip_smoke

    out = _mesh_and_plain_runs(chip_smoke.TINY_HEAD_REDETECT, nccl_mesh, clip=True)
    (plain, _, _), (mesh, mc, tr) = out[False], out[True]
    assert np.array_equal(mesh, plain) and mesh[:, 9].any()
    assert mc["peer_launches"] == 2 * mc["launches"]
    assert [b > 0 for b in chip_smoke.replay_tally(tr)["branch_peer_launches"]] == [True, True]


def test_mesh_world_one_banked_step_equals_unsharded(nccl_mesh):
    """MultiTracker on make_mesh(1, 1, 1): the banks' rows all-gathered over
    "bank" after each replay equal mesh=None's rows."""
    import chip_smoke
    from vitparticlefiltertracker_tpu_torch.io.video import open_source
    from vitparticlefiltertracker_tpu_torch.runtime import banked
    from vitparticlefiltertracker_tpu_torch.runtime.tracker import Tracker

    d = copy.deepcopy(chip_smoke.TINY_BANKED_REDETECT)
    d["runtime"] = {"banks": 3}
    cfg = Config.from_dict(d)
    src = open_source(cfg.io.source, cfg.io.num_frames, tuple(cfg.io.frame_size))
    prm = Tracker(copy.deepcopy(cfg), device="cpu").vit_params
    rows = {}
    for m in (None, nccl_mesh):
        tr = banked.MultiTracker(copy.deepcopy(cfg), prm, "cuda", mesh=m)
        tr.init(src.frames[0], banked.banked_bboxes(src.init_bbox, 3))
        rows[m is not None] = torch.stack([tr.step_packed(torch.from_numpy(f).cuda()) for f in src.frames[1:]]).cpu()
    assert torch.equal(rows[True], rows[False])


@pytest.mark.parametrize("shape", [(1, 196, 768), (1, 196, 1024), (49, 196, 768)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_peer_kernel_one_rank_matches_plain(nccl_mesh, shape, dtype):
    """The peer all-reduce kernel on the one-rank "model" group of
    make_mesh(1, 1, 1) (the product in the model dtype, the bias, one add)
    against its plain version, bit for bit; one launch counted."""
    from chip_smoke import peer_inputs
    from vitparticlefiltertracker_tpu_torch.ops import peer_allreduce as par

    parts, bias = peer_inputs(shape, 1, seed=4)
    x, b = parts[0].to(dtype).cuda(), bias.to(dtype).cuda()
    before = par.peer_all_reduce.launches
    got = par.peer_all_reduce(x, b, nccl_mesh.peers)
    assert par.peer_all_reduce.launches == before + 1
    assert torch.equal(got, par.peer_all_reduce_plain(x[None], b))


def test_peer_kernel_two_processes_on_one_card(cuda_device):
    """Two processes on cuda:0 (a gloo group; CUDA IPC within a card):
    chip_smoke's peer phase, the kernel over f32 partials at the B/16, L/16
    and scan shapes against its plain version, bit for bit, both ranks
    equal, then the robust path on make_mesh(1, 1, 2) with the kernel in
    its IF bodies (its own checks)."""
    import chip_smoke

    from vitparticlefiltertracker_tpu_torch.ops import peer_allreduce as par

    out = chip_smoke.run_peer_phase()
    assert all(row["max_abs_err"] == 0.0 for row in out["kernel"].values())
    scan = chip_smoke.PEER_SHAPES[2]
    assert {form for shape, _, form in out["kernel"] if shape == scan} == {par.ONE_SHOT, par.TWO_SHOT}
    assert out["robust"]["graph_vs_eager_max_px"] <= chip_smoke.GRAPH_POS_TOL_PX


def test_peer_kernel_refuses_what_it_cannot_take(nccl_mesh):
    """Inputs outside the kernel's contract raise ValueError before a
    launch: a length not a multiple of 8, a bias of another length, the
    two-shot form on a one-rank group."""
    from vitparticlefiltertracker_tpu_torch.ops import peer_allreduce as par

    with pytest.raises(ValueError, match="multiples of 8"):
        par.peer_all_reduce(torch.zeros(3, 5, device="cuda"), torch.zeros(5, device="cuda"), nccl_mesh.peers)
    with pytest.raises(ValueError, match="bias must be"):
        par.peer_all_reduce(torch.zeros(2, 8, device="cuda"), torch.zeros(16, device="cuda"), nccl_mesh.peers)
    with pytest.raises(ValueError, match="two-shot"):  # a one-rank group has nothing to scatter
        par.peer_all_reduce(torch.zeros(2, 8, device="cuda"), torch.zeros(8, device="cuda"), nccl_mesh.peers,
                            form=par.TWO_SHOT)
