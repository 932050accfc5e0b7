"""Port parity and contract: the training loop (vitparticlefiltertracker_tpu_torch/
training/train.py), its checkpoints (models/params.py save_params) and the
train command, against the JAX package's training/train.py and
tests/test_training.py.

The whole train step (scene, objective, gradients, freeze, clip, AdamW) runs
on the JAX step's own batch and draws (rebuilt from its keys) and is held to
JAX's jitted step_fn over three steps: the loss to rtol 1e-4 and the
parameters to atol 2e-5, tests/test_training.py:117-122's tolerances.
Checkpoint files round-trip bit for bit both ways.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_training import PARAM_ATOL, LOSS_RTOL, _np_tree, jax_step_inputs, tiny_train_dict

from vitparticlefiltertracker_tpu.config import Config as JConfig
from vitparticlefiltertracker_tpu.models import params as jparams
from vitparticlefiltertracker_tpu.models import vit as jvit
from vitparticlefiltertracker_tpu.training import train as jtrain
from vitparticlefiltertracker_tpu_torch import cli
from vitparticlefiltertracker_tpu_torch.config import Config
from vitparticlefiltertracker_tpu_torch.io.video import open_source
from vitparticlefiltertracker_tpu_torch.models import params as tparams
from vitparticlefiltertracker_tpu_torch.models import vit as tvit
from vitparticlefiltertracker_tpu_torch.ops import attention
from vitparticlefiltertracker_tpu_torch.runtime.tracker import Tracker
from vitparticlefiltertracker_tpu_torch.training import data as tdata
from vitparticlefiltertracker_tpu_torch.training import objective as tobj
from vitparticlefiltertracker_tpu_torch.training import train as ttrain


def tiny_cfg(**train_over) -> Config:
    return Config.from_dict(tiny_train_dict(**train_over))


def _tree_np(params: dict) -> dict:
    return {k: v.detach().numpy().copy() for k, v in tparams._flatten(params).items()}


# -- the whole step against the JAX package's --------------------------------


def _zero_gradient_entries(name: str, value: np.ndarray, heads: int) -> np.ndarray:
    """Entries whose gradient is zero in exact arithmetic: a final LN's bias
    (the window-mean centering removes any constant added to every token)
    and the key third of bqkv (a constant added to every key's logit of a
    row leaves its softmax unchanged). Both packages compute rounding noise
    there, and Adam's normalization turns the noise into steps of about the
    rate, so the two packages' values differ by up to a few steps."""
    mask = np.zeros(value.shape, bool)
    if name in ("ln_final/bias", "head/ln/bias"):
        mask[...] = True
    elif name.endswith("attn/bqkv"):
        m = mask.reshape(*value.shape[:-1], heads, 3, -1)
        m[..., 1, :] = True
    return mask


@pytest.mark.parametrize("case", [{}, {"model": {"head_depth": 2}, "lookalike_frac": 0.6, "blur_prob": 0.5}],
                         ids=["full", "head-2"])
def test_train_steps_match_jax_step_fn(case):
    """Three whole steps: loss and gradient norm at each, every parameter
    after each (the zero-gradient entries within the optimizer's own step
    bound: |update| <= 3.2 lr for Adam with these betas, so two packages lie
    within 2 x 3.2 x the rates so far)."""
    d = tiny_train_dict(**case)
    jcfg, tcfg = JConfig.from_dict(d), Config.from_dict(d)
    init_j, step_j = jtrain.build_train_step(jcfg)
    jp, jopt = init_j()
    step_j = jax.jit(step_j)
    init_t, step_t = ttrain.build_train_step(tcfg, "cpu")
    params, opt = init_t()
    lr = ttrain.lr_schedule(tcfg.train)
    for i in range(3):
        jp, jopt, jm = step_j(jp, jopt, jnp.int32(i))
        _, _, batch, draws = jax_step_inputs(jcfg, i)
        params, opt, tm = step_t(params, opt, i, batch, draws)
        assert set(tm) == set(jm)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=LOSS_RTOL)
        want = _np_tree(jp)
        step_bound = 2 * 3.2 * sum(lr(t) for t in range(i + 1))
        for k, v in tparams._flatten(params).items():
            got = v.detach().numpy()
            noise = _zero_gradient_entries(k, got, tcfg.model.heads)
            np.testing.assert_allclose(got[~noise], want[k][~noise], rtol=0, atol=PARAM_ATOL, err_msg=f"step {i}: {k}")
            assert np.all(np.abs(got[noise] - want[k][noise]) <= step_bound), f"step {i}: {k}"


# -- tests/test_training.py's cases, on the port --------------------------------


def test_pair_batch_shapes_and_ranges():
    b = tdata.make_pair_batch(torch.Generator().manual_seed(0), batch=3, size=96)
    assert b.frame0.shape == (3, 96, 96, 3) and b.frame1.shape == (3, 96, 96, 3) and b.frame2.shape == (3, 96, 96, 3)
    assert b.p0.shape == (3, 2) and b.wh.shape == (3, 2) and b.look_on.shape == (3,)
    f0 = b.frame0.numpy()
    assert f0.min() >= 0.0 and f0.max() <= 255.0
    assert float(f0.std()) > 10.0  # textured, not blank
    p1 = b.p1.numpy()
    assert np.all(p1 > 0.1 * 96) and np.all(p1 < 0.9 * 96)
    assert np.all(b.wh.numpy() >= 5.0)


def test_pair_batch_counter_deterministic():
    """A step's batch is a function of (seed, step): the generator the
    trainer keys on them gives the same scene again, another step another."""
    from vitparticlefiltertracker_tpu_torch.filters.particle import make_generator

    a = tdata.make_pair_batch(make_generator(7, 3, "cpu"), 2, 64)
    b = tdata.make_pair_batch(make_generator(7, 3, "cpu"), 2, 64)
    np.testing.assert_array_equal(a.frame1.numpy(), b.frame1.numpy())
    c = tdata.make_pair_batch(make_generator(7, 4, "cpu"), 2, 64)
    assert np.abs(a.frame1.numpy() - c.frame1.numpy()).mean() > 1.0


def test_ring_offsets_cover_fine_and_clear_radii():
    r = np.linalg.norm(tobj.ring_offsets().numpy(), axis=1)
    assert r.shape == (40,)
    assert np.isclose(r.min(), 0.3, atol=1e-5) and r.max() >= 3.0 - 1e-6 and np.all(r >= 0.25)


def test_decay_mask_kernels_only():
    params, _ = ttrain.build_train_step(tiny_cfg(), "cpu")[0]()
    mask = ttrain._decay_mask(params)
    assert mask["patch_embed"]["kernel"] is True and mask["patch_embed"]["bias"] is False
    assert mask["blocks"]["attn"]["wqkv"] is True and mask["blocks"]["ln1"]["scale"] is False
    assert mask["pos_embed"] is False


def test_train_step_reduces_loss_and_flows_grads():
    """Step 0 applies rate 0 (the warmup starts at zero); step 1 moves the
    patch embed: the gradient reaches it through window -> ViT -> ROI ->
    cosine -> softmax."""
    init_fn, step_fn = ttrain.build_train_step(tiny_cfg(steps=2), "cpu")
    params, opt = init_fn()
    p0 = params["patch_embed"]["kernel"].detach().clone()
    params, opt, m = step_fn(params, opt, 0)
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0.0
    assert torch.equal(params["patch_embed"]["kernel"], p0)
    params, opt, m = step_fn(params, opt, 1)
    assert float((params["patch_embed"]["kernel"].detach() - p0).abs().max()) > 0


def test_freeze_prefix_pins_early_layers():
    """patch/pos embed and the first block stay bitwise (AdamW's decoupled
    decay included) while block 1 trains; a prefix of the whole depth raises."""
    init_fn, step_fn = ttrain.build_train_step(tiny_cfg(steps=3, freeze_prefix=1), "cpu")
    params, opt = init_fn()
    p0 = _tree_np(params)
    for i in range(3):
        params, opt, _ = step_fn(params, opt, i)
    p = _tree_np(params)
    assert np.array_equal(p0["patch_embed/kernel"], p["patch_embed/kernel"])
    assert np.array_equal(p0["pos_embed"], p["pos_embed"])
    assert np.array_equal(p0["blocks/attn/wqkv"][0], p["blocks/attn/wqkv"][0])
    assert not np.array_equal(p0["blocks/attn/wqkv"][1], p["blocks/attn/wqkv"][1])
    with pytest.raises(ValueError):
        ttrain.build_train_step(tiny_cfg(freeze_prefix=2), "cpu")  # depth-2 model


def test_head_training_holds_the_trunk_byte_frozen():
    init_fn, step_fn = ttrain.build_train_step(tiny_cfg(steps=3, model={"head_depth": 2}), "cpu")
    params, opt = init_fn()
    p0 = _tree_np(params)
    for i in range(3):
        params, opt, _ = step_fn(params, opt, i)
    p = _tree_np(params)
    assert all(k.startswith("head/") for k in opt.leaves)
    for k in p0:
        if not k.startswith("head/"):
            assert np.array_equal(p0[k], p[k]), k
    assert not np.array_equal(p0["head/blocks/attn/wqkv"], p["head/blocks/attn/wqkv"])


def test_blur_augmentation():
    img = torch.from_numpy(np.random.default_rng(0).uniform(0, 255, (1, 32, 32, 3)).astype(np.float32))
    out_on = tdata._sep_blur(img, torch.ones(1), torch.ones(1)).numpy()
    out_off = tdata._sep_blur(img, torch.ones(1), torch.zeros(1)).numpy()
    assert np.array_equal(out_off, img.numpy())
    assert np.isfinite(out_on).all()
    assert out_on.std() < img.numpy().std() * 0.9  # blur removes high-frequency energy
    assert abs(out_on.mean() - img.numpy().mean()) < 2.0  # the kernel sums to 1, the edge held


def test_train_features_metrics_out_writes_jsonl(tmp_path):
    metrics = str(tmp_path / "sub" / "metrics.jsonl")
    train_features = ttrain.train_features
    train_features(tiny_cfg(steps=4, log_every=2, metrics_out=metrics), log=lambda s: None, device="cpu")
    rows = [json.loads(line) for line in open(metrics)]
    assert len(rows) == 2
    assert all("loss" in r and np.isfinite(r["loss"]) for r in rows)
    assert rows[-1]["step"] == 4
    keys = list(rows[0])
    assert keys[-2:] == ["step", "wall_s"] and keys[:-2] == sorted(keys[:-2])  # as the JAX package's lines


def test_train_features_end_to_end_checkpoint_tracks(tmp_path):
    """The trained checkpoint loads through model.checkpoint in both
    packages' readers and the port's tracker runs on it."""
    ckpt = str(tmp_path / "trained.npz")
    lines = []
    params = ttrain.train_features(tiny_cfg(steps=6, checkpoint_out=ckpt), log=lines.append, device="cpu")
    assert any("loss" in s for s in lines) and lines[-1] == f"saved {ckpt}"
    jtree = jparams.load_params(ckpt)
    for k, v in _tree_np(params).items():
        assert np.array_equal(np.asarray(jparams._flatten(jtree)[k]), v), k
    tcfg = Config.from_dict({"model": {**tiny_train_dict()["model"], "checkpoint": ckpt},
                             "filter": {"num_particles": 64}, "tracker": {"mode": "dense"}})
    src = open_source("synthetic:moving-square", 5, (128, 128))
    recs = list(Tracker(tcfg, device="cpu").run(src))
    assert len(recs) == 4 and all(np.isfinite(r["position"]).all() for r in recs)


def test_head_training_writes_and_resumes_a_head_only_file(tmp_path):
    """Head training on the seeded trunk writes a head-only file; a run that
    starts from it regenerates the trunk (bit-equal to the seeded init) and
    writes a head-only file again; a bfloat16 checkpoint_dtype quantizes the
    head only."""
    first, second = str(tmp_path / "head.npz"), str(tmp_path / "head2.npz")
    ttrain.train_features(tiny_cfg(steps=2, model={"head_depth": 2}, checkpoint_out=first), log=lambda s: None,
                          device="cpu")
    lines = []
    cfg = tiny_cfg(steps=2, model={"head_depth": 2, "checkpoint": first}, checkpoint_out=second,
                   checkpoint_dtype="bfloat16")
    params = ttrain.train_features(cfg, log=lines.append, device="cpu")
    assert lines[0] == f"initialized from {first} (head-only: trunk regenerated)"
    seeded = _tree_np(ttrain.build_train_step(cfg, "cpu")[0]()[0])
    for k, v in _tree_np(params).items():
        if not k.startswith("head/"):
            assert np.array_equal(v, seeded[k]), k
    raw = np.load(second)
    assert int(raw["__vpt_trunk_seed__"]) == 0 and all(k.startswith(("head/", "__vpt")) for k in raw.files)
    assert json.loads(raw["__vpt_dtypes__"].tobytes())["head/blocks/attn/wqkv"] == "bfloat16"


def test_train_command_runs_on_the_cpu(tmp_path):
    ckpt = str(tmp_path / "cli.npz")
    path = tmp_path / "train.json"
    path.write_text(json.dumps(tiny_train_dict(steps=2, checkpoint_out=ckpt)))
    assert cli.main(["train", "--config", str(path), "--device", "cpu", "--quiet"]) == 0
    assert tparams.load_params(ckpt)["blocks"]["attn"]["wqkv"].shape == (2, 64, 192)
    assert "train" in cli.build_parser().parse_args(["train"]).command


# -- checkpoints both ways --------------------------------------------------------

FILE_CASES = ["float32", "bfloat16", "head-only"]


def _jax_tree(case: str):
    spec = jvit.VitSpec(depth=2, dim=64, heads=2, mlp_dim=128, image_size=64, head_depth=2)
    tree = jvit.init_vit_params(jax.random.key(4), spec)
    if case == "bfloat16":
        tree = jax.tree.map(lambda x: x.astype(jnp.bfloat16), tree)
    return tree


def _bits(x) -> np.ndarray:
    """A leaf's bytes as an integer array of its width (bfloat16 by its bits)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy().view(np.uint8)
    return np.asarray(x).view(np.uint8)


@pytest.mark.parametrize("case", FILE_CASES)
def test_port_save_loads_in_jax_bitwise(tmp_path, case):
    from vitparticlefiltertracker_tpu_torch import bridge

    tree = bridge.params_from_numpy(jax.tree.map(np.asarray, _jax_tree(case)),
                                    tvit.VitSpec(depth=2, dim=64, heads=2, mlp_dim=128, image_size=64))
    path = str(tmp_path / "port.npz")
    tparams.save_params(path, tree, trunk_seed=7 if case == "head-only" else None)
    got = jparams.load_params(path)
    if case == "head-only":
        assert got.pop("__trunk_seed__") == 7 and set(got) == {"head"}
        tree = {"head": tree["head"]}
    flat = jparams._flatten(got)
    want = tparams._flatten(tree)
    assert set(flat) == set(want)
    for k, v in want.items():
        assert str(np.asarray(flat[k]).dtype) == str(v.dtype).removeprefix("torch."), k
        assert np.array_equal(_bits(flat[k]), _bits(v)), k


@pytest.mark.parametrize("case", FILE_CASES)
def test_jax_save_loads_in_port_bitwise(tmp_path, case):
    tree = _jax_tree(case)
    path = str(tmp_path / "jax.npz")
    jparams.save_params(path, tree, trunk_seed=7 if case == "head-only" else None)
    got = tparams.load_params(path)
    if case == "head-only":
        assert got.pop("__trunk_seed__") == 7 and set(got) == {"head"}
        tree = {"head": tree["head"]}
    flat, want = tparams._flatten(got), jparams._flatten(jax.device_get(tree))
    assert set(flat) == set(want)
    for k, v in want.items():
        assert np.array_equal(_bits(flat[k]), _bits(v)), k
    # And back out of the port: the same bytes the JAX package wrote.
    again = str(tmp_path / "again.npz")
    tparams.save_params(again, got, trunk_seed=7 if case == "head-only" else None)
    a, b = np.load(path), np.load(again)
    assert set(a.files) == set(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_save_params_refuses_what_it_cannot_write(tmp_path):
    with pytest.raises(ValueError, match="npz"):
        tparams.save_params(str(tmp_path / "dir"), {"w": torch.zeros(2)})
    with pytest.raises(ValueError, match="head"):
        tparams.save_params(str(tmp_path / "x.npz"), {"w": torch.zeros(2)}, trunk_seed=0)


# -- attention for training (K1 has no backward) ----------------------------------


def test_kernel_entry_points_refuse_inputs_that_require_grad():
    """K1 writes through ctypes into a tensor with no grad_fn, so a gradient
    through it would be cut silently: multi_head_attention raises on an
    input that requires grad (on any device, so the CPU shows it), and the
    plain version the trainer's spec picks differentiates."""
    q, k, v = (torch.randn(1, 2, 5, 64, requires_grad=True) for _ in range(3))
    with pytest.raises(RuntimeError, match="no backward"):
        attention.multi_head_attention(q, k, v)
    with torch.no_grad():
        attention.multi_head_attention(q, k, v)  # inference: no gradient asked for
    attention.multi_head_attention(q.detach(), k.detach(), v.detach())
    attention.reference_attention(q, k, v).sum().backward()
    assert q.grad is not None and k.grad is not None and v.grad is not None


def test_training_spec_differentiates_the_vit_and_the_tracker_spec_does_not():
    cfg = tiny_cfg()
    es = ttrain._train_embed_spec(cfg)
    assert es.vit.use_flash_attention is False
    assert tvit.VitSpec.from_config(cfg.model).use_flash_attention is True
    params, _ = ttrain.build_train_step(cfg, "cpu")[0]()
    x = torch.randn(2, 64, 64, 3)
    tvit.vit_forward_tokens(params, x, es.vit).square().sum().backward()
    assert params["blocks"]["attn"]["wqkv"].grad.abs().sum() > 0
    with pytest.raises(RuntimeError, match="no backward"):
        tvit.vit_forward_tokens(params, x, es.vit._replace(use_flash_attention=True))


# -- loading weights into a built tracker --------------------------------------------


def test_load_weights_equals_a_fresh_tracker_and_checks_shapes():
    """Tracker.load_weights copies the new weights into the tensors the
    tracker (and, on the card, its captured step graphs) reads: after it the
    tracker runs as one built with those weights."""
    d = {"model": {"variant": "vit-t16", "image_size": 64, "dtype": "float32"}, "filter": {"num_particles": 64},
         "tracker": {"mode": "dense"}}
    cfg = Config.from_dict(d)
    spec = tvit.VitSpec.from_config(cfg.model)
    w2 = tparams.init_vit_params(tparams.jax_random.key(9), spec)
    src = open_source("synthetic:moving-square", 5, (128, 128))
    tracker = Tracker(cfg, device="cpu")
    held = tracker.vit_params["blocks"]["attn"]["wqkv"]
    list(tracker.run(src))
    tracker.load_weights(w2)
    assert tracker.vit_params["blocks"]["attn"]["wqkv"] is held and torch.equal(held, w2["blocks"]["attn"]["wqkv"])
    got = [r["position"] for r in tracker.run(src)]
    want = [r["position"] for r in Tracker(cfg, vit_params=w2, device="cpu").run(src)]
    assert got == want
    small = tparams.init_vit_params(tparams.jax_random.key(9), spec._replace(depth=1))
    with pytest.raises(ValueError, match="load_weights"):
        tracker.load_weights(small)
