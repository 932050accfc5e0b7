"""Port parity: the residual head (vitparticlefiltertracker_tpu_torch/
models/vit.py head blocks, models/embedder.py split scoring, the automatic
blend in runtime/tracker.py).

The JAX package's random weights with a head are bridged into the port and
both packages run on the same numpy inputs (the JAX side at HIGHEST matmul
precision). The design guarantees of tests/test_head.py are held in the
port: the trunk half is the headless forward bit for bit, blend 0 is the
headless tracker, and the automatic blend with pinned bounds is the static
blend.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_tracker_e2e import BASE, _compare, _run_both

from vitparticlefiltertracker_tpu.config import Config as JConfig
from vitparticlefiltertracker_tpu.models import embedder as jemb
from vitparticlefiltertracker_tpu.models import params as jparams
from vitparticlefiltertracker_tpu.models import vit as jvit
from vitparticlefiltertracker_tpu.models.params import resolve_vit_params
from vitparticlefiltertracker_tpu_torch import bridge
from vitparticlefiltertracker_tpu_torch.config import Config as TConfig
from vitparticlefiltertracker_tpu_torch.io.video import open_source
from vitparticlefiltertracker_tpu_torch.models import embedder as temb
from vitparticlefiltertracker_tpu_torch.models import params as tparams
from vitparticlefiltertracker_tpu_torch.models import vit as tvit
from vitparticlefiltertracker_tpu_torch.ops.likelihood import _cos_to_template, l2_normalize_split
from vitparticlefiltertracker_tpu_torch.runtime.tracker import Tracker

TOL = {"float32": 2e-5, "bfloat16": 6e-2}  # as tests/test_torch_vit.py


def _head(**model):
    d = copy.deepcopy(BASE)
    d["model"].update(head_depth=2, **model)
    return d


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_encode_tokens_with_head_matches_jax(dtype_name):
    kw = dict(depth=2, dim=128, heads=2, mlp_dim=256, patch_size=16, image_size=64, head_depth=2)
    jd, td = (jnp.float32, torch.float32) if dtype_name == "float32" else (jnp.bfloat16, torch.bfloat16)
    jspec = jvit.VitSpec(dtype=jd, use_flash_attention=False, **kw)
    tspec = tvit.VitSpec(dtype=td, **kw)
    jp = jparams.cast_for_inference(jvit.init_vit_params(jax.random.key(2), jspec), jspec)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tspec)
    x = np.random.default_rng(0).standard_normal((3, 16, 128)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jvit.encode_tokens(jp, jnp.asarray(x).astype(jd), jspec), np.float32)
    got = tvit.encode_tokens(tp, torch.from_numpy(x).to(td), tspec).float().numpy()
    assert got.shape == want.shape == (3, 16, 256)
    np.testing.assert_allclose(got, want, rtol=TOL[dtype_name], atol=TOL[dtype_name])


@pytest.mark.parametrize("appearance", ["cells", "pooled"])
def test_score_and_score_halves_match_jax(appearance):
    """The dense embedder with a head: pool (concat features, each half
    centered on the window mean), score at the static blend and the two
    unblended halves, on one window of the same frame and boxes."""
    d = _head(head_blend=0.3)
    d["tracker"]["appearance"] = appearance
    jcfg, tcfg = JConfig.from_dict(copy.deepcopy(d)), TConfig.from_dict(copy.deepcopy(d))
    jp = resolve_vit_params(jcfg)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tvit.VitSpec.from_config(tcfg.model))
    jes, tes = jemb.DenseEmbedSpec.from_config(jcfg), temb.DenseEmbedSpec.from_config(tcfg)
    assert tes.split == jes.split == (128, 0.3)
    rng = np.random.default_rng(4)
    frame = rng.uniform(0, 255, (120, 150, 3)).astype(np.float32)
    center, side = np.array([70.0, 60.0], np.float32), np.float32(80.0)
    xy = (center + rng.uniform(-30, 30, (64, 2))).astype(np.float32)
    wh = rng.uniform(12, 24, (64, 2)).astype(np.float32)
    shape = (25, 256) if appearance == "cells" else (256,)
    tmpl = l2_normalize_split(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)), tes.split)
    with jax.default_matmul_precision("highest"):
        jpool = jemb.make_dense_embedder(jp, jnp.asarray(frame), jnp.asarray(center), jnp.asarray(side), jes)
        j_emb, j_ok = jpool(jnp.asarray(xy), jnp.asarray(wh))
        j_cos, _ = jpool.score(jnp.asarray(tmpl.numpy()), jnp.asarray(xy), jnp.asarray(wh))
        j_f, j_h, _ = jpool.score_halves(jnp.asarray(tmpl.numpy()), jnp.asarray(xy), jnp.asarray(wh))
    tpool = temb.make_dense_embedder(tp, torch.from_numpy(frame), torch.from_numpy(center), torch.tensor(side), tes)
    t_emb, t_ok = tpool(torch.from_numpy(xy), torch.from_numpy(wh))
    t_cos, _ = tpool.score(tmpl, torch.from_numpy(xy), torch.from_numpy(wh))
    t_f, t_h, t_ok2 = tpool.score_halves(tmpl, torch.from_numpy(xy), torch.from_numpy(wh))
    np.testing.assert_array_equal(t_ok.numpy(), np.asarray(j_ok))
    np.testing.assert_array_equal(t_ok2.numpy(), np.asarray(j_ok))
    np.testing.assert_allclose(t_emb.numpy(), np.asarray(j_emb), rtol=1e-4, atol=1e-4)
    for got, want in ((t_cos, j_cos), (t_f, j_f), (t_h, j_h)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    torch.testing.assert_close(t_cos, 0.7 * t_f + 0.3 * t_h, rtol=1e-5, atol=1e-6)
    # The fused score is the pooled embeddings' split cosine.
    torch.testing.assert_close(t_cos, _cos_to_template(t_emb, tmpl, tes.split), rtol=1e-4, atol=1e-4)


def test_score_halves_needs_a_head():
    tes = temb.DenseEmbedSpec.from_config(TConfig.from_dict(copy.deepcopy(BASE)))
    with pytest.raises(ValueError, match="head"):
        temb.score_halves_from_feat(None, None, None, None, tes, None, None, None)


@pytest.mark.parametrize("auto", [False, True], ids=["static-blend", "auto-blend"])
def test_head_tracker_matches_jax(auto):
    """The dense tracker with a head, at the static blend or the automatic
    one (the running blend compared as state): every step as in JAX."""
    jouts, touts, jstates, tstates = _run_both(_head(head_blend_auto=auto))
    _compare(jouts, touts)
    for js, ts in zip(jstates, tstates):
        np.testing.assert_allclose(float(ts.blend), float(js.blend), atol=1e-3)
    assert (float(tstates[-1].blend) >= 0.0) == auto


def test_trunk_half_bit_exact():
    """As tests/test_head.py:test_trunk_half_bit_exact: the first half of
    the head model's features is the headless forward, bit for bit."""
    spec0 = tvit.VitSpec(depth=2, dim=64, heads=2, mlp_dim=128, patch_size=16, image_size=64,
                         dtype=torch.float32, use_pos_embed=False)
    spec1 = spec0._replace(head_depth=1)
    k = tparams.jax_random.key(0)
    p0, p1 = tparams.init_vit_params(k, spec0), tparams.init_vit_params(k, spec1)
    img = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    t0 = tvit.vit_forward_tokens(p0, img, spec0)
    t1 = tvit.vit_forward_tokens(p1, img, spec1)
    assert t1.shape[-1] == 2 * t0.shape[-1]
    assert torch.equal(t0, t1[..., : t0.shape[-1]])


def _cfg(head_depth: int, blend: float, **model) -> TConfig:
    return TConfig.from_dict({
        "model": {"variant": "vit-t16", "image_size": 64, "dtype": "float32", "use_flash_attention": False,
                  "head_depth": head_depth, "head_blend": blend, **model},
        "filter": {"num_particles": 128},
    })


def _run(cfg: TConfig, frames: int = 12) -> tuple[np.ndarray, list[float]]:
    src = open_source("synthetic:moving-square", frames, (192, 192))
    tr = Tracker(cfg, device="cpu")
    tr.init(src.frames[0], src.init_bbox)
    pos, blends = [], []
    for f in src.frames[1:]:
        pos.append(tr.step(f)["position"])
        blends.append(float(tr.state.blend))
    return np.array(pos), blends


def test_blend_zero_trajectory_identical():
    """As tests/test_head.py:test_blend_zero_trajectory_identical: blend 0
    removes the head structurally (config and weights), so the trajectory
    is the headless one exactly."""
    cfg_b0 = _cfg(1, 0.0)
    assert cfg_b0.model.head_depth == 0
    assert np.array_equal(_run(_cfg(0, 0.5))[0], _run(cfg_b0)[0])


def test_split_cosine_blend_zero_matches_trunk():
    g = torch.Generator().manual_seed(3)
    emb = torch.randn(5, 9, 32, generator=g)
    tmpl = l2_normalize_split(torch.randn(9, 32, generator=g), (16, 0.0))
    torch.testing.assert_close(_cos_to_template(emb, tmpl, (16, 0.0)),
                               _cos_to_template(emb[..., :16], tmpl[..., :16]), rtol=0, atol=1e-6)


def test_auto_blend_pinned_bounds_bit_exact_vs_static():
    """As tests/test_head.py: min == max == the static blend makes the
    automatic policy a no-op, so the trajectory is the static one exactly."""
    pos_static, _ = _run(_cfg(1, 0.5))
    pos_auto, _ = _run(_cfg(1, 0.5, head_blend_auto=True, head_blend_min=0.5, head_blend_max=0.5))
    assert np.array_equal(pos_static, pos_auto)


def test_auto_blend_adapts_and_stays_bounded():
    """As tests/test_head.py: on a clean unimodal clip the running blend
    falls from its 0.5 start toward head_blend_min, inside [min, max]."""
    _, blends = _run(_cfg(1, 0.5, head_blend_auto=True, head_blend_min=0.15, head_blend_max=0.6))
    assert all(0.15 - 1e-6 <= b <= 0.6 + 1e-6 for b in blends)
    assert blends[-1] < 0.3


def test_resolve_refuses_a_missing_or_mismatched_head():
    """As the JAX package's resolve_vit_params: model.head_depth > 0 needs
    weights with a head of that many blocks; a headless config drops one."""
    kw = dict(depth=2, dim=128, heads=2, mlp_dim=256, patch_size=16, image_size=64)
    with_head = tparams.init_vit_params(tparams.jax_random.key(0), tvit.VitSpec(head_depth=1, **kw))
    headless = {k: v for k, v in with_head.items() if k != "head"}
    for weights, msg in ((headless, "no 'head' subtree"), (with_head, "head has 1 blocks")):
        with pytest.raises(ValueError, match=msg):
            tparams.resolve_vit_params(TConfig.from_dict(_head()), weights)
    assert "head" not in tparams.resolve_vit_params(TConfig.from_dict(copy.deepcopy(BASE)), with_head)
