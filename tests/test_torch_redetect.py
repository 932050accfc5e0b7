"""Port parity: global re-detection (vitparticlefiltertracker_tpu_torch/
runtime/tracker.py's scan, models/embedder.py:tiled_window_embed).

The tiled embedder and the re-detecting tracker go through both packages on
the same numpy inputs, with the JAX package's random weights bridged into
the port and its noise, including the reseed draw, injected
(test_torch_tracker_e2e._run_both). Tolerances are those of _compare there:
position 0.5 px, `lost` and `resampled` exact, `conf` 1e-3. The last two
tests run the port alone, with its own noise, as the JAX package's teleport
tests run.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_tracker_e2e import BASE, _compare, _run_both

from vitparticlefiltertracker_tpu.config import Config as JConfig
from vitparticlefiltertracker_tpu.io.synthetic import teleport_times
from vitparticlefiltertracker_tpu.models import embedder as jemb
from vitparticlefiltertracker_tpu.models.params import resolve_vit_params
from vitparticlefiltertracker_tpu.ops.image import full_view as j_full_view
from vitparticlefiltertracker_tpu_torch import bridge
from vitparticlefiltertracker_tpu_torch.config import Config as TConfig
from vitparticlefiltertracker_tpu_torch.io.video import open_source
from vitparticlefiltertracker_tpu_torch.models import embedder as temb
from vitparticlefiltertracker_tpu_torch.models.vit import VitSpec
from vitparticlefiltertracker_tpu_torch.ops.image import full_view as t_full_view
from vitparticlefiltertracker_tpu_torch.runtime.tracker import Tracker

N_AFTER = 2


def scans_and_accepts(states, n_after=N_AFTER) -> tuple[int, int]:
    """Scans and accepted matches of a run, from the states it leaves: an
    accepted match reseeds the cloud with zero velocity everywhere; a scan
    without one leaves lost_count at n_after or more."""
    scans = accepts = 0
    for s in states:
        accepted = bool((np.asarray(s.pf.particles)[:, 2:4] == 0).all())
        scans += accepted or int(np.asarray(s.lost_count)) >= n_after
        accepts += accepted
    return scans, accepts


def _teleport(mode="dense", impl="window", **over):
    """Tiny ViT on 12 frames of 192x192 synthetic:teleport (hidden from frame
    4, back at 8), a relative lost gate that fires, and a scan after 2 lost
    frames on a 5 x 5 grid."""
    d = copy.deepcopy(BASE)
    d["io"] = {"source": "synthetic:teleport", "num_frames": 12, "frame_size": [192, 192]}
    d["filter"]["lost_conf_ratio"] = 0.9
    d["tracker"] = {"mode": mode, "crop_impl": impl, "redetect_global_after": N_AFTER,
                    "redetect_global_grid": 5, "redetect_accept_conf": 0.3}
    for path, val in over.items():
        section, key = path.split("__")
        d[section][key] = val
    return d


CASES = {
    "dense": _teleport(),
    "dense-head": _teleport(model__head_depth=2),
    # The robust config's stack: head with the automatic blend, relative
    # acceptance with a z margin, and re-lock hysteresis (an accepted match
    # reseeds but leaves `lost` to the next probe).
    "dense-head-auto-relock": _teleport(model__head_depth=2, model__head_blend_auto=True,
                                        tracker__redetect_accept_conf=0.0, tracker__redetect_accept_ratio=0.35,
                                        tracker__redetect_accept_z=2.0, tracker__relock_conf_ratio=0.9),
    "crop-frame": _teleport("crop", "frame"),
    "crop-window": _teleport("crop", "window"),
    "crop-window-pallas": _teleport("crop", "window-pallas"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_redetecting_tracker_matches_jax(case):
    """Every step as in the JAX package, through at least one scan and one
    accepted match, with the same scans and acceptances on both sides."""
    jouts, touts, jstates, tstates = _run_both(CASES[case], frames=12)
    _compare(jouts, touts)
    want, got = scans_and_accepts(jstates), scans_and_accepts(tstates)
    assert got == want and got[0] >= 1 and got[1] >= 1, (got, want)
    for js, ts in zip(jstates, tstates):
        assert int(ts.lost_count) == int(js.lost_count)
        np.testing.assert_allclose(ts.center.numpy(), np.asarray(js.center), atol=0.5)
        np.testing.assert_allclose(float(ts.blend), float(js.blend), atol=1e-3)


@pytest.mark.parametrize("appearance", ["cells", "pooled"])
@pytest.mark.parametrize("head_depth", [0, 2])
def test_tiled_window_embed_matches_jax(appearance, head_depth):
    """G tile windows through one batched forward, C candidates pooled in
    each (centered on their own window's mean), against the JAX vmap."""
    d = copy.deepcopy(BASE)
    d["model"]["head_depth"] = head_depth
    d["tracker"]["appearance"] = appearance
    jcfg, tcfg = JConfig.from_dict(copy.deepcopy(d)), TConfig.from_dict(copy.deepcopy(d))
    jp = resolve_vit_params(jcfg)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), VitSpec.from_config(tcfg.model))
    jes, tes = jemb.DenseEmbedSpec.from_config(jcfg), temb.DenseEmbedSpec.from_config(tcfg)
    rng = np.random.default_rng(3)
    frame = rng.uniform(0, 255, (96, 128, 3)).astype(np.float32)
    tiles = np.array([[32, 24], [96, 24], [32, 72], [96, 72]], np.float32)
    cand = tiles[:, None, :] + rng.uniform(-12, 12, (4, 9, 2)).astype(np.float32)
    cand[0, 0] = [-40.0, 5.0]  # outside its tile window: not valid
    side, wh = np.float32(60.0), np.array([20.0, 16.0], np.float32)
    with jax.default_matmul_precision("highest"):
        want_emb, want_ok = jemb.tiled_window_embed(jp, j_full_view(jnp.asarray(frame)), jnp.asarray(tiles),
                                                    jnp.asarray(side), jes, jnp.asarray(cand), jnp.asarray(wh))
    got_emb, got_ok = temb.tiled_window_embed(tp, t_full_view(torch.from_numpy(frame)), torch.from_numpy(tiles),
                                              torch.tensor(side), tes, torch.from_numpy(cand), torch.from_numpy(wh))
    assert tuple(got_emb.shape) == want_emb.shape
    assert got_emb.shape[-1] == 128 * (2 if head_depth else 1)
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    assert not bool(got_ok[0, 0]) and bool(got_ok[1:].all())
    np.testing.assert_allclose(got_emb.numpy(), np.asarray(want_emb), rtol=1e-4, atol=1e-4)


def _own_run(tracker_over: dict) -> np.ndarray:
    """The port alone (own weights from the seed, own noise), as the JAX
    package's teleport tests configure it -> per-frame position error."""
    cfg = TConfig.from_dict({
        "model": {"variant": "vit-t16", "image_size": 64, "dtype": "float32", "use_flash_attention": False},
        "filter": {"num_particles": 256, "lost_conf_threshold": 0.6},
        "tracker": {"mode": "dense", "redetect_global_grid": 5, **tracker_over},
    })
    src = open_source("synthetic:teleport", 40, (192, 192))
    recs = list(Tracker(cfg, device="cpu").run(src))
    pos = np.array([r["position"] for r in recs])
    return np.linalg.norm(pos - src.truth[1:], axis=1)


def test_global_redetection_recovers_teleport():
    """As tests/test_tracker_e2e.py:test_global_redetection_recovers_teleport
    for the JAX package: stuck without the scan, re-locked with it."""
    _, t_show = teleport_times(40)
    err_off = _own_run({"redetect_global_after": 0, "redetect_accept_conf": 0.3})
    err_on = _own_run({"redetect_global_after": 3, "redetect_accept_conf": 0.3})
    assert err_off[t_show + 4:].mean() > 50.0, err_off[t_show + 4:]
    assert err_on[t_show + 4:].mean() < 15.0, err_on[t_show + 4:]


def test_redetect_accept_ratio_recovers_teleport():
    """As tests/test_tracker_e2e.py:test_redetect_accept_ratio_recovers_teleport:
    an absolute gate above the features' cosine scale vetoes every reseed;
    the relative gate re-locks."""
    _, t_show = teleport_times(40)
    err_abs = _own_run({"redetect_global_after": 3, "redetect_accept_conf": 0.99})
    err_rel = _own_run({"redetect_global_after": 3, "redetect_accept_ratio": 0.35})
    assert err_abs[t_show + 4:].mean() > 50.0, err_abs[t_show + 4:]
    assert err_rel[t_show + 4:].mean() < 15.0, err_rel[t_show + 4:]
