"""Port parity: the tracker end to end, dense and crop mode
(vitparticlefiltertracker_tpu_torch/runtime/tracker.py).

synthetic:moving-square goes through both packages in f32 with a tiny ViT,
the JAX package's random weights bridged into the port, and the JAX
package's noise draws (draw_step_noise(fold_in(key, frame_idx)), the
init_state cloud and global re-detection's reseed normals) injected into the
port. The JAX side runs under HIGHEST
matmul precision (this JAX build's default is bf16-class even on the CPU).
Per frame: position within 0.5 px, `resampled` and `lost` exact.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitparticlefiltertracker_tpu.config import Config as JConfig
from vitparticlefiltertracker_tpu.filters import particle as jpf
from vitparticlefiltertracker_tpu.io.video import open_source as j_open_source
from vitparticlefiltertracker_tpu.models.params import resolve_vit_params
from vitparticlefiltertracker_tpu.runtime import tracker as jtr
from vitparticlefiltertracker_tpu_torch import bridge
from vitparticlefiltertracker_tpu_torch.config import Config as TConfig
from vitparticlefiltertracker_tpu_torch.filters import particle as tpf
from vitparticlefiltertracker_tpu_torch.io.video import open_source as t_open_source
from vitparticlefiltertracker_tpu_torch.models.vit import VitSpec
from vitparticlefiltertracker_tpu_torch.runtime import tracker as ttr
from vitparticlefiltertracker_tpu_torch.runtime.step_graph import run_if_always

# The suite runs in several worker processes on one host, and every worker
# imports this module (the shared parity helper of the tracker tests) while
# collecting. With torch's default of one intra-op thread per core each
# worker's parallel regions wait on threads the other workers hold: the
# tracker tests ran many times slower in six workers than alone. One
# thread a worker keeps them at their single-process time.
torch.set_num_threads(1)

FRAMES = 9  # one init frame + 8 steps

BASE = {
    "model": {"variant": "custom", "depth": 2, "dim": 128, "heads": 2, "mlp_dim": 256,
              "image_size": 64, "dtype": "float32", "checkpoint": ""},
    "filter": {"num_particles": 256, "motion": {"sigma_pos": 3.0}},
    "tracker": {"mode": "dense"},
    "io": {"source": "synthetic:moving-square", "num_frames": FRAMES, "frame_size": [224, 224]},
}
LOST = copy.deepcopy(BASE)
LOST["filter"]["lost_conf_ratio"] = 0.97  # fires on some frames: probe, coast, frozen window


def _crop(impl):
    d = copy.deepcopy(BASE)
    d["tracker"] = {"mode": "crop", "crop_impl": impl}
    return d


def branch_runner(kind, log=None):
    """The run_if of a port step under test. None: the step's own (the host
    reads each predicate). "host": the rule of the card's IF nodes, each
    body run where the predicate the step computed holds, read here because
    the CPU has no IF node, and logged as (branch, value) to `log`.
    "every-step": every body on every step (as the capture's warm-up runs
    them), which the merges after the branches must make harmless."""
    if kind is None:
        return None
    if kind == "every-step":
        return run_if_always

    def run_if(pred, body):
        value = bool(pred)
        if log is not None:
            log.append((body.__name__, value))
        if value:
            body()

    return run_if


def _run_both(cfg_dict, frames=FRAMES, host_branches=None, preds=None):
    """Both packages over `frames` frames of the config's source -> (JAX
    outputs, port outputs, JAX states, port states), one a step.

    host_branches: how the port's step runs its probe and scan branches
    (branch_runner: None, "host" or "every-step"); preds: a list for
    "host"'s log of the predicates, one entry a branch a step."""
    jcfg = JConfig.from_dict(copy.deepcopy(cfg_dict))
    tcfg = TConfig.from_dict(copy.deepcopy(cfg_dict))
    size = tuple(jcfg.io.frame_size)
    src = j_open_source(jcfg.io.source, frames, size, seed=0)
    tsrc = t_open_source(tcfg.io.source, frames, size, seed=0)
    np.testing.assert_array_equal(tsrc.frames, src.frames)
    np.testing.assert_array_equal(tsrc.truth, src.truth)
    clip, bbox = src.frames, np.asarray(src.init_bbox, np.float32)
    n = jcfg.filter.num_particles

    jp = resolve_vit_params(jcfg)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), VitSpec.from_config(tcfg.model))
    jf = jtr.build_tracker_fns(jcfg)
    tf = ttr.build_tracker_fns(tcfg)
    key = jax.random.key(0)
    center = jnp.asarray(bbox[:2] + bbox[2:] / 2)
    cloud = jpf.init_state(jax.random.fold_in(key, 0xFFFFFFFF), center, n, jtr._pf_params(jcfg))

    def t_(x):
        return torch.from_numpy(np.array(x))

    with jax.default_matmul_precision("highest"):
        jstate = jax.jit(jf.init)(jp, jnp.asarray(clip[0]), jnp.asarray(bbox), jnp.int32(0))
        jstep = jax.jit(jf.step)
        tstate = tf.init(tp, torch.from_numpy(clip[0]), torch.from_numpy(bbox), 0,
                         cloud=t_(cloud.particles))
        np.testing.assert_allclose(tstate.pf.particles.numpy(), np.asarray(jstate.pf.particles),
                                   atol=1e-4)
        np.testing.assert_allclose(tstate.template.numpy(), np.asarray(jstate.template), atol=1e-5)
        jouts, touts, jstates, tstates = [], [], [], []
        for i in range(1, frames):
            fkey = jax.random.fold_in(key, i - 1)
            noise = tpf.StepNoise(*(t_(x) for x in jpf.draw_step_noise(fkey, n)))
            # The JAX step's reseed draw (runtime/tracker.py, fold constant 0x5EED1).
            reseed = t_(jax.random.normal(jax.random.fold_in(fkey, 0x5EED1), (n, 2), jnp.float32))
            jstate, jo = jstep(jp, jstate, jnp.asarray(clip[i]))
            tstate, to = tf.step(tp, tstate, torch.from_numpy(clip[i]), noise=noise, reseed=reseed,
                                 run_if=branch_runner(host_branches, preds))
            jouts.append(jax.tree.map(np.asarray, jo))
            touts.append(to)
            jstates.append(jstate)
            tstates.append(tstate)
    return jouts, touts, jstates, tstates


def _compare(jouts, touts):
    for i, (jo, to) in enumerate(zip(jouts, touts)):
        np.testing.assert_allclose(to.position.numpy(), jo.position, atol=0.5, err_msg=f"frame {i + 1}")
        assert bool(to.resampled) == bool(jo.resampled), f"frame {i + 1}"
        assert bool(to.lost) == bool(jo.lost), f"frame {i + 1}"
        np.testing.assert_allclose(float(to.conf), float(jo.conf), atol=1e-3, err_msg=f"frame {i + 1}")


def test_dense_tracker_matches_jax():
    jouts, touts, _, _ = _run_both(BASE)
    _compare(jouts, touts)
    assert not any(bool(o.lost) for o in touts)


def test_dense_tracker_lost_gate_matches_jax(tmp_path):
    jouts, touts, jstates, tstates = _run_both(LOST)
    jstate, tstate = jstates[-1], tstates[-1]
    _compare(jouts, touts)
    lost = [bool(o.lost) for o in jouts]
    assert any(lost) and not all(lost), lost  # both branches of the gate ran

    # A state saved by either package loads in the other (all but `key`).
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jtr.save_tracker_state(jpath, jstate)
    ttr.save_tracker_state(tpath, tstate)
    from_j = ttr._named_state_leaves(ttr.load_tracker_state(jpath))
    from_t = jtr._named_state_leaves(jtr.load_tracker_state(tpath))
    mine = ttr._named_state_leaves(tstate)
    theirs = jtr._named_state_leaves(jstate)
    assert sorted(from_j) == sorted(mine) == sorted(from_t) == sorted(theirs)
    for k in mine:
        if k == "key":
            continue
        a, b = np.asarray(theirs[k]), from_j[k].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(b, a, err_msg=k)
        c, d = mine[k].numpy(), np.asarray(from_t[k])
        assert c.dtype == d.dtype and c.shape == d.shape, k
        np.testing.assert_array_equal(d, c, err_msg=k)


@pytest.mark.parametrize("impl", ["frame", "window", "window-pallas"])
def test_crop_tracker_matches_jax(impl):
    """Crop mode, each crop_impl (the JAX package takes its XLA path for
    window-pallas on the CPU; the port its plain version): position within
    0.5 px, flags exact, conf within 1e-3, as for dense mode."""
    jouts, touts, _, _ = _run_both(_crop(impl))
    _compare(jouts, touts)
    assert not any(bool(o.lost) for o in touts)


def test_tracker_class_runs_and_resumes_on_cpu(tmp_path):
    cfg = TConfig.from_dict(copy.deepcopy(BASE))
    src = t_open_source(cfg.io.source, 5, tuple(cfg.io.frame_size), seed=0)
    tr = ttr.Tracker(cfg, device="cpu")
    recs = list(tr.run(src))
    assert [r["frame"] for r in recs] == [1, 2, 3, 4]
    assert set(recs[0]) == {"position", "box", "velocity", "conf", "ess", "resampled",
                            "lost", "step_ms", "frame"}
    # Counter-based noise: a resumed tracker continues the same trajectory.
    path = str(tmp_path / "s.npz")
    a = ttr.Tracker(cfg, device="cpu")
    a.init(src.frames[0], src.init_bbox)
    a.step(src.frames[1])
    a.save(path)
    want = a.step(src.frames[2])
    b = ttr.Tracker(cfg, device="cpu")
    b.resume(path)
    got = b.step(src.frames[2])
    assert got["position"] == want["position"] and got["resampled"] == want["resampled"]


def test_unported_options_raise():
    """runtime.banks > 1 in the single-object Tracker: as in the JAX
    package, the Tracker tracks one object whatever runtime.banks says (the
    banked trackers are runtime/banked.py's): one record a frame, with the
    records of runtime.banks 1, and the JAX Tracker's record keys. Asking
    for CUDA without a card raises."""
    d = copy.deepcopy(BASE)
    d["runtime"] = {"banks": 2}
    src = t_open_source(d["io"]["source"], 4, tuple(d["io"]["frame_size"]), seed=0)
    banked_cfg = list(ttr.Tracker(TConfig.from_dict(copy.deepcopy(d)), device="cpu").run(src))
    single = list(ttr.Tracker(TConfig.from_dict(copy.deepcopy(BASE)), device="cpu").run(src))
    jrecs = list(jtr.Tracker(JConfig.from_dict(copy.deepcopy(d))).run(src))
    assert len(banked_cfg) == len(single) == len(jrecs) == 3
    for a, b, j in zip(banked_cfg, single, jrecs):
        assert len(a["position"]) == len(j["position"]) == 2 and not isinstance(a["position"][0], list)
        assert {k: v for k, v in a.items() if k != "step_ms"} == {k: v for k, v in b.items() if k != "step_ms"}
        assert set(a) == set(j)
    with pytest.raises(RuntimeError, match="cuda"):
        ttr.Tracker(TConfig.from_dict(copy.deepcopy(BASE)), device="cuda") if not torch.cuda.is_available() \
            else (_ for _ in ()).throw(RuntimeError("cuda present"))


def test_norm_folded_embed_weights_fold_pixel_normalization():
    """x @ K' + b' == normalize(x) @ K + b for raw 0..255 pixels (the JAX
    closure of the same name, runtime/tracker.py:248, has no handle)."""
    from vitparticlefiltertracker_tpu_torch.models.embedder import normalize_window
    from vitparticlefiltertracker_tpu_torch.models.vit import patchify

    spec = VitSpec(dim=32, patch_size=4, dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    prm = {"patch_embed": {"kernel": torch.randn(48, 32, generator=g),
                           "bias": torch.randn(32, generator=g)}}
    raw = torch.rand(1, 8, 8, 3, generator=g) * 255
    kern, bias = ttr._norm_folded_embed_weights(prm, spec)
    got = patchify(raw, 4) @ kern + bias
    want = patchify(normalize_window(raw), 4) @ prm["patch_embed"]["kernel"] + prm["patch_embed"]["bias"]
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_tracker_spec_in_crop_mode_matches_jax():
    """Crop mode embeds crop_size crops, so Tracker.spec.image_size is the
    crop size (vit-t16 at image_size 128 in crop mode: 32), as in the JAX
    package's Tracker. Every field the two specs share is equal, but
    use_flash_attention: the port's tracker spec keeps it True whatever the
    config says (every tracker attention on the card runs K1); only its
    trainer's spec sets it False."""
    d = {"model": {"variant": "vit-t16", "image_size": 128, "dtype": "float32",
                   "use_flash_attention": False, "checkpoint": ""},
         "filter": {"num_particles": 64}, "tracker": {"mode": "crop"}}
    want = jtr.Tracker(JConfig.from_dict(copy.deepcopy(d))).spec
    got = ttr.Tracker(TConfig.from_dict(copy.deepcopy(d)), device="cpu").spec
    assert got.image_size == want.image_size == 32
    assert got.use_flash_attention is True
    shared = set(got._fields) & set(want._fields) - {"dtype", "use_flash_attention"}
    assert {f: getattr(got, f) for f in shared} == {f: getattr(want, f) for f in shared}


@pytest.mark.parametrize("anchor", [True, False], ids=["with-anchor", "pre-anchor"])
def test_round1_positional_state_loads_like_jax(tmp_path, anchor):
    """Round-1 state files (positional leaf_<i>, no format marker; the
    oldest without the anchor leaf), written from a JAX state as
    tests/test_checkpoint.py writes them, load in the port as in the JAX
    package: every leaf equal, dtypes and shapes included."""
    cfg = JConfig.from_dict(copy.deepcopy(BASE))
    src = j_open_source(cfg.io.source, 2, tuple(cfg.io.frame_size), seed=0)
    tr = jtr.Tracker(cfg)
    tr.init(src.frames[0], src.init_bbox)
    state = tr.state._replace(key=jax.random.key_data(tr.state.key))
    leaves = jax.tree_util.tree_leaves(state)[:11]  # round-1 states had no lost_count
    if not anchor:
        leaves = leaves[:3] + leaves[4:]
    path = str(tmp_path / "round1.npz")
    np.savez(path, **{f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)})

    jstate = jtr.load_tracker_state(path)
    theirs = jtr._named_state_leaves(jstate._replace(key=jax.random.key_data(jstate.key)))
    mine = ttr._named_state_leaves(ttr.load_tracker_state(path))
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        a, b = np.asarray(theirs[k]), mine[k].numpy()
        if k == "key":  # the port holds the key's raw words as int64
            a = a.astype(np.int64)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    if not anchor:
        np.testing.assert_array_equal(mine["anchor"].numpy(), mine["template"].numpy())
