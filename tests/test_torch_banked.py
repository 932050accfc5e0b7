"""Port parity: banked and multi-stream trackers (vitparticlefiltertracker_tpu_torch/
runtime/banked.py: MultiTracker, MultiStreamTracker, build_banked_fns,
build_multistream_fns, banked_bboxes), K filters in one batched step.

The JAX package's vmapped step against the port's step on state with a
leading bank axis, on the same numpy-made clips, with the JAX package's
random weights bridged into the port and its noise injected: bank k's
initial cloud, step noise and re-detection reseed from jax.random.key(seed
+ k) folded with the frame index, as test_torch_tracker_e2e._run_both
injects one bank's. Tolerances are those of the single-object tests: per
frame and bank, position within 0.5 px, `resampled` and `lost` exact, conf
within 1e-3. The port-only tests mirror the JAX suite's banked tests
(tests/test_tracker_e2e.py, tests/test_head.py) with the port's own noise.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_redetect import CASES as REDETECT_CASES
from test_torch_tracker_e2e import BASE, branch_runner

from vitparticlefiltertracker_tpu.config import Config as JConfig
from vitparticlefiltertracker_tpu.filters import particle as jpf
from vitparticlefiltertracker_tpu.models.params import resolve_vit_params
from vitparticlefiltertracker_tpu.runtime import banked as jbk
from vitparticlefiltertracker_tpu.runtime import tracker as jtr
from vitparticlefiltertracker_tpu_torch import bridge
from vitparticlefiltertracker_tpu_torch import cli as tcli
from vitparticlefiltertracker_tpu_torch.config import Config as TConfig
from vitparticlefiltertracker_tpu_torch.filters import particle as tpf
from vitparticlefiltertracker_tpu_torch.io.video import open_source
from vitparticlefiltertracker_tpu_torch.models.vit import VitSpec
from vitparticlefiltertracker_tpu_torch.runtime import banked as tbk
from vitparticlefiltertracker_tpu_torch.runtime import tracker as ttr
from vitparticlefiltertracker_tpu_torch.runtime.step_graph import state_leaves

FRAMES = 7  # one init frame + 6 steps


def _with(d, **sections):
    d = copy.deepcopy(d)
    for section, values in sections.items():
        d.setdefault(section, {}).update(values)
    return d


def _clips(cfg, kind: str, k: int, frames: int):
    """(first frames, frames a step [T, ...], bboxes [K, 4], truth [T, K, 2]):
    one clip (seed 0) for the banked form, its boxes tiled or one a target;
    k clips seeded 0..k-1 for the streams."""
    size = tuple(cfg.io.frame_size)
    if kind == "banked":
        src = open_source(cfg.io.source, frames, size, seed=0)
        truth = src.truth if src.truth.ndim == 3 else np.repeat(src.truth[:, None], k, axis=1)
        return src.frames[0], src.frames[1:], tbk.banked_bboxes(src.init_bbox, k), truth[1:]
    srcs = [open_source(cfg.io.source, frames, size, seed=i) for i in range(k)]
    clips = np.stack([np.stack(s.frames) for s in srcs], axis=1)  # [T, K, H, W, 3]
    truth = np.stack([s.truth for s in srcs], axis=1)
    return clips[0], clips[1:], np.stack([s.init_bbox for s in srcs]), truth[1:]


def _to_port(jstate) -> ttr.TrackerState:
    """A JAX TrackerState (any leading axes) as the port's, leaf for leaf."""
    leaves = jtr._named_state_leaves(jstate._replace(key=jax.random.key_data(jstate.key)))
    t = {k: torch.from_numpy(np.array(v)) for k, v in leaves.items()}
    t["key"] = t["key"].to(torch.int64)
    pf = tpf.PFState(t.pop("pf/particles"), t.pop("pf/log_weights"))
    return ttr.TrackerState(pf=pf, **t)


def _run_both(cfg_dict, k: int, kind: str = "banked", frames: int = FRAMES, host_branches=None,
              forced: bool = False, preds=None):
    """The JAX package's vmapped fns and the port's banked fns over the same
    clip(s) -> (JAX outputs, port outputs, JAX states, port states), one a
    step, each with a leading K.

    host_branches: how the port's step runs its probe and scan branches
    (test_torch_tracker_e2e.branch_runner: None, the step's own; "host", the
    card's IF-node rule, a body for all banks where any bank's predicate
    holds; "every-step", every body on every step). forced: each port step
    starts from the JAX state before it (so each frame compares one step,
    from equal states). preds: a list for "host"'s log of the predicates."""
    cfg_dict = _with(cfg_dict, runtime={"banks": k})
    jcfg, tcfg = JConfig.from_dict(copy.deepcopy(cfg_dict)), TConfig.from_dict(copy.deepcopy(cfg_dict))
    first, steps, bboxes, _ = _clips(tcfg, kind, k, frames)
    n = jcfg.filter.num_particles
    seeds = np.arange(k, dtype=np.int32) + jcfg.filter.seed
    jp = resolve_vit_params(jcfg)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), VitSpec.from_config(tcfg.model))
    if kind == "banked":
        jinit, jstep, _ = jbk.build_banked_fns(jcfg)
        tf = tbk.build_banked_fns(tcfg)
    else:
        jinit, jstep, _ = jbk.build_multistream_fns(jcfg, k)
        tf = tbk.build_multistream_fns(tcfg, k)
    keys = [jax.random.key(int(s)) for s in seeds]
    centers = bboxes[:, :2] + bboxes[:, 2:] / 2
    pfp = jtr._pf_params(jcfg)
    cloud = np.stack([np.asarray(jpf.init_state(jax.random.fold_in(key, 0xFFFFFFFF), jnp.asarray(c), n, pfp).particles)
                      for key, c in zip(keys, centers)])

    def draws(i):
        """Every bank's step noise and reseed normals at frame index i."""
        fkeys = [jax.random.fold_in(key, i) for key in keys]
        noise = [jpf.draw_step_noise(fk, n) for fk in fkeys]
        noise = tpf.StepNoise(*(torch.from_numpy(np.stack([np.asarray(x[f]) for x in noise])) for f in range(4)))
        reseed = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(fk, 0x5EED1), (n, 2), jnp.float32))
                           for fk in fkeys])
        return noise, torch.from_numpy(reseed)

    with jax.default_matmul_precision("highest"):
        jstate = jax.jit(jinit)(jp, jnp.asarray(first), jnp.asarray(bboxes), jnp.asarray(seeds))
        jstep = jax.jit(jstep)
        tstate = tf.init(tp, torch.from_numpy(first), torch.from_numpy(bboxes), seeds.tolist(),
                         cloud=torch.from_numpy(cloud))
        np.testing.assert_allclose(tstate.template.numpy(), np.asarray(jstate.template), atol=1e-5)
        jouts, touts, jstates, tstates = [], [], [], []
        for i, frame in enumerate(steps):
            noise, reseed = draws(i)
            if forced:
                tstate = _to_port(jstate)
            jstate, jo = jstep(jp, jstate, jnp.asarray(frame))
            tstate, to = tf.step(tp, tstate, torch.from_numpy(frame), noise=noise, reseed=reseed,
                                 run_if=branch_runner(host_branches, preds))
            jouts.append(jax.tree.map(np.asarray, jo))
            touts.append(to)
            jstates.append(jstate)
            tstates.append(tstate)
    return jouts, touts, jstates, tstates


def _compare(jouts, touts, k):
    for i, (jo, to) in enumerate(zip(jouts, touts)):
        assert tuple(to.position.shape) == (k, 2) and tuple(to.lost.shape) == (k,)
        np.testing.assert_allclose(to.position.numpy(), jo.position, atol=0.5, err_msg=f"frame {i + 1}")
        np.testing.assert_array_equal(to.resampled.numpy(), jo.resampled, err_msg=f"frame {i + 1}")
        np.testing.assert_array_equal(to.lost.numpy(), jo.lost, err_msg=f"frame {i + 1}")
        np.testing.assert_allclose(to.conf.numpy(), jo.conf, atol=1e-3, err_msg=f"frame {i + 1}")


def _branch_log(jstates, n_after, probe: bool) -> list:
    """The (branch, predicate) log a step with the JAX package's lax.cond
    conditions gives, over banks: the probe where any bank's previous state
    was lost, the scan where any bank's trigger (lost count after the
    update, before an accepted match resets it) reached n_after."""
    log, prev_lost = [], False
    for s in jstates:
        if probe:
            log.append(("probe", prev_lost))
        accepted = (np.asarray(s.pf.particles)[..., 2:4] == 0).all(axis=(-2, -1))
        log.append(("scan", bool((accepted | (np.asarray(s.lost_count) >= n_after)).any())))
        prev_lost = bool(np.asarray(s.lost).any())
    return log


def _scans_and_accepts(states, n_after) -> np.ndarray:
    """[K, 2] scans and accepted matches a bank, read from the states a run
    leaves (as test_torch_redetect.scans_and_accepts for one filter)."""
    out = 0
    for s in states:
        accepted = (np.asarray(s.pf.particles)[..., 2:4] == 0).all(axis=(-2, -1))
        out = out + np.stack([accepted | (np.asarray(s.lost_count) >= n_after), accepted], axis=-1).astype(int)
    return out


MULTI = _with(BASE, io={"source": "synthetic:multi-3", "num_frames": FRAMES, "frame_size": [224, 224]})


def test_banked_dense_matches_jax():
    """Three banks, each on its own target of synthetic:multi-3, dense mode."""
    jouts, touts, _, _ = _run_both(MULTI, 3)
    _compare(jouts, touts, 3)
    assert not any(bool(o.lost.any()) for o in touts)


@pytest.mark.parametrize("arming", [None, "host", "every-step"])
@pytest.mark.parametrize("case", ["dense", "dense-head"])
def test_banked_redetect_matches_jax(case, arming):
    """Two banks on the teleport clip (both on its one target, seeds 0 and 1)
    with the lost gate, the probe and global re-detection: branches by the
    step's own host reads, by the card's IF-node rule on the predicates the
    step computes (which must be JAX's lax.cond conditions, over banks), or
    every body on every step. JAX's vmap runs both sides of each lax.cond
    and selects per bank; the port runs a branch for all banks when any
    needs it and gates each bank's effects on its own flags. The same
    records, lost counts, scans and accepted matches a bank as JAX."""
    preds = []
    jouts, touts, jstates, tstates = _run_both(REDETECT_CASES[case], 2, frames=12, host_branches=arming,
                                               preds=preds)
    _compare(jouts, touts, 2)
    n_after = REDETECT_CASES[case]["tracker"]["redetect_global_after"]
    if arming == "host":
        assert preds == _branch_log(jstates, n_after, probe=True)
    want, got = _scans_and_accepts(jstates, n_after), _scans_and_accepts(tstates, n_after)
    np.testing.assert_array_equal(got, want)
    assert got[:, 0].sum() >= 1 and got[:, 1].sum() >= 1, got
    for js, ts in zip(jstates, tstates):
        np.testing.assert_array_equal(ts.lost_count.numpy(), np.asarray(js.lost_count))
        np.testing.assert_allclose(ts.center.numpy(), np.asarray(js.center), atol=0.5)


def test_banked_robust_step_matches_jax():
    """The robust config's stack through the bank axis (the head with its
    automatic blend, relative acceptance with a z margin, re-lock
    hysteresis), two banks on the teleport clip, every branch body run on
    every step: each frame one step of both packages from the same (JAX)
    state.
    Run free, this pair forks: the two programs round differently by a few
    ulps, and a particle on the window's edge flips in or out on one side
    (the JAX package's own vmapped step departs from its single-object step
    on bank 1 in the same way; the port's bank k equals its single-object
    step with seed k bit for bit)."""
    case = REDETECT_CASES["dense-head-auto-relock"]
    jouts, touts, jstates, tstates = _run_both(case, 2, frames=12, host_branches="every-step", forced=True)
    _compare(jouts, touts, 2)
    n_after = case["tracker"]["redetect_global_after"]
    want, got = _scans_and_accepts(jstates, n_after), _scans_and_accepts(tstates, n_after)
    np.testing.assert_array_equal(got, want)
    assert got[:, 0].sum() >= 1 and got[:, 1].sum() >= 1, got
    assert any(bool(o.lost.any()) for o in touts) and not all(bool(o.lost.all()) for o in touts)


def test_banked_head_matches_jax():
    """The residual head's split cosines through the bank axis (mirrors
    tests/test_head.py:test_banked_tracker_with_head: one head block at a
    static blend of 0.25, two banks on one target, each ends within 20 px of
    it)."""
    d = _with(BASE, model={"head_depth": 1, "head_blend": 0.25})
    jouts, touts, _, _ = _run_both(d, 2)
    _compare(jouts, touts, 2)
    src = open_source(d["io"]["source"], FRAMES, tuple(d["io"]["frame_size"]), seed=0)
    err = np.linalg.norm(touts[-1].position.numpy() - src.truth[FRAMES - 1][None], axis=1)
    assert np.all(err < 20.0), err


@pytest.mark.parametrize("impl", ["window-pallas", "frame"])
def test_banked_crop_matches_jax(impl):
    """Crop mode with two banks on synthetic:multi-2: window-pallas goes
    through K2's plain version over the 2 search windows (the JAX package
    takes its XLA path on the CPU), frame through the batched region gather."""
    d = _with(MULTI, tracker={"mode": "crop", "crop_impl": impl}, io={"source": "synthetic:multi-2"})
    jouts, touts, _, _ = _run_both(d, 2)
    _compare(jouts, touts, 2)


@pytest.mark.parametrize("mode,impl", [("dense", "window-pallas"), ("crop", "window-pallas"), ("crop", "frame")])
def test_multistream_matches_jax(mode, impl):
    """Three streams, each its own moving-square clip (seeds 0-2) and
    filter seed, one batched step a frame batch [3, H, W, 3]; in crop mode
    through K2's plain version over the 3 windows, or each stream's boxes
    gathered from its own frame. The last steps each frame from the JAX
    state: its 768 crops go through one embed product where a single
    tracker's 256 do, which rounds otherwise (about 1e-7 relative), and the
    free run drifts: stream 0 ends 0.16 px from the port's single-object
    tracker on the same draws at frame 6."""
    d = _with(BASE, tracker={"mode": mode, "crop_impl": impl})
    jouts, touts, _, _ = _run_both(d, 3, "streams", forced=impl == "frame")
    _compare(jouts, touts, 3)


def test_multistream_redetect_matches_jax():
    """Two teleport streams (clip seeds 0 and 1) with the lost gate and
    re-detection: each stream's scan tiles its own frame. Each frame is one
    step of both packages from the same (JAX) state: run free, stream 1
    forks at frame 3 (a particle on the window's edge), as it does between
    the port's and the JAX package's single-object trackers on that clip."""
    jouts, touts, jstates, tstates = _run_both(REDETECT_CASES["dense"], 2, "streams", frames=12,
                                               host_branches="host", forced=True)
    _compare(jouts, touts, 2)
    n_after = REDETECT_CASES["dense"]["tracker"]["redetect_global_after"]
    np.testing.assert_array_equal(_scans_and_accepts(tstates, n_after), _scans_and_accepts(jstates, n_after))


def _multi(kind, d=None, k=3, frames=FRAMES, **runtime):
    """A MultiTracker over synthetic:multi-3, or a MultiStreamTracker over k
    moving-square clips, on the CPU, after init -> (tracker, frames a step,
    truth [T, K, 2])."""
    d = _with(d or (MULTI if kind == "banked" else BASE), runtime={"banks": k, **runtime})
    cfg = TConfig.from_dict(d)
    first, steps, bboxes, truth = _clips(cfg, kind, k, frames)
    tr = tbk.MultiTracker(cfg, device="cpu") if kind == "banked" else tbk.MultiStreamTracker(cfg, k, device="cpu")
    tr.init(first, bboxes)
    return tr, steps, truth


def _rows(outs) -> np.ndarray:
    return torch.cat([outs.position, outs.box, outs.velocity, outs.conf[..., None], outs.ess[..., None],
                      outs.resampled[..., None].float(), outs.lost[..., None].float()], dim=-1).numpy()


@pytest.mark.parametrize("kind", ["banked", "streams"])
def test_track_clip_device_matches_sequential_steps(kind):
    """track_clip_device (MultiTracker) / track_clips_device
    (MultiStreamTracker) over the clip == step_device frame by frame: every
    field of every bank and frame, and the final state, equal."""
    tr_a, steps, _ = _multi(kind)
    seq = np.stack([_rows(tr_a.step_device(torch.from_numpy(f))) for f in steps])
    tr_b, _, _ = _multi(kind)
    clip = torch.from_numpy(np.stack(steps))
    outs = tr_b.track_clip_device(clip) if kind == "banked" else tr_b.track_clips_device(clip)
    assert tuple(outs.position.shape) == (len(steps), 3, 2) and outs.lost.dtype == torch.bool
    np.testing.assert_array_equal(_rows(outs), seq)
    for a, b in zip(state_leaves(tr_a.state), state_leaves(tr_b.state)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(tr_a._frame_idx, [len(steps)] * 3)


@pytest.mark.parametrize("kind", ["banked", "streams"])
def test_step_packed_matches_step_device(kind):
    """step_packed's row == pack_track_output(step_device(...)) in the JAX
    package's layout (each field's K values together), and both trackers
    advance alike."""
    tr_a, steps, _ = _multi(kind)
    tr_b, _, _ = _multi(kind)
    for f in steps:
        frame = torch.from_numpy(f)
        out = tr_a.step_device(frame)
        row = tr_b.step_packed(frame)
        assert tuple(row.shape) == (30,) and row.dtype == torch.float32
        assert torch.equal(ttr.pack_track_output(out), row)
        want = np.asarray(jtr.pack_track_output(jtr.TrackOutput(*(jnp.asarray(x.numpy()) for x in out))))
        np.testing.assert_array_equal(row.numpy(), want)
        back = ttr.unpack_track_output(row, banks=3)
        assert all(torch.equal(x, y) for x, y in zip(back, out))
    for a, b in zip(state_leaves(tr_a.state), state_leaves(tr_b.state)):
        assert torch.equal(a, b)


def test_banked_bboxes_matches_jax():
    """Tile a single box, pass per-target boxes through, refuse a count
    that is not runtime.banks — as the JAX package's banked_bboxes."""
    one = np.array([10, 20, 30, 40], np.float32)
    np.testing.assert_array_equal(tbk.banked_bboxes(one, 3), jbk.banked_bboxes(one, 3))
    assert tbk.banked_bboxes(one, 3).shape == (3, 4)
    many = np.arange(8, dtype=np.float32).reshape(2, 4)
    np.testing.assert_array_equal(tbk.banked_bboxes(many, 2), jbk.banked_bboxes(many, 2))
    for fn in (tbk.banked_bboxes, jbk.banked_bboxes):
        with pytest.raises(ValueError, match="runtime.banks"):
            fn(many, 3)


# --- port only: the JAX suite's banked behaviour, the port's own noise ------

def test_banked_tracks_distinct_targets():
    """Each bank locks onto its own target of synthetic:multi-3, with the
    port's own noise (mirrors
    tests/test_tracker_e2e.py:test_banked_tracks_distinct_targets: 256
    particles, 16 frames of 224x288, the same bounds). The JAX test's tiny
    random vit-t16 holds those bounds only with its own noise and its
    bf16-class CPU products (in f32 both packages lose target 2 on that
    clip, with the same draws); here the repo's trained ViT-B/16
    (checkpoints/vit_b16_tracking.npz) in f32."""
    d = {"model": {"variant": "vit-b16", "image_size": 224, "dtype": "float32", "use_flash_attention": False,
                   "checkpoint": "checkpoints/vit_b16_tracking.npz"},
         "filter": {"num_particles": 256, "motion": {"sigma_pos": 3.0}}, "tracker": {"mode": "dense"},
         "io": {"source": "synthetic:multi-3", "num_frames": 16, "frame_size": [224, 288]}}
    tr, steps, truth = _multi("banked", d, 3, 16)
    pos = tr.track_clip_device(torch.from_numpy(np.stack(steps))).position.numpy()  # [T, K, 2]
    err = np.linalg.norm(pos - truth, axis=-1)
    rmse = np.sqrt((err**2).mean(axis=0))
    assert (rmse < 15.0).all(), rmse
    final = pos[-1]
    d_own = np.linalg.norm(final - truth[-1], axis=-1)
    for i in range(3):
        d_other = np.linalg.norm(final[i] - np.delete(truth[-1], i, 0), axis=-1)
        assert d_own[i] < d_other.min(), (i, d_own[i], d_other)


def test_reinit_bank_retargets_without_touching_others():
    """reinit_bank(1, ...) mid-stream (mirrors
    tests/test_tracker_e2e.py:test_reinit_bank_retargets_without_touching_others):
    bank 0's records are bitwise those of a run without it, and bank 1 ends
    on target 1 (both banks start on target 0)."""
    d = _with(MULTI, io={"source": "synthetic:multi-2", "num_frames": 12, "frame_size": [224, 288]})
    cfg = TConfig.from_dict(_with(d, runtime={"banks": 2}))
    src = open_source("synthetic:multi-2", 12, (224, 288), seed=0)
    b0 = src.init_bbox[0]

    def run(reinit: bool):
        mt = tbk.MultiTracker(copy.deepcopy(cfg), device="cpu")
        mt.init(src.frames[0], np.stack([b0, b0]))
        recs = []
        for i, f in enumerate(src.frames[1:], start=1):
            if reinit and i == 6:
                c = src.truth[i - 1, 1]
                w, h = src.init_bbox[1, 2:]
                mt.reinit_bank(1, src.frames[i - 1], [c[0] - w / 2, c[1] - h / 2, w, h])
                assert mt._frame_idx.tolist() == [5, 0] and mt._seed.tolist() == [0, 1]
            recs.append(mt.step(f))
        return recs

    recs_a, recs_b = run(False), run(True)
    for ra, rb in zip(recs_a, recs_b):
        assert {k: v for k, v in ra[0].items() if k != "step_ms"} == {k: v for k, v in rb[0].items() if k != "step_ms"}
    final_b = np.asarray(recs_b[-1][1]["position"])
    t0, t1 = src.truth[-1]
    assert np.linalg.norm(final_b - t1) < 12.0, (final_b, t1)
    assert np.linalg.norm(final_b - t1) < np.linalg.norm(final_b - t0)
    assert set(recs_b[0][0]) == {"bank", "position", "box", "conf", "ess", "resampled", "lost", "step_ms"}
    mt = tbk.MultiTracker(copy.deepcopy(cfg), device="cpu")
    with pytest.raises(RuntimeError, match="init"):
        mt.reinit_bank(0, src.frames[0], b0)
    mt.init(src.frames[0], src.init_bbox)
    with pytest.raises(IndexError):
        mt.reinit_bank(2, src.frames[0], b0)


def test_multistream_equals_independent_trackers():
    """Stream k of a MultiStreamTracker == a single port Tracker with seed
    seed + k and the same weights on the same clip, within 1e-2 px with
    resampling off (mirrors
    tests/test_tracker_e2e.py:test_multistream_matches_independent_trackers)."""
    d = _with(BASE, filter={"num_particles": 64, "ess_threshold": 0.0})
    k = 3
    tr, steps, _ = _multi("streams", d, k)
    pos = tr.track_clips_device(torch.from_numpy(np.stack(steps))).position.numpy()  # [T, K, 2]
    srcs = [open_source(d["io"]["source"], FRAMES, tuple(d["io"]["frame_size"]), seed=i) for i in range(k)]
    for i in range(k):
        single = ttr.Tracker(TConfig.from_dict(_with(d, filter={"seed": i})), vit_params=tr.vit_params, device="cpu")
        got = [single_rec["position"] for single_rec in single.run(srcs[i])]
        np.testing.assert_allclose(pos[:, i], np.array(got), atol=1e-2)


def test_banked_track_cli_writes_k_records_a_frame(tmp_path):
    """The track command with runtime.banks 3 on synthetic:multi-3 writes
    one record a bank a frame with the JAX package's banked keys and the
    frame number; io.resume_state with banks > 1 raises, as in the JAX
    package."""
    out = tmp_path / "banked.jsonl"
    sets = ["runtime.banks=3", "io.source=synthetic:multi-3", "io.num_frames=4", "io.frame_size=[160,160]",
            "model.variant=vit-t16", "model.image_size=64", "model.dtype=float32", "model.checkpoint=",
            "filter.num_particles=64", f"io.output={out}"]
    argv = ["track", "--device", "cpu", "--quiet"] + [x for s in sets for x in ("--set", s)]
    assert tcli.main(argv) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(recs) == 3 * 3
    assert [(r["frame"], r["bank"]) for r in recs] == [(f, b) for f in (1, 2, 3) for b in range(3)]
    assert all(set(r) == {"bank", "position", "box", "conf", "ess", "resampled", "lost", "step_ms", "frame"}
               for r in recs)
    with pytest.raises(ValueError, match="banks"):
        tcli.main(argv + ["--set", f"io.resume_state={tmp_path / 'none.npz'}"])
