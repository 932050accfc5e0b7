"""Port parity: the device-side step API (vitparticlefiltertracker_tpu_torch/
runtime/tracker.py: Tracker.step_device, step_packed, track_clip_device,
_Fns.track_clip, pack_track_output) and the capturable step behind it.

On the CPU the Tracker runs the same step body that the card captures in a
CUDA graph, eagerly, with the same host-side bookkeeping (the noise key and
frame index); its two lost-only branches run where the predicates the step
computes hold, which the card's IF nodes decide without the host. So these
tests hold that bookkeeping and the predicates; the graph itself is held to
the eager step on the card (tests/test_torch_cuda.py, chip_smoke.py). The sequential-step comparisons require equality: both
sides run one body on the same inputs on the CPU. Parity with the JAX
package uses the tolerances of tests/test_torch_tracker_e2e.py:_compare.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_redetect import CASES as REDETECT_CASES
from test_torch_redetect import scans_and_accepts
from test_torch_tracker_e2e import BASE, _compare, _run_both

from vitparticlefiltertracker_tpu.config import Config as JConfig
from vitparticlefiltertracker_tpu.filters import particle as jpf
from vitparticlefiltertracker_tpu.models.params import resolve_vit_params
from vitparticlefiltertracker_tpu.runtime import tracker as jtr
from vitparticlefiltertracker_tpu_torch import bridge
from vitparticlefiltertracker_tpu_torch.config import Config as TConfig
from vitparticlefiltertracker_tpu_torch.filters import particle as tpf
from vitparticlefiltertracker_tpu_torch.io.video import open_source
from vitparticlefiltertracker_tpu_torch.models.vit import VitSpec
from vitparticlefiltertracker_tpu_torch.runtime import tracker as ttr
from vitparticlefiltertracker_tpu_torch.runtime.step_graph import run_if_always, state_leaves


def _crop(impl="window-pallas"):
    d = copy.deepcopy(BASE)
    d["tracker"] = {"mode": "crop", "crop_impl": impl}
    return d


# The configs the Tracker API is held on: dense, crop through K2's plain
# version, and the robust stack (head, automatic blend, re-detection with
# relative acceptance and re-lock) on the teleport clip, which has both gates.
CONFIGS = {
    "dense": BASE,
    "crop": _crop(),
    "robust": REDETECT_CASES["dense-head-auto-relock"],
    "crop-redetect": REDETECT_CASES["crop-window-pallas"],
}


def _tracker(name, **runtime):
    d = copy.deepcopy(CONFIGS[name])
    d["runtime"] = dict(runtime)
    cfg = TConfig.from_dict(d)
    src = open_source(cfg.io.source, cfg.io.num_frames, tuple(cfg.io.frame_size), seed=0)
    tr = ttr.Tracker(cfg, device="cpu")
    tr.init(src.frames[0], src.init_bbox)
    return tr, src


def _banked_tracker(name, kind, k=2):
    """A MultiTracker (k banks on the clip's one target) or a
    MultiStreamTracker (k copies of the clip) over CONFIGS[name], after init
    -> (tracker, the first step's frame)."""
    from vitparticlefiltertracker_tpu_torch.runtime import banked

    cfg = TConfig.from_dict({**copy.deepcopy(CONFIGS[name]), "runtime": {"banks": k}})
    src = open_source(cfg.io.source, cfg.io.num_frames, tuple(cfg.io.frame_size), seed=0)
    boxes = banked.banked_bboxes(src.init_bbox, k)
    if kind == "banked":
        tr = banked.MultiTracker(cfg, device="cpu")
        tr.init(src.frames[0], boxes)
        return tr, torch.from_numpy(src.frames[1])
    tr = banked.MultiStreamTracker(cfg, k, device="cpu")
    tr.init(np.stack([src.frames[0]] * k), boxes)
    return tr, torch.from_numpy(np.stack([src.frames[1]] * k))


def _rec_array(rec) -> np.ndarray:
    return np.array([*rec["position"], *rec["box"], *rec["velocity"], rec["conf"], rec["ess"],
                     rec["resampled"], rec["lost"]], np.float32)


@pytest.mark.parametrize("name", ["dense", "crop", "robust"])
def test_track_clip_device_matches_sequential_steps(name):
    """As tests/test_tracker_e2e.py:test_track_clip_matches_sequential_steps:
    one track_clip_device call over the clip == step() frame by frame, every
    field of every record and the final state equal."""
    tr_a, src = _tracker(name)
    seq = np.stack([_rec_array(tr_a.step(f)) for f in src.frames[1:]])
    tr_b, _ = _tracker(name)
    outs = tr_b.track_clip_device(torch.from_numpy(np.stack(src.frames[1:])))
    assert tuple(outs.position.shape) == (len(src.frames) - 1, 2) and outs.lost.dtype == torch.bool
    got = torch.cat([outs.position, outs.box, outs.velocity, outs.conf[:, None], outs.ess[:, None],
                     outs.resampled[:, None].float(), outs.lost[:, None].float()], dim=1).numpy()
    np.testing.assert_array_equal(got, seq)
    for a, b in zip(state_leaves(tr_a.state), state_leaves(tr_b.state)):
        assert torch.equal(a, b)
    if name == "robust":
        assert seq[:, 9].any() and not seq[:, 9].all()  # both branches of the lost gate ran


@pytest.mark.parametrize("name", ["dense", "crop", "robust"])
def test_step_packed_matches_step_device(name):
    """As the unchunked half of tests/test_stream_chunk.py:
    test_step_packed_matches_step_device: the row packed inside the step ==
    pack_track_output(step_device(...)), and both trackers advance the same
    way (every state leaf equal after the clip)."""
    tr_a, src = _tracker(name)
    tr_b, _ = _tracker(name)
    for f in src.frames[1:]:
        frame = torch.from_numpy(f)
        out = tr_a.step_device(frame)
        row = tr_b.step_packed(frame)
        assert tuple(row.shape) == (10,) and row.dtype == torch.float32
        assert torch.equal(ttr.pack_track_output(out), row)
        back = ttr.unpack_track_output(row)
        assert all(torch.equal(x, y) for x, y in zip(back, out))
    for a, b in zip(state_leaves(tr_a.state), state_leaves(tr_b.state)):
        assert torch.equal(a, b)
    assert tr_a._frame_idx == tr_b._frame_idx == len(src.frames) - 1


def test_pack_track_output_matches_jax():
    """The port's pack_track_output against the JAX package's on one
    numpy-made TrackOutput: the same 10 floats, in the same order."""
    rng = np.random.default_rng(0)
    fields = dict(position=rng.normal(size=2), box=rng.uniform(1, 50, 2), velocity=rng.normal(size=2),
                  conf=rng.uniform(), ess=rng.uniform(1, 256), resampled=np.bool_(True), lost=np.bool_(False))
    fields = {k: np.asarray(v, np.bool_ if k in ("resampled", "lost") else np.float32) for k, v in fields.items()}
    want = np.asarray(jtr.pack_track_output(jtr.TrackOutput(**{k: jnp.asarray(v) for k, v in fields.items()})))
    got = ttr.pack_track_output(ttr.TrackOutput(**{k: torch.from_numpy(np.array(v)) for k, v in fields.items()}))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (10,)
    np.testing.assert_array_equal(got.numpy(), want)
    back = ttr.unpack_track_output(got)
    for k, v in fields.items():
        np.testing.assert_array_equal(getattr(back, k).numpy(), v)


@pytest.mark.parametrize("arming", ["host", "every-step"])
@pytest.mark.parametrize("case", ["dense", "dense-head-auto-relock", "crop-window-pallas"])
def test_capturable_step_matches_jax(case, arming):
    """The step with its branches run by a given run_if, the JAX noise and
    reseed injected, against the JAX step frame by frame through the lost,
    scan and accepted frames: the same records, scans and accepted matches as
    JAX. "host": the card's IF-node rule, each body where the predicate the
    step computed holds; the predicates are JAX's lax.cond conditions (the
    probe on the previous state's lost flag, the scan on the trigger).
    "every-step": every body on every step, so most bodies run where their
    predicate is false and their gated effects must change nothing."""
    preds = []
    jouts, touts, jstates, tstates = _run_both(REDETECT_CASES[case], frames=12, host_branches=arming, preds=preds)
    _compare(jouts, touts)
    want, got = scans_and_accepts(jstates), scans_and_accepts(tstates)
    assert got == want and got[0] >= 1 and got[1] >= 1, (got, want)
    if arming == "host":
        probe = REDETECT_CASES[case]["tracker"].get("mode", "dense") == "dense"
        lost = [False] + [bool(js.lost) for js in jstates[:-1]]
        scans = [scans_and_accepts([js])[0] == 1 for js in jstates]
        assert [v for b, v in preds if b == "probe"] == (lost if probe else [])
        assert [v for b, v in preds if b == "scan"] == scans
    for js, ts in zip(jstates, tstates):
        assert int(ts.lost_count) == int(js.lost_count)
        np.testing.assert_allclose(ts.center.numpy(), np.asarray(js.center), atol=0.5)


def test_track_clip_fn_matches_jax():
    """_Fns.track_clip with the JAX draws injected against the JAX
    track_clip (lax.scan) on the same weights and clip."""
    cfg_dict = copy.deepcopy(BASE)
    jcfg, tcfg = JConfig.from_dict(copy.deepcopy(cfg_dict)), TConfig.from_dict(copy.deepcopy(cfg_dict))
    src = open_source(tcfg.io.source, 7, tuple(tcfg.io.frame_size), seed=0)
    clip, bbox = np.stack(src.frames), np.asarray(src.init_bbox, np.float32)
    n = jcfg.filter.num_particles
    jp = resolve_vit_params(jcfg)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), VitSpec.from_config(tcfg.model))
    jf, tf = jtr.build_tracker_fns(jcfg), ttr.build_tracker_fns(tcfg)
    key = jax.random.key(0)
    cloud = jpf.init_state(jax.random.fold_in(key, 0xFFFFFFFF), jnp.asarray(bbox[:2] + bbox[2:] / 2), n,
                           jtr._pf_params(jcfg))
    noises = [tpf.StepNoise(*(torch.from_numpy(np.array(x)) for x in
                              jpf.draw_step_noise(jax.random.fold_in(key, i), n))) for i in range(len(clip) - 1)]
    with jax.default_matmul_precision("highest"):
        jstate = jf.init(jp, jnp.asarray(clip[0]), jnp.asarray(bbox), jnp.int32(0))
        jstate, jouts = jax.jit(jf.track_clip)(jp, jstate, jnp.asarray(clip[1:]))
    tstate = tf.init(tp, torch.from_numpy(clip[0]), torch.from_numpy(bbox), 0,
                     cloud=torch.from_numpy(np.array(cloud.particles)))
    tstate, touts = tf.track_clip(tp, tstate, torch.from_numpy(clip[1:]), noises=noises)
    assert tuple(touts.position.shape) == (len(clip) - 1, 2)
    jrows = [jtr.TrackOutput(*(np.asarray(x)[i] for x in jouts)) for i in range(len(clip) - 1)]
    trows = [ttr.TrackOutput(*(x[i] for x in touts)) for i in range(len(clip) - 1)]
    _compare(jrows, trows)
    assert int(tstate.frame_idx) == int(jstate.frame_idx) == len(clip) - 1


# What the capturable step must never run: each is a host read of a tensor or
# a tensor made from host data (a copy the host waits on; not allowed while a
# CUDA graph is being captured). Indexing with a 0-d integer tensor is one
# too: torch reads the index back (`.item()` in C++, ATen/TensorIndexing.h).
_FORBIDDEN = [(torch, "tensor"), (torch, "as_tensor")] + [
    (torch.Tensor, m) for m in ("tolist", "item", "__bool__", "__int__", "__float__")]


def _reads_index_back(index) -> bool:
    items = index if isinstance(index, tuple) else (index,)
    return any(isinstance(i, torch.Tensor) and i.dim() == 0 and not i.is_floating_point() for i in items)


@pytest.mark.parametrize("name", ["dense", "crop", "robust", "crop-redetect", "banked:robust", "banked:crop",
                                  "streams:dense", "streams:crop-redetect"])
def test_capturable_step_reads_nothing_back(name, monkeypatch):
    """A capture-safety proxy on the CPU: with torch.tensor, torch.as_tensor
    and Tensor.tolist, .item, __bool__, __int__, __float__ and indexing by a
    0-d tensor counting, the
    Tracker's one step body, with a run_if that runs every branch body it is
    given (dense; crop through K2's plain version; the head with the
    automatic blend, the probe and the dense scan; the crop scan), computes
    both predicates and runs both bodies and calls none of them; so do the
    banked bodies of MultiTracker (2 banks on one frame) and
    MultiStreamTracker (2 streams, a frame each). One warm-up step runs
    first, as the card's capture warms up: constants built once per device
    or frame size are made there."""
    kind, _, config = name.rpartition(":")
    if kind:
        tr, frame = _banked_tracker(config, kind)
    else:
        tr, src = _tracker(config)
        frame = torch.from_numpy(src.frames[1])
    n = tr.cfg.filter.num_particles
    seeds, idx = tr._seed.tolist(), tr._frame_idx.tolist()
    noise = tpf.draw_step_noise(seeds, idx, n, tr.device)
    reseed = tpf.draw_reseed_noise(seeds, idx, n, tr.device)
    tr._body(tr.state, frame, noise, reseed, run_if_always)  # warm-up
    branches = []

    def run_if(pred, body):
        assert pred.dtype == torch.bool and pred.dim() == 0
        branches.append(body.__name__)
        body()

    calls = []
    for owner, attr in _FORBIDDEN:
        orig = getattr(owner, attr)

        def counting(*a, _orig=orig, _name=attr, **k):
            calls.append(_name)
            return _orig(*a, **k)

        monkeypatch.setattr(owner, attr, counting)
    getitem = torch.Tensor.__getitem__

    def indexing(self, index):
        if _reads_index_back(index):
            calls.append("__getitem__ with a 0-d tensor index")
        return getitem(self, index)

    monkeypatch.setattr(torch.Tensor, "__getitem__", indexing)
    row = tr._body(tr.state, frame, noise, reseed, run_if)[1]
    monkeypatch.undo()
    assert calls == [], calls
    assert tuple(row.shape) == (10 * tr._k,) and bool(torch.isfinite(row).all())
    probe, scan = ttr.step_branches(tr.cfg)
    assert branches == ["probe"] * probe + ["scan"] * (scan > 0)
    if config in ("robust", "crop-redetect"):
        assert "scan" in branches


@pytest.mark.parametrize("cut, branch", [(1, (False, False)), (2, (True, True)), (3, (True, False))],
                         ids=["locked", "armed-probe", "probe"])
def test_resume_continues_device_api_bitwise(tmp_path, cut, branch):
    """A state saved mid-run (after `cut` steps of the tiny teleport clip:
    locked; lost with a trigger possible on the next step; lost after an
    accepted match) and resumed in a new Tracker continues step_packed
    bitwise: the host's frame counter and seed are restored from the file,
    and the lost flag and count, which the next step's branch predicates
    read, with the state."""
    tr_a, src = _tracker("robust")
    frames = [torch.from_numpy(f) for f in src.frames[1:]]
    for f in frames[:cut]:
        tr_a.step_packed(f)
    path = str(tmp_path / "s.npz")
    tr_a.save(path)
    n_after = tr_a.cfg.tracker.redetect_global_after

    def flags(tr):
        return bool(tr.state.lost), int(tr.state.lost_count) >= n_after - 1

    host = (tr_a._frame_idx, tr_a._seed)
    saved = (bool(tr_a.state.lost), int(tr_a.state.lost_count))
    assert flags(tr_a) == branch
    want = torch.stack([tr_a.step_packed(f) for f in frames[cut:]])
    cfg = TConfig.from_dict(copy.deepcopy(CONFIGS["robust"]))
    tr_b = ttr.Tracker(cfg, device="cpu")
    tr_b.resume(path)
    assert (tr_b._frame_idx, tr_b._seed) == host and host[0] == cut
    assert (bool(tr_b.state.lost), int(tr_b.state.lost_count)) == saved and flags(tr_b) == branch
    got = torch.stack([tr_b.step_packed(f) for f in frames[cut:]])
    assert torch.equal(got, want)


@pytest.mark.parametrize("donate", [False, True])
def test_donate_state_false_keeps_previous_state(donate):
    """runtime.donate_state false: a state returned before a step is left as
    it was by the step (the JAX package keeps the previous buffers alive).
    On the CPU the step makes new tensors either way."""
    tr, src = _tracker("dense", donate_state=donate)
    before = tr.state
    kept = [x.clone() for x in state_leaves(before)]
    tr.step_device(torch.from_numpy(src.frames[1]))
    assert all(torch.equal(a, b) for a, b in zip(state_leaves(before), kept))
    assert not torch.equal(tr.state.pf.particles, before.pf.particles)
    assert not tr.graphs  # the CPU runs the step eagerly
