"""ROI streaming in the port (vitparticlefiltertracker_tpu_torch): the step
through a StreamFrame, the chunk of C steps, RoiShipper and stream_track
with ROI shipping, chunking, adaptive sizing and native sources, on the CPU.

Parity with the JAX package: the same StreamFrames (made with numpy from the
same clip) go through both packages' steps with the JAX package's random
weights bridged into the port and its noise injected, as
tests/test_torch_tracker_e2e.py runs whole frames (position within 0.5 px,
`lost` and `resampled` exact, `conf` 1e-3). RoiShipper's arithmetic
(origins, clamps, the fractional stride) is held equal to the JAX
package's. The stream_track tests mirror tests/test_streaming_roi.py and
tests/test_stream_chunk.py on the port alone (its own noise), with their
bounds.
"""

import copy
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_redetect import scans_and_accepts
from test_torch_tracker_e2e import BASE, _compare

from vitparticlefiltertracker_tpu.config import Config as JConfig
from vitparticlefiltertracker_tpu.filters import particle as jpf
from vitparticlefiltertracker_tpu.io.video import open_source as j_open_source
from vitparticlefiltertracker_tpu.models.params import resolve_vit_params
from vitparticlefiltertracker_tpu.ops import image as jimage
from vitparticlefiltertracker_tpu.runtime import streaming as jstreaming
from vitparticlefiltertracker_tpu.runtime import tracker as jtr
from vitparticlefiltertracker_tpu_torch import bridge
from vitparticlefiltertracker_tpu_torch.config import Config as TConfig
from vitparticlefiltertracker_tpu_torch.filters import particle as tpf
from vitparticlefiltertracker_tpu_torch.io import native as tnative
from vitparticlefiltertracker_tpu_torch.io.synthetic import teleport_times
from vitparticlefiltertracker_tpu_torch.io.video import open_source
from vitparticlefiltertracker_tpu_torch.models.vit import VitSpec
from vitparticlefiltertracker_tpu_torch.ops.image import FrameView, StreamFrame
from vitparticlefiltertracker_tpu_torch.runtime import tracker as ttr
from vitparticlefiltertracker_tpu_torch.runtime.streaming import RoiShipper, stream_track
from vitparticlefiltertracker_tpu_torch.runtime.tracker import Tracker, build_tracker_fns

N_AFTER = 2


def _teleport(mode="dense", impl="window"):
    """The tiny ViT of test_torch_tracker_e2e on 12 frames of 190x190
    synthetic:teleport (hidden from frame 4, back at 8), a relative lost gate
    that fires and a scan after 2 lost frames. 190 is no multiple of the
    global views' strides (4, 3): the scan grid, the reseed spread and the
    coast clamp take the frame's size from the global view, 192 px."""
    d = copy.deepcopy(BASE)
    d["io"] = {"source": "synthetic:teleport", "num_frames": 12, "frame_size": [190, 190]}
    d["filter"]["lost_conf_ratio"] = 0.9
    d["tracker"] = {"mode": mode, "crop_impl": impl, "redetect_global_after": N_AFTER,
                    "redetect_global_grid": 5, "redetect_accept_conf": 0.3}
    return d


def _views(frame, center, roi, stride, glob, glob_stride):
    """One frame's (tracking view, global view) as numpy pixels and origins:
    a strided crop of `roi` px around `center`, clamped to the frame, and
    the given decimated whole frame."""
    h, w = frame.shape[:2]
    ox = int(np.clip(round(center[0] - roi / 2), 0, w - roi))
    oy = int(np.clip(round(center[1] - roi / 2), 0, h - roi))
    track = (np.ascontiguousarray(frame[oy:oy + roi:stride, ox:ox + roi:stride]), np.float32([ox, oy]), float(stride))
    return track, (glob, np.zeros(2, np.float32), float(glob_stride))


def _stream_inputs(clip, truth, roi, stride, glob_stride, glob_every=2):
    """A StreamFrame's numpy parts for every frame after the first: the ROI
    around the true centre, the global view refreshed every `glob_every`
    frames and reused in between (as RoiShipper ships them)."""
    out, glob = [], None
    for i in range(1, len(clip)):
        if glob is None or i % glob_every == 0:
            glob = np.ascontiguousarray(clip[i][::glob_stride, ::glob_stride])
        out.append(_views(clip[i], truth[i], roi, stride, glob, glob_stride))
    return out


def _j_stream_frame(track, glob):
    view = lambda p: jimage.FrameView(jnp.asarray(p[0]), jnp.asarray(p[1]), p[2])  # noqa: E731
    return jimage.StreamFrame(track=view(track), glob=view(glob))


def _t_stream_frame(track, glob):
    view = lambda p: FrameView(torch.from_numpy(p[0]), torch.from_numpy(p[1]), p[2])  # noqa: E731
    return StreamFrame(track=view(track), glob=view(glob))


def _setup(cfg_dict, frames):
    """Both packages' configs, weights, functions and first states, the clip
    and the JAX noise key."""
    jcfg, tcfg = JConfig.from_dict(copy.deepcopy(cfg_dict)), TConfig.from_dict(copy.deepcopy(cfg_dict))
    size = tuple(jcfg.io.frame_size)
    src = j_open_source(jcfg.io.source, frames, size, seed=0)
    clip, bbox = src.frames, np.asarray(src.init_bbox, np.float32)
    n = jcfg.filter.num_particles
    jp = resolve_vit_params(jcfg)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), VitSpec.from_config(tcfg.model))
    jf, tf = jtr.build_tracker_fns(jcfg), ttr.build_tracker_fns(tcfg)
    key = jax.random.key(0)
    cloud = jpf.init_state(jax.random.fold_in(key, 0xFFFFFFFF), jnp.asarray(bbox[:2] + bbox[2:] / 2), n,
                           jtr._pf_params(jcfg))
    with jax.default_matmul_precision("highest"):
        jstate = jax.jit(jf.init)(jp, jnp.asarray(clip[0]), jnp.asarray(bbox), jnp.int32(0))
    tstate = tf.init(tp, torch.from_numpy(clip[0]), torch.from_numpy(bbox), 0,
                     cloud=torch.from_numpy(np.array(cloud.particles)))
    return dict(jp=jp, tp=tp, jf=jf, tf=tf, jstate=jstate, tstate=tstate, clip=clip, truth=src.truth, key=key, n=n)


def _noise(key, i, n):
    """The JAX step's draws at frame index i - 1, as the port's StepNoise and reseed."""
    fkey = jax.random.fold_in(key, i - 1)
    noise = tpf.StepNoise(*(torch.from_numpy(np.array(x)) for x in jpf.draw_step_noise(fkey, n)))
    reseed = torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(fkey, 0x5EED1), (n, 2), jnp.float32)))
    return noise, reseed


def _run_both_stream(cfg_dict, frames, roi, stride, glob_stride):
    """Both packages' steps over StreamFrames of the config's clip -> (JAX
    outputs, port outputs, JAX states, port states), one a step."""
    s = _setup(cfg_dict, frames)
    inputs = _stream_inputs(s["clip"], s["truth"], roi, stride, glob_stride)
    jstate, tstate = s["jstate"], s["tstate"]
    jstep = jax.jit(s["jf"].step)
    jouts, touts, jstates, tstates = [], [], [], []
    with jax.default_matmul_precision("highest"):
        for i, (track, glob) in enumerate(inputs, start=1):
            noise, reseed = _noise(s["key"], i, s["n"])
            jstate, jo = jstep(s["jp"], jstate, _j_stream_frame(track, glob))
            tstate, to = s["tf"].step(s["tp"], tstate, _t_stream_frame(track, glob), noise=noise, reseed=reseed)
            jouts.append(jax.tree.map(np.asarray, jo))
            touts.append(to)
            jstates.append(jstate)
            tstates.append(tstate)
    return jouts, touts, jstates, tstates


STREAM_CASES = {
    # (config, ROI px, tracking view's stride, global view's stride)
    "dense": (_teleport(), 128, 1, 4),
    "dense-decimated": (_teleport(), 128, 2, 3),
    "crop-window-pallas": (_teleport("crop", "window-pallas"), 128, 1, 4),
    "crop-window-pallas-decimated": (_teleport("crop", "window-pallas"), 128, 2, 3),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_stream_frame_step_matches_jax(case):
    """The port's step on a StreamFrame equals the JAX package's on the same
    StreamFrame, every step, through at least one scan of the global view
    and one accepted match."""
    cfg, roi, stride, glob_stride = STREAM_CASES[case]
    jouts, touts, jstates, tstates = _run_both_stream(cfg, 12, roi, stride, glob_stride)
    _compare(jouts, touts)
    want, got = scans_and_accepts(jstates), scans_and_accepts(tstates)
    assert got == want and got[0] >= 1 and got[1] >= 1, (got, want)
    for js, ts in zip(jstates, tstates):
        assert int(ts.lost_count) == int(js.lost_count)
        np.testing.assert_allclose(ts.center.numpy(), np.asarray(js.center), atol=0.5)


def test_frame_dims_follow_the_global_view():
    """The frame's size as the global view implies it: over by up to a
    stride for a view that does not divide the frame (the JAX formula)."""
    for h, w, gs in ((190, 190, 4), (190, 253, 3), (2160, 3840, 8)):
        pix = np.zeros((h, w, 3), np.uint8)[::gs, ::gs]
        want = jtr._frame_dims(jimage.FrameView(jnp.asarray(pix), jnp.zeros(2), float(gs)))
        got = ttr._frame_dims(FrameView(torch.from_numpy(np.ascontiguousarray(pix)), torch.zeros(2), float(gs)))
        assert got == want == (-(-h // gs) * gs, -(-w // gs) * gs)


# ---------------------------------------------------------------------------
# The port's ROI step against its own full-frame step
# ---------------------------------------------------------------------------

def _cfg(particles=256, **over):
    """tests/test_streaming_roi.py's and tests/test_stream_chunk.py's config."""
    d = {"model": {"variant": "vit-t16", "image_size": 128, "dtype": "float32", "use_flash_attention": False},
         "filter": {"num_particles": particles, "motion": {"sigma_pos": 3.0}},
         "tracker": {"mode": "dense"}}
    for k, v in over.items():
        d.setdefault(k, {}).update(v)
    return TConfig.from_dict(d)


def test_stream_frame_step_matches_full_frame():
    """As tests/test_streaming_roi.py:test_stream_frame_step_matches_full_frame:
    the step on a StreamFrame whose ROI covers the search window follows the
    full-frame trajectory within 1 px."""
    cfg = _cfg()
    src = open_source("synthetic:moving-square", 12, (320, 320), seed=0)
    frames = src.frames
    tr_full, tr_roi = Tracker(cfg, device="cpu"), Tracker(cfg, device="cpu")
    tr_full.init(frames[0], src.init_bbox)
    tr_roi.init(frames[0], src.init_bbox)
    for f in frames[1:]:
        ref = tr_full.step(f)
        track, glob = _views(f, ref["position"], 256, 1, np.ascontiguousarray(f[::4, ::4]), 4)
        got = tr_roi.step_device(_t_stream_frame(track, glob)).position.numpy()
        np.testing.assert_allclose(got, ref["position"], atol=1.0)


# ---------------------------------------------------------------------------
# track_chunk_fn and the Tracker's chunk steps
# ---------------------------------------------------------------------------

def _chunk(views) -> StreamFrame:
    """The StreamFrames of `views` (one global view) stacked into one chunk."""
    sfs = [_t_stream_frame(*v) for v in views]
    return StreamFrame(FrameView(torch.stack([s.track.pixels for s in sfs]),
                                 torch.stack([s.track.origin for s in sfs]), sfs[0].track.stride), sfs[0].glob)


@pytest.mark.parametrize("cfg_dict", [_teleport(), _teleport("crop", "window-pallas")], ids=["dense", "crop"])
def test_track_chunk_matches_steps_and_jax(cfg_dict):
    """track_chunk over 4 StreamFrames (one global view) equals 4 sequential
    steps of the port bitwise, and the JAX package's track_chunk at
    tests/test_stream_chunk.py's tolerances (position 1e-3 px, ess 0.1,
    the flags exact, particles 1e-2), the JAX noise injected."""
    s = _setup(cfg_dict, 6)
    views = _stream_inputs(s["clip"], s["truth"], 128, 1, 4, glob_every=100)[:4]
    draws = [_noise(s["key"], i, s["n"]) for i in range(1, 5)]
    st = s["tstate"]
    seq = []
    for v, (noise, reseed) in zip(views, draws):
        st, out = s["tf"].step(s["tp"], st, _t_stream_frame(*v), noise=noise, reseed=reseed)
        seq.append(out)
    st_c, outs_c = s["tf"].track_chunk(s["tp"], s["tstate"], _chunk(views), [d[0] for d in draws],
                                       torch.stack([d[1] for d in draws]))
    for i, out in enumerate(seq):
        for a, b in zip(out, outs_c):
            assert torch.equal(a, b[i])
    for a, b in zip(jax.tree.leaves(st), jax.tree.leaves(st_c)):
        assert torch.equal(a, b)
    jchunk = jimage.StreamFrame(
        track=jimage.FrameView(jnp.stack([jnp.asarray(v[0][0]) for v in views]),
                               jnp.stack([jnp.asarray(v[0][1]) for v in views]), 1.0),
        glob=jimage.FrameView(jnp.asarray(views[0][1][0]), jnp.zeros(2, jnp.float32), 4.0))
    with jax.default_matmul_precision("highest"):
        jst, jouts = jax.jit(s["jf"].track_chunk)(s["jp"], s["jstate"], jchunk)
    np.testing.assert_array_equal(int(st_c.frame_idx), int(jst.frame_idx))
    np.testing.assert_allclose(outs_c.position.numpy(), np.asarray(jouts.position), atol=1e-3, rtol=1e-6)
    np.testing.assert_allclose(outs_c.ess.numpy(), np.asarray(jouts.ess), atol=0.1)
    np.testing.assert_array_equal(outs_c.resampled.numpy(), np.asarray(jouts.resampled))
    np.testing.assert_array_equal(outs_c.lost.numpy(), np.asarray(jouts.lost))
    np.testing.assert_allclose(st_c.pf.particles.numpy(), np.asarray(jst.pf.particles), atol=1e-2, rtol=1e-4)


def test_step_chunk_packed_matches_step_packed():
    """As tests/test_stream_chunk.py:test_step_packed_matches_step_device:
    Tracker.step_chunk_packed's [C, 10] rows equal C step_packed rows on the
    single StreamFrames (the same draws, keyed on the frame index), and
    step_chunk_device unpacks them; the states stay in lockstep."""
    cfg = _cfg()
    src = open_source("synthetic:moving-square", 12, (240, 320), seed=1)
    views = _stream_inputs(src.frames, src.truth, 144, 1, 4, glob_every=100)
    tr_a, tr_b = Tracker(cfg, device="cpu"), Tracker(cfg, device="cpu")
    tr_a.init(src.frames[0], src.init_bbox)
    tr_b.init(src.frames[0], src.init_bbox)
    row0 = tr_a.step_packed(_t_stream_frame(*views[0]))
    out0 = tr_b.step_device(_t_stream_frame(*views[0]))
    assert torch.equal(row0, ttr.pack_track_output(out0))
    rows_a = torch.stack([tr_a.step_packed(_t_stream_frame(*v)) for v in views[1:5]])
    rows_b = tr_b.step_chunk_packed(_chunk(views[1:5]))
    assert rows_b.shape == (4, 10) and torch.equal(rows_a, rows_b)
    outs = tr_b.step_chunk_device(_chunk(views[5:9]))
    rows_a = torch.stack([tr_a.step_packed(_t_stream_frame(*v)) for v in views[5:9]])
    assert torch.equal(rows_a[:, :2], outs.position) and outs.lost.dtype == torch.bool
    assert int(tr_a._frame_idx) == int(tr_b._frame_idx) == 9
    assert torch.equal(tr_a.state.pf.particles, tr_b.state.pf.particles)


def test_glob_view_copied_only_when_refreshed(monkeypatch):
    """The tracker copies a StreamFrame's global view into its own buffer
    only when it is not the tensor the last step read: a view reused
    between refreshes is not copied again."""
    cfg = _cfg()
    src = open_source("synthetic:moving-square", 8, (240, 320), seed=1)
    views = _stream_inputs(src.frames, src.truth, 144, 1, 4, glob_every=3)
    tr = Tracker(cfg, device="cpu")
    tr.init(src.frames[0], src.init_bbox)
    globs = {}
    sfs = []
    for track, glob in views:  # one tensor a refresh, as RoiShipper ships them
        g = globs.setdefault(id(glob[0]), FrameView(torch.from_numpy(glob[0]), torch.zeros(2), glob[2]))
        sfs.append(StreamFrame(_t_stream_frame(track, glob).track, g))
    copies = []
    orig = tr._glob_view

    def counting(glob):
        before = [e[2] for e in tr._globs.values()]
        view = orig(glob)
        copies.append(any(e[2] is glob.pixels and all(b is not glob.pixels for b in before)
                          for e in tr._globs.values()))
        return view

    monkeypatch.setattr(tr, "_glob_view", counting)
    for sf in sfs:
        tr.step_packed(sf)
    assert sum(copies) == len(globs) == 3 and copies[0]


# ---------------------------------------------------------------------------
# RoiShipper against the JAX package's
# ---------------------------------------------------------------------------

OBSERVATIONS = [  # (record, the frame index to ship next)
    ({"frame": 1, "position": [40.0, 60.0], "velocity": [3.0, -1.0], "lost": False}, 2),
    ({"frame": 3, "position": [300.0, 10.0], "velocity": [6.5, -2.25], "lost": True}, 5),
    ({"frame": 2, "position": [0.0, 0.0], "lost": False}, 6),  # stale: ignored
    ({"frame": 6, "position": [5.0, 230.0], "velocity": [-4.0, 9.0], "lost": False}, 9),
]


def _as_np(view):
    return np.asarray(view.pixels), np.asarray(view.origin), view.stride


def _same(got, want):
    for view in ("track", "glob"):
        g, w = _as_np(getattr(got, view)), _as_np(getattr(want, view))
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1].astype(np.float32), w[1].astype(np.float32))
        assert g[2] == w[2], view


@pytest.mark.parametrize("roi, stride", [(96, 1), (100, 3), (400, 2)])
def test_roi_shipper_matches_jax(roi, stride):
    """ship and ship_chunk on numpy frames, after the same observations:
    the same crops, origins, strides and global views as the JAX
    RoiShipper's, and the same lost_seen, observed_idx and bytes a frame."""
    src = open_source("synthetic:moving-square", 12, (240, 320), seed=2)
    frames = src.frames
    args = ((240, 320), roi, (160.0, 120.0))
    kw = dict(roi_stride=stride, glob_stride=3, glob_every=4)
    ours, ref = RoiShipper(*args, **kw), jstreaming.RoiShipper(*args, **kw)
    assert ours.shipped_bytes_per_frame == ref.shipped_bytes_per_frame
    _same(ours.ship(frames[1], 1), ref.ship(frames[1], 1))
    for rec, idx in OBSERVATIONS:
        ours.observe(rec)
        ref.observe(rec)
        assert (ours.lost_seen, ours.observed_idx) == (ref.lost_seen, ref.observed_idx)
        _same(ours.ship(frames[idx], idx), ref.ship(frames[idx], idx))
        idxs = [idx, idx + 1, idx + 2]
        _same(ours.ship_chunk([frames[i] for i in idxs], idxs), ref.ship_chunk([frames[i] for i in idxs], idxs))


@pytest.mark.parametrize("roi_out", [0, 72])
def test_roi_shipper_native_matches_jax(roi_out):
    """ship_native and ship_native_chunk on a native source, after the same
    observations: the JAX RoiShipper's rectangles or resampled views, their
    origins and fractional strides, bit for bit."""
    from vitparticlefiltertracker_tpu.io import native as jnative

    assert tnative.available() and jnative.available()
    src, jsrc = tnative.NativeSyntheticSource(14, 240, 320, seed=4), jnative.NativeSyntheticSource(14, 240, 320, seed=4)
    args = ((240, 320), 150, (100.0, 90.0))
    kw = dict(roi_stride=2, glob_stride=8, glob_every=3, roi_out=roi_out)
    ours, ref = RoiShipper(*args, **kw), jstreaming.RoiShipper(*args, **kw)
    assert ours.shipped_bytes_per_frame == ref.shipped_bytes_per_frame
    _same(ours.ship_native(src, 1), ref.ship_native(jsrc, 1))
    for rec, idx in OBSERVATIONS:
        ours.observe(rec)
        ref.observe(rec)
        _same(ours.ship_native(src, idx), ref.ship_native(jsrc, idx))
        _same(ours.ship_native_chunk(src, [idx, idx + 1, idx + 2]),
              ref.ship_native_chunk(jsrc, [idx, idx + 1, idx + 2]))
    src.close()
    jsrc.close()


def test_roi_shipper_edge_clamp():
    """As tests/test_streaming_roi.py:test_roi_shipper_edge_clamp."""
    ship = RoiShipper((100, 160), 64, (2.0, 95.0))
    frame = np.arange(100 * 160 * 3, dtype=np.uint8).reshape(100, 160, 3)
    sf = ship.ship(frame)
    assert tuple(sf.track.pixels.shape) == (64, 64, 3)
    assert sf.track.origin.tolist() == [0.0, 36.0]
    np.testing.assert_array_equal(sf.track.pixels.numpy(), frame[36:100, 0:64])


def test_roi_shipper_lost_seen():
    """As tests/test_stream_chunk.py:test_roi_shipper_lost_seen."""
    ship = RoiShipper((240, 320), 160, (160.0, 120.0))
    assert not ship.lost_seen
    ship.observe({"frame": 3, "position": [10.0, 10.0], "lost": True})
    assert ship.lost_seen
    ship.observe({"frame": 2, "position": [0.0, 0.0], "lost": False})  # stale
    assert ship.lost_seen
    ship.observe({"frame": 4, "position": [11.0, 10.0], "lost": False})
    assert not ship.lost_seen


# ---------------------------------------------------------------------------
# stream_track with ROI shipping (the port alone, its own noise)
# ---------------------------------------------------------------------------

def _rmse(recs, truth, offset=0):
    errs = [np.hypot(*(np.asarray(r["position"]) - truth[r["frame"] + offset])) for r in recs]
    return float(np.sqrt(np.mean(np.square(errs))))


def test_stream_track_roi_e2e():
    """As tests/test_streaming_roi.py:test_stream_track_roi_e2e."""
    src = open_source("synthetic:moving-square", 24, (320, 320), seed=0)
    recs = []
    stats = stream_track(Tracker(_cfg(), device="cpu"), src, src.init_bbox, on_record=recs.append, roi_px=224,
                         glob_stride=4, glob_every=4)
    assert stats["frames"] == 23 and [r["frame"] for r in recs] == list(range(1, 24))
    assert _rmse(recs, src.truth) < 10.0
    assert stats["shipped_bytes_per_frame"] == RoiShipper((320, 320), 224, (0, 0), glob_stride=4).shipped_bytes_per_frame
    assert stats["shipped_bytes_per_frame"] < 0.6 * 320 * 320 * 3


def _teleport_cfg():
    return _cfg(model={"image_size": 64}, filter={"lost_conf_threshold": 0.6},
                tracker={"redetect_global_after": 3, "redetect_accept_conf": 0.3, "redetect_global_grid": 5})


@pytest.mark.parametrize("chunk", [1, 2], ids=["one-frame", "chunk-2"])
def test_roi_glob_redetect_recovers_teleport(chunk):
    """As tests/test_streaming_roi.py:test_roi_glob_redetect_recovers_teleport
    (chunk 1) and :test_roi_chunked_redetect_recovers_teleport (chunk 2): a
    target that reappears outside the shipped ROI is found again through the
    global view's scan."""
    n = 40
    src = open_source("synthetic:teleport", n, (192, 192))
    recs = []
    stream_track(Tracker(_teleport_cfg(), device="cpu"), src, src.init_bbox, on_record=recs.append, roi_px=128,
                 glob_stride=2, glob_every=2, readback_window=2 if chunk == 1 else 4, chunk=chunk,
                 **({} if chunk == 1 else {"steer_lag": 8}))
    assert [r["frame"] for r in recs] == list(range(1, n))
    _, t_show = teleport_times(n)
    late = [np.hypot(*(np.asarray(r["position"]) - src.truth[r["frame"]])) for r in recs if r["frame"] >= t_show + 6]
    assert np.mean(late) < 20.0, late


def test_stream_track_native_roi_fast_path():
    """As tests/test_streaming_roi.py:test_stream_track_native_roi_fast_path:
    with a native source the whole frame is read once (init), then only
    rectangles."""
    n = 20
    src = tnative.NativeSyntheticSource(n, 320, 320, seed=0)
    reads = {"full": 0, "rect": 0}
    orig_read, orig_rect = src.read, src.read_rect

    def counting_read(idx):
        reads["full"] += 1
        return orig_read(idx)

    def counting_rect(*a, **k):
        reads["rect"] += 1
        return orig_rect(*a, **k)

    src.read, src.read_rect = counting_read, counting_rect
    recs = []
    stats = stream_track(Tracker(_cfg(), device="cpu"), src, src.init_bbox, on_record=recs.append, roi_px=224,
                         glob_stride=4, glob_every=4)
    assert stats["frames"] == n - 1 and reads["full"] == 1 and reads["rect"] >= n - 1
    assert _rmse(recs, src.truth) < 12.0
    src.close()


def test_stream_track_native_roi_out_chunked():
    """eval5's form at a tiny size: a native source, the ROI as a resampled
    view (roi_out) at a fractional stride, chunk 4 with a one-frame tail:
    every frame recorded once, in order, on target."""
    n = 23
    src = tnative.NativeSyntheticSource(n, 240, 320, seed=0)
    recs = []
    stats = stream_track(Tracker(_cfg(), device="cpu"), src, src.init_bbox, on_record=recs.append, roi_px=200,
                         roi_out=144, glob_stride=8, glob_every=4, chunk=4, steer_lag=8, readback_window=8)
    assert stats["frames"] == n - 1 and stats["dispatches"] == {4: 5, 1: 2}
    assert [r["frame"] for r in recs] == list(range(1, n))
    assert stats["shipped_bytes_per_frame"] == 144 ** 2 * 3 + 30 * 40 * 3 / 4
    assert _rmse(recs, src.truth) < 12.0
    src.close()


def test_roi_stream_occlusion_recovers():
    """As tests/test_streaming_roi.py:test_roi_stream_occlusion_recovers:
    the chunked ROI stream rides through an occlusion sweep and is back on
    target at the end."""
    n = 48
    cfg = _cfg(filter={"lost_conf_ratio": 0.5, "likelihood_zscale": 6.0},
               tracker={"redetect_global_after": 6, "redetect_global_grid": 5, "redetect_accept_z": 3.0})
    src = open_source("synthetic:occlusion", n, (192, 192))
    recs = []
    stream_track(Tracker(cfg, device="cpu"), src, src.init_bbox, on_record=recs.append, roi_px=160, glob_stride=2,
                 glob_every=2, readback_window=4, chunk=2, steer_lag=8)
    final = [np.hypot(*(np.asarray(r["position"]) - src.truth[r["frame"]])) for r in recs if r["frame"] >= n - 6]
    assert np.mean(final) < 15.0, final


def test_stream_track_chunked_e2e():
    """As tests/test_stream_chunk.py:test_stream_track_chunked_e2e: 5 chunks
    of 4 and a 2-frame tail through the one-frame step, records complete and
    in order, on target."""
    src = open_source("synthetic:moving-square", 24, (240, 320), seed=0)
    arr = np.stack(src.frames)
    recs = []
    stats = stream_track(Tracker(_cfg(), device="cpu"), iter(arr[1:]), src.init_bbox, on_record=recs.append,
                         roi_px=160, glob_stride=4, glob_every=4, steer_lag=8, chunk=4, readback_window=8)
    assert stats["frames"] == 22 and stats["dispatches"] == {4: 5, 1: 2}
    assert [r["frame"] for r in recs] == list(range(1, 23))
    assert _rmse(recs, src.truth[2:], offset=-1) < 12.0


def test_stream_track_chunk_requires_roi():
    """As tests/test_stream_chunk.py:test_stream_track_chunk_requires_roi."""
    with pytest.raises(ValueError, match="chunk"):
        stream_track(Tracker(_cfg(), device="cpu"), iter([np.zeros((240, 320, 3), np.uint8)]), [100, 100, 40, 40],
                     chunk=4)


def test_stream_track_adaptive_chunk_switches_and_tracks():
    """As tests/test_stream_chunk.py:test_stream_track_adaptive_chunk_switches_and_tracks:
    an unreachable fps_target moves the dispatch size from 2 to 4 in the
    stream; every frame is recorded once, in order, on target. The rate is
    taken over at least 0.5 s, so the source gives a frame every 20 ms: the
    stream lasts long enough to switch however fast the host steps."""
    src = open_source("synthetic:moving-square", 44, (240, 320), seed=0)
    arr = np.stack(src.frames)

    def paced():
        for frame in arr[1:]:
            time.sleep(0.02)
            yield frame

    recs = []
    stats = stream_track(Tracker(_cfg(), device="cpu"), paced(), src.init_bbox, on_record=recs.append,
                         roi_px=160, glob_stride=4, glob_every=4, steer_lag=8, chunk=2, chunk_max=4, fps_target=1e9,
                         readback_window=8)
    assert stats["frames"] == 42 and stats["dispatches"].get(4, 0) >= 1
    assert [r["frame"] for r in recs] == list(range(1, 43))
    assert _rmse(recs, src.truth[2:], offset=-1) < 12.0


def test_stream_track_roi_refusals():
    """JAX's refusals: ROI streaming of banks, a resampled view (roi_out)
    without a native source."""
    src = open_source("synthetic:moving-square", 3, (96, 96))
    with pytest.raises(ValueError, match="single tracker"):
        stream_track(Tracker(_cfg(), device="cpu"), src, np.stack([src.init_bbox] * 2), roi_px=64)
    with pytest.raises(ValueError, match="native source"):
        stream_track(Tracker(_cfg(), device="cpu"), src, src.init_bbox, roi_px=64, roi_out=32)


def test_chunk_fns_shape_and_steps():
    """build_tracker_fns gives track_chunk; a chunk of 3 advances the frame
    index by 3 and gives outputs with a leading 3."""
    cfg = _cfg()
    fns = build_tracker_fns(cfg.resolve())
    tr = Tracker(cfg, device="cpu")
    src = open_source("synthetic:moving-square", 4, (240, 320), seed=0)
    tr.init(src.frames[0], src.init_bbox)
    views = _stream_inputs(src.frames, src.truth, 144, 1, 4)
    st, outs = fns.track_chunk(tr.vit_params, tr.state, _chunk(views))
    assert int(st.frame_idx) == 3 and tuple(outs.position.shape) == (3, 2) and tuple(outs.lost.shape) == (3,)


def test_cli_stream_passes_every_stream_key(tmp_path):
    """The stream command passes every runtime.stream_* key to stream_track
    (as the JAX package's cli.py does): eval5's config cut to a tiny model
    and frame streams ROI views from the native ring in chunks of 4, one
    record a frame, in order."""
    from vitparticlefiltertracker_tpu_torch.cli import build_parser, load, main, stream_kwargs

    out = str(tmp_path / "roi.jsonl")
    config = os.path.join(os.path.dirname(__file__), "..", "configs", "eval5-tpu-streaming-4k.yaml")
    sets = ["io.source=native-synthetic:moving-square", "io.num_frames=11", "io.frame_size=[240, 320]",
            "model.variant=vit-t16", "model.image_size=64", "model.dtype=float32", "filter.num_particles=128",
            "runtime.stream_roi=200", "runtime.stream_roi_out=144", f"io.output={out}"]
    argv = ["stream", "--config", config, *(x for s in sets for x in ("--set", s))]
    cfg = load(build_parser().parse_args(argv))
    rt = cfg.runtime
    assert stream_kwargs(cfg) == dict(
        pump_depth=rt.prefetch_frames, readback_window=32, roi_px=200, roi_stride=4, roi_out=144, steer_lag=32,
        glob_stride=8, glob_every=4, chunk=4, steer_workers=rt.stream_steer_workers, chunk_max=rt.stream_chunk_max,
        fps_target=rt.stream_fps_target, lost_throttle=rt.stream_lost_throttle)
    assert main([*argv, "--device", "cpu", "--quiet"]) == 0
    recs = [json.loads(line) for line in open(out)]
    assert [r["frame"] for r in recs] == list(range(1, 11))
