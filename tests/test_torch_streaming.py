"""The port's streaming pipeline and its commands
(vitparticlefiltertracker_tpu_torch/runtime/streaming.py: FramePump,
OutputPacker, stream_track over whole frames; cli.py: stream, serve) and
open_source's dispatch, on the CPU. ROI streaming:
tests/test_torch_streaming_roi.py.

The FramePump tests mirror tests/test_io_and_streaming.py's. Parity with the
JAX package is transitive: stream_track's records are held equal to
Tracker.run's and MultiTracker.step's, and serve's to MultiStreamTracker's
steps, on the same tiny configs; those trackers are held to the JAX
package's with its noise injected (tests/test_torch_tracker_e2e.py,
tests/test_torch_banked.py). OutputPacker is held to the JAX package's on
the same row.
"""

import json
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_tracker_e2e  # noqa: F401  (one intra-op thread a test worker)
import torch

from vitparticlefiltertracker_tpu.runtime import streaming as jstreaming
from vitparticlefiltertracker_tpu.runtime import tracker as jtr
from vitparticlefiltertracker_tpu_torch.cli import build_parser, load, main
from vitparticlefiltertracker_tpu_torch.config import Config
from vitparticlefiltertracker_tpu_torch.io.video import open_source
from vitparticlefiltertracker_tpu_torch.runtime.banked import MultiStreamTracker, MultiTracker, banked_bboxes
from vitparticlefiltertracker_tpu_torch.runtime.streaming import FramePump, OutputPacker, stream_track
from vitparticlefiltertracker_tpu_torch.runtime.tracker import Tracker, TrackOutput

TINY = {
    "model": {"variant": "vit-t16", "image_size": 64, "dtype": "float32", "use_flash_attention": False},
    "filter": {"num_particles": 64},
    "tracker": {"mode": "dense"},
}
# Every --set of the CLI tests: the tiny model and a short clip.
TINY_SETS = ["model.variant=vit-t16", "model.image_size=64", "model.dtype=float32",
             "model.use_flash_attention=false", "filter.num_particles=32", "io.num_frames=5",
             "io.frame_size=[96, 96]"]
RECORD_KEYS = ("frame", "position", "box", "velocity", "conf", "ess", "lost")


def _cli(*args, sets=()):
    argv = list(args)
    for s in (*TINY_SETS, *sets):
        argv += ["--set", s]
    return main([*argv, "--device", "cpu", "--quiet"])


def _threads_left(before: set) -> list:
    """Threads started since `before` that are still alive after a short join."""
    left = [t for t in threading.enumerate() if t not in before]
    for t in left:
        t.join(timeout=5)
    return [t for t in left if t.is_alive()]


# ---------------------------------------------------------------------------
# FramePump (as tests/test_io_and_streaming.py)
# ---------------------------------------------------------------------------

def test_frame_pump_order_and_completion():
    frames = [np.full((4, 4, 3), i, np.uint8) for i in range(200)]
    pump = FramePump(iter(frames), depth=3)
    got = [int(f[0, 0, 0]) for f in pump]
    assert got == list(range(200))


def test_frame_pump_backpressure_bounds_memory():
    produced = []

    def gen():
        for i in range(50):
            produced.append(i)
            yield np.full((2, 2, 3), i, np.uint8)

    pump = FramePump(gen(), depth=2)
    time.sleep(0.2)  # the producer stalls at the bound, it does not run ahead
    assert len(produced) <= 4  # depth + one put in flight + one being generated
    list(pump)
    assert len(produced) == 50


def test_frame_pump_error_propagates():
    def gen():
        yield np.zeros((2, 2, 3), np.uint8)
        raise RuntimeError("decode failed")

    pump = FramePump(gen(), depth=2)
    with pytest.raises(RuntimeError, match="decode failed"):
        list(pump)


def test_frame_pump_concurrent_consumers_race():
    """Several consumers draining one pump partition the stream exactly (no
    duplicates, no losses) and none of them dies."""
    n = 300
    pump = FramePump((np.full((2, 2, 3), i % 251, np.uint8) for i in range(n)), depth=4)
    it = iter(pump)
    seen, crashes = [], []
    lock = threading.Lock()

    def consume():
        try:
            while True:
                try:
                    f = next(it)
                except StopIteration:
                    return
                with lock:
                    seen.append(int(f[0, 0, 0]))
        except BaseException as e:  # noqa: BLE001 — the point is to catch all
            with lock:
                crashes.append(e)

    threads = [threading.Thread(target=consume) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads), "consumer wedged"
    assert crashes == [], f"consumer thread(s) crashed: {crashes}"
    assert sorted(seen) == sorted(i % 251 for i in range(n))


def test_frame_pump_error_propagates_once_to_concurrent_consumers():
    """A producer error surfaces in exactly one consumer; the others stop
    cleanly."""
    def gen():
        yield np.zeros((2, 2, 3), np.uint8)
        raise RuntimeError("decode failed")

    pump = FramePump(gen(), depth=2)
    it = iter(pump)
    errors = []
    lock = threading.Lock()

    def consume():
        try:
            for _ in it:
                pass
        except RuntimeError as e:
            with lock:
                errors.append(e)

    threads = [threading.Thread(target=consume) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(errors) == 1 and "decode failed" in str(errors[0])


# ---------------------------------------------------------------------------
# OutputPacker against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("banks", [None, 3])
def test_output_packer_matches_jax(banks):
    """One TrackOutput made with numpy (K banks, or one filter), packed by
    the port, unpacked by both packers: the same fields, shapes and values
    (JAX's unpack gives the flags as 0/1 floats, the port's as bools)."""
    rng = np.random.default_rng(1)
    lead = () if banks is None else (banks,)
    fields = {"position": rng.normal(size=(*lead, 2)), "box": rng.uniform(1, 50, (*lead, 2)),
              "velocity": rng.normal(size=(*lead, 2)), "conf": rng.uniform(size=lead),
              "ess": rng.uniform(1, 64, lead), "resampled": rng.uniform(size=lead) > 0.5,
              "lost": rng.uniform(size=lead) > 0.5}
    fields = {k: np.asarray(v, np.bool_ if k in ("resampled", "lost") else np.float32) for k, v in fields.items()}
    example = jtr.TrackOutput(**{k: jnp.asarray(v) for k, v in fields.items()})
    jpacker = jstreaming.OutputPacker(example)
    row = OutputPacker(banks).pack(TrackOutput(**{k: torch.from_numpy(np.array(v)) for k, v in fields.items()}))
    np.testing.assert_array_equal(row.numpy(), np.asarray(jpacker.pack(example)))
    got, want = OutputPacker(banks).unpack(row.numpy()), jpacker.unpack(row.numpy())
    for k in fields:
        g, w = getattr(got, k), np.asarray(getattr(want, k))
        assert g.shape == w.shape == fields[k].shape, k
        np.testing.assert_array_equal(g.astype(np.float32), w.astype(np.float32), err_msg=k)


# ---------------------------------------------------------------------------
# stream_track end to end on the tiny tracker
# ---------------------------------------------------------------------------

def test_stream_track_end_to_end():
    """As tests/test_io_and_streaming.py:test_stream_track_end_to_end, and
    the records equal Tracker.run's on the same config and clip."""
    cfg = Config.from_dict(TINY)
    src = open_source("synthetic:moving-square", num_frames=10, frame_size=(128, 128))
    recs = []
    stats = stream_track(Tracker(cfg, device="cpu"), src, src.init_bbox, on_record=recs.append, readback_window=3)
    assert stats["frames"] == 9 and stats["drain_windows"] == 3
    assert [r["frame"] for r in recs] == list(range(1, 10))  # ordered, complete
    assert all(np.isfinite(r["position"]).all() for r in recs)
    want = list(Tracker(cfg, device="cpu").run(src))
    assert [{k: r[k] for k in RECORD_KEYS} for r in recs] == [{k: r[k] for k in RECORD_KEYS} for r in want]
    assert isinstance(recs[0]["conf"], float) and isinstance(recs[0]["lost"], bool)


def test_stream_track_banked_matches_multitracker():
    """A MultiTracker of 3 banks on synthetic:multi-3 through stream_track:
    one record a frame with K-vector fields, equal to MultiTracker.step's K
    records a frame."""
    cfg = Config.from_dict({**TINY, "runtime": {"banks": 3}})
    src = open_source("synthetic:multi-3", num_frames=7, frame_size=(160, 160))
    boxes = banked_bboxes(src.init_bbox, 3)
    recs = []
    stream_track(MultiTracker(cfg, device="cpu"), src, boxes, on_record=recs.append, readback_window=2)
    mt = MultiTracker(cfg, device="cpu")
    mt.init(src.frames[0], boxes)
    want = [mt.step(f) for f in src.frames[1:]]
    assert [r["frame"] for r in recs] == list(range(1, 7))
    for rec, banks in zip(recs, want):
        assert np.asarray(rec["position"]).shape == (3, 2) and len(rec["lost"]) == 3
        for key in ("position", "box", "conf", "ess", "lost"):
            assert rec[key] == [b[key] for b in banks], key


def test_stream_track_refuses_roi_and_chunks():
    """JAX's refusals: chunks without ROI shipping, ROI shipping of banks, a
    resampled ROI view without a native source (ROI streaming itself runs:
    tests/test_torch_streaming_roi.py)."""
    cfg = Config.from_dict(TINY)
    src = open_source("synthetic:moving-square", num_frames=3, frame_size=(96, 96))
    with pytest.raises(ValueError, match="requires roi_px > 0"):
        stream_track(Tracker(cfg, device="cpu"), src, src.init_bbox, chunk=4)
    with pytest.raises(ValueError, match="single tracker"):
        stream_track(MultiTracker(Config.from_dict({**TINY, "runtime": {"banks": 2}}), device="cpu"), src,
                     banked_bboxes(src.init_bbox, 2), roi_px=64)
    with pytest.raises(ValueError, match="requires a native source"):
        stream_track(Tracker(cfg, device="cpu"), src, src.init_bbox, roi_px=64, roi_out=32)


def test_stream_track_drain_error_surfaces_after_teardown():
    """An error in on_record (the drainer's thread) is raised by
    stream_track once the stream is done, and no thread it started is left
    running."""
    cfg = Config.from_dict(TINY)
    src = open_source("synthetic:moving-square", num_frames=12, frame_size=(96, 96))
    seen = []

    def on_record(rec):
        seen.append(rec["frame"])
        if len(seen) == 2:
            raise RuntimeError("sink failed")

    before = set(threading.enumerate())
    with pytest.raises(RuntimeError, match="sink failed"):
        stream_track(Tracker(cfg, device="cpu"), src, src.init_bbox, on_record=on_record, readback_window=2)
    assert seen == [1, 2]  # the drainer stopped emitting at the error
    assert _threads_left(before) == []


# ---------------------------------------------------------------------------
# The stream and serve commands
# ---------------------------------------------------------------------------

def test_cli_stream_writes_track_records(tmp_path):
    """`stream` writes what `track` writes, frame for frame (the JAX
    package's stream keys: no resampled, no step time)."""
    out = {}
    for cmd in ("track", "stream"):
        path = str(tmp_path / f"{cmd}.jsonl")
        assert _cli(cmd, sets=["io.source=synthetic:moving-square", f"io.output={path}"]) == 0
        out[cmd] = [json.loads(line) for line in open(path)]
    assert len(out["stream"]) == 4 and set(out["stream"][0]) == set(RECORD_KEYS)
    assert out["stream"] == [{k: r[k] for k in RECORD_KEYS} for r in out["track"]]


def test_cli_stream_banked(tmp_path):
    """`stream` with runtime.banks 2 on synthetic:multi-2: one record a
    frame with 2-vector fields."""
    path = str(tmp_path / "banked.jsonl")
    assert _cli("stream", sets=["runtime.banks=2", "io.source=synthetic:multi-2", f"io.output={path}"]) == 0
    recs = [json.loads(line) for line in open(path)]
    assert [r["frame"] for r in recs] == [1, 2, 3, 4]
    assert all(np.asarray(r["position"]).shape == (2, 2) and len(r["lost"]) == 2 for r in recs)


def test_cli_serve_multistream(tmp_path):
    """`serve` (as tests/test_sinks.py:test_cli_serve_multistream, with
    --device cpu): K sources in, K interleaved JSONL record streams out,
    each complete and ordered; the positions are MultiStreamTracker's on the
    same clips."""
    out = str(tmp_path / "serve.jsonl")
    assert _cli("serve", sets=["runtime.streams=3", "io.source=synthetic:moving-square", f"io.output={out}"]) == 0
    recs = [json.loads(line) for line in open(out)]
    assert len(recs) == 3 * 4  # 3 streams x 4 tracked frames
    assert {r["stream"] for r in recs} == {0, 1, 2}
    for s in range(3):
        assert [r["frame"] for r in recs if r["stream"] == s] == [1, 2, 3, 4]
    p0 = [r["position"] for r in recs if r["stream"] == 0]
    p1 = [r["position"] for r in recs if r["stream"] == 1]
    assert p0 != p1  # a seed a stream: distinct trajectories

    cfg = load(build_parser().parse_args(["serve", *(x for item in TINY_SETS for x in ("--set", item))]))
    srcs = [open_source("synthetic:moving-square", 5, (96, 96), seed=i) for i in range(3)]
    clips = np.stack([np.stack(s.frames) for s in srcs], axis=1)
    ms = MultiStreamTracker(cfg, 3, device="cpu")
    ms.init(clips[0], np.stack([s.init_bbox for s in srcs]))
    for t, frames in enumerate(clips[1:], start=1):
        pos = ms.step_device(torch.from_numpy(frames)).position.numpy()
        for s in range(3):
            (rec,) = [r for r in recs if r["stream"] == s and r["frame"] == t]
            assert rec["position"] == pos[s].tolist()


# ---------------------------------------------------------------------------
# open_source's dispatch
# ---------------------------------------------------------------------------

def test_unknown_source_rejected():
    with pytest.raises(ValueError, match="cannot infer source type"):
        open_source("not-a-real-thing.xyz")


@pytest.mark.parametrize("source", ["clip.mp4", "camera:0"])
def test_unported_sources_name_the_roadmap(source):
    """A source the JAX package reads and the port does not yet raises
    NotImplementedError naming ROADMAP.md, not the unknown-source error."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        open_source(source)


@pytest.mark.parametrize("source", ["native-synthetic:", "feed.rgb24"])
def test_native_sources_open(source, tmp_path):
    """The native ring's sources open as in the JAX package: the synthetic
    clip and a raw RGB24 file, each a native source with its frames."""
    from vitparticlefiltertracker_tpu_torch.io import native

    if source.endswith(".rgb24"):
        clip = np.random.default_rng(0).integers(0, 255, (3, 24, 32, 3), dtype=np.uint8)
        source = str(tmp_path / source)
        clip.tofile(source)
        src = open_source(source, 0, (24, 32))
        assert isinstance(src, native.NativeRawSource)
        assert all(np.array_equal(a, b) for a, b in zip(src, clip))
    else:
        src = open_source(source, 4, (48, 64), seed=1)
        assert isinstance(src, native.NativeSyntheticSource) and src.truth.shape == (4, 2)
        assert [f.shape for f in src] == [(48, 64, 3)] * 4
