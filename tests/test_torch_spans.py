"""The port's span recorder (vitparticlefiltertracker_tpu_torch/utils/
profiling.py: SpanRecorder, SPANS, trace) and the spans the stream pipeline
takes (runtime/streaming.py stream_track), on the CPU. The mesh's spans
(mesh.control, mesh.broadcast, mesh.wait) are read in
tests/test_torch_mesh.py on two gloo ranks."""

import json
import threading
import time

import numpy as np
import pytest
import test_torch_tracker_e2e  # noqa: F401  (one intra-op thread a test worker)

from vitparticlefiltertracker_tpu_torch.config import Config
from vitparticlefiltertracker_tpu_torch.io.video import open_source
from vitparticlefiltertracker_tpu_torch.runtime.banked import MultiStreamTracker
from vitparticlefiltertracker_tpu_torch.runtime.streaming import stream_track
from vitparticlefiltertracker_tpu_torch.runtime.tracker import Tracker
from vitparticlefiltertracker_tpu_torch.utils import profiling
from vitparticlefiltertracker_tpu_torch.utils.profiling import SPANS, SpanRecorder

TINY = {
    "model": {"variant": "vit-t16", "image_size": 64, "dtype": "float32", "use_flash_attention": False},
    "filter": {"num_particles": 64},
    "tracker": {"mode": "dense"},
}


def _spin(ns: int) -> None:
    end = time.perf_counter_ns() + ns
    while time.perf_counter_ns() < end:
        pass


def _nesting() -> None:
    """Self time is the total less the children's; a child takes its
    parent's key and names it."""
    rec = SpanRecorder()
    with rec.span("outer", 7):
        _spin(200_000)
        for _ in range(2):
            with rec.span("inner"):
                _spin(100_000)
    spans = rec.totals().spans
    n, total, self_ns = spans["outer"]
    ni, ti, si = spans["inner"]
    assert (n, ni) == (1, 2) and si == ti
    assert self_ns == total - ti and self_ns >= 200_000
    inner, _, outer = rec.timeline
    assert [e[0] for e in rec.timeline] == ["inner", "inner", "outer"]
    assert inner[4:] == ("outer", 7) and outer[4:] == (None, 7)
    assert outer[1] <= inner[1] < inner[2] <= outer[2]


def _threads() -> None:
    """A pump's and a drainer's spans, open at once on two threads, keep
    their own stacks: neither is the other's parent; the aggregates merge."""
    rec = SpanRecorder()
    both_open, done = threading.Barrier(2, timeout=10), threading.Barrier(2, timeout=10)

    def work(outer: str, inner: str) -> None:
        with rec.span(outer):
            both_open.wait()
            with rec.span(inner):
                pass
            done.wait()

    threads = [threading.Thread(target=work, args=("pump.read", "a")),
               threading.Thread(target=work, args=("drain.window", "b"))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=10)
        assert not th.is_alive()
    by_name = {e[0]: e for e in rec.timeline}
    assert by_name["a"][4] == "pump.read" and by_name["b"][4] == "drain.window"
    assert by_name["pump.read"][4] is None and by_name["drain.window"][4] is None
    assert by_name["a"][3] == by_name["pump.read"][3] != by_name["b"][3] == by_name["drain.window"][3]
    assert {k: v[0] for k, v in rec.totals().spans.items()} == {"pump.read": 1, "drain.window": 1, "a": 1, "b": 1}


def _bound() -> None:
    """The timeline keeps the newest maxlen entries."""
    rec = SpanRecorder(maxlen=8)
    for i in range(20):
        with rec.span("s", i):
            pass
    rec.add("hold", 100, 105, 3)
    assert rec.timeline.maxlen == 8 and len(rec.timeline) == 8
    assert [e[5] for e in rec.timeline] == [13, 14, 15, 16, 17, 18, 19, 3]
    assert rec.timeline[-1] == ("hold", 100, 105, threading.get_native_id(), None, 3)


def _aggregates_past_the_bound() -> None:
    """The aggregates and counters count every span after the timeline has
    dropped the oldest; since() gives what was added after a snapshot."""
    rec = SpanRecorder(maxlen=4)
    for _ in range(10):
        with rec.span("s"):
            pass
    rec.count("c")
    before = rec.totals()
    for _ in range(5):
        with rec.span("s"):
            with rec.span("t"):
                pass
    rec.add("hold", 0, 2_000_000_000)
    rec.count("c", 2)
    totals = rec.totals()
    assert totals.spans["s"][0] == 15 and totals.counts == {"c": 3} and len(rec.timeline) == 4
    run = totals.since(before)
    assert {k: v["n"] for k, v in run["spans"].items()} == {"s": 5, "t": 5, "hold": 1}
    assert run["spans"]["hold"] == {"n": 1, "s": 2.0, "self_s": 2.0}
    assert run["counts"] == {"c": 2}
    s = run["spans"]["s"]
    assert 0 <= s["self_s"] <= s["s"] and s["s"] - s["self_s"] == pytest.approx(run["spans"]["t"]["s"])


@pytest.mark.parametrize("case", [_nesting, _threads, _bound, _aggregates_past_the_bound],
                         ids=["nesting", "threads", "bound", "aggregates-past-the-bound"])
def test_span_recorder(case):
    case()


def _stream(kind: str):
    """A tiny stream_track run -> (stats, records)."""
    cfg = Config.from_dict(TINY)
    recs = []
    if kind == "multistream":
        clips = [open_source("synthetic:moving-square", num_frames=8, frame_size=(96, 96), seed=i) for i in range(2)]
        frames = np.stack([np.stack(c.frames) for c in clips], axis=1)
        boxes = np.stack([np.asarray(c.init_bbox, np.float32) for c in clips])
        return stream_track(MultiStreamTracker(cfg, 2, device="cpu"), iter(frames), boxes, on_record=recs.append,
                            readback_window=2), recs
    src = open_source("synthetic:moving-square", num_frames=12, frame_size=(128, 128))
    kw = dict(readback_window=3)
    if kind == "roi-chunk":  # chunks of 2 and a one-frame tail
        kw.update(roi_px=128, glob_stride=4, glob_every=2, chunk=2, steer_lag=4)
    return stream_track(Tracker(cfg, device="cpu"), src, src.init_bbox, on_record=recs.append, **kw), recs


@pytest.mark.parametrize("kind", ["frames", "multistream", "roi-chunk"])
def test_stream_track_spans(kind):
    """stream_track's share of the spans: a stream.submit a dispatch and
    submit_s its total; a frame.hold a record, keyed by its frame; the
    dispatch's children within it; the old stage keys read from the spans."""
    stats, recs = _stream(kind)
    spans = stats["spans"]
    dispatches = sum(stats["dispatches"].values())
    assert spans["stream.submit"]["n"] == dispatches > 0
    assert stats["submit_s"] == round(spans["stream.submit"]["s"], 3)
    assert stats["ingest_wait_s"] == round(spans["stream.ingest"]["s"], 3)
    assert stats["drain_s"] == round(spans["stream.drain"]["s"], 3)
    assert stats["readback_s"] == round(sum(spans[k]["s"] for k in ("stream.handover", "stream.flow") if k in spans), 3)
    assert spans["frame.hold"]["n"] == len(recs) and spans["drain.window"]["n"] == stats["drain_windows"]
    holds = [e for e in SPANS.timeline if e[0] == "frame.hold"][-len(recs):]
    assert [e[5] for e in holds] == [r["frame"] for r in recs]
    assert all(e[1] < e[2] for e in holds)
    assert spans["step.noise"]["n"] == spans["step.launch"]["n"] == dispatches
    children = ("roi.ship", "step.noise", "step.launch") if kind == "roi-chunk" else ("step.stage", "step.noise",
                                                                                       "step.launch")
    assert sum(spans[k]["s"] for k in children) <= spans["stream.submit"]["s"]
    assert 0 <= spans["stream.submit"]["self_s"] <= spans["stream.submit"]["s"]
    assert stats["staging_waits"] == stats["graph_captures"] == 0  # the CPU stages nothing and captures nothing
    if kind == "roi-chunk":
        assert stats["dispatches"] == {2: 5, 1: 1} and spans["roi.ship"]["n"] == dispatches
        assert spans["stream.flow"]["n"] >= 1
    else:
        assert spans["step.stage"]["n"] == dispatches and "roi.ship" not in spans


def test_trace_holds_the_programs_spans_on_its_clock(tmp_path):
    """profiling.trace around a CPU stream: the chrome trace holds the
    stream's spans (a stream.submit a dispatch) inside the profiled interval,
    and every operator the submitting thread ran between its first and last
    dispatch lies inside a stream.submit span placed by the anchor."""
    cfg = Config.from_dict(TINY)
    src = open_source("synthetic:moving-square", num_frames=6, frame_size=(96, 96))
    t_in = time.perf_counter_ns()
    with profiling.trace(str(tmp_path)):
        stats = stream_track(Tracker(cfg, device="cpu"), src, src.init_bbox, on_record=lambda r: None,
                             readback_window=2)
    wall_us = (time.perf_counter_ns() - t_in) / 1e3
    (path,) = tmp_path.glob("*.json")
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    anchor = min(e["ts"] for e in events if e["name"] == profiling.ANCHOR_CPU)
    mine = [e for e in events if e.get("cat") == "program_span"]
    submits = [e for e in mine if e["name"] == "stream.submit"]
    assert len(submits) == sum(stats["dispatches"].values()) == 5
    assert {"stream.ingest", "step.stage", "step.noise", "step.launch", "drain.window", "frame.hold",
            "pump.read", "stream.drain"} <= {e["name"] for e in mine}
    assert all(anchor <= e["ts"] and e["ts"] + e["dur"] <= anchor + wall_us for e in mine)
    tid = submits[0]["tid"]
    lo, hi = submits[0]["ts"], submits[-1]["ts"] + submits[-1]["dur"]
    ops = [e for e in events if e.get("cat") == "cpu_op" and e["tid"] == tid and lo <= e["ts"] <= hi]
    assert len(ops) > 20
    slack = 50.0  # us: the anchor's own call, between the clock read and the profiler's event
    inside = [op for op in ops if any(s["ts"] - slack <= op["ts"] and op["ts"] + op["dur"] <= s["ts"] + s["dur"] + slack
                                      for s in submits)]
    assert len(inside) == len(ops)


@pytest.mark.parametrize("command", ["stream", "serve"])
def test_commands_trace_into_profile_dir(command, tmp_path):
    """runtime.profile_dir under the stream and serve commands: one chrome
    trace with the stream's dispatches as program spans."""
    from vitparticlefiltertracker_tpu_torch.cli import main

    sets = ["model.variant=vit-t16", "model.image_size=64", "model.dtype=float32", "filter.num_particles=32",
            "io.num_frames=5", "io.frame_size=[96, 96]", "runtime.streams=2", f"io.output={tmp_path / 'out.jsonl'}",
            f"runtime.profile_dir={tmp_path / 'trace'}"]
    assert main([command, "--device", "cpu", "--quiet", *(x for s in sets for x in ("--set", s))]) == 0
    (path,) = (tmp_path / "trace").glob("*.json")
    names = [e["name"] for e in json.loads(path.read_text())["traceEvents"] if e.get("cat") == "program_span"]
    assert names.count("stream.submit") == 4 and names.count("frame.hold") == 4
