"""Tracing and profiling: the port's counterpart of the JAX package's
``utils/profiling.py``, on the host's clock, ``torch.profiler`` and CUDA
events.

``SPANS`` is the program's span recorder, always on: spans and counters
taken where the work happens, on ``time.perf_counter_ns`` (the clock of the
benchmark's own spans, portbench/trace.py). The spans and counters, and the
threads that take them:

- the submitting thread of ``runtime/streaming.py`` ``stream_track``:
  ``stream.ingest`` (a wait on the frame pump or the native source),
  ``stream.submit`` (one a dispatch) with its children ``step.stage`` (a
  host array into a pinned staging slot, the slot's wait included),
  ``step.noise`` (the noise keys copied into the step's graph, which draws
  the noise on the card; on the CPU and in the eager step the host's
  draws), ``step.launch`` (the graph's
  input copies and its replay; on the CPU the eager step), ``roi.ship``
  (``RoiShipper.ship*``), and on a mesh's rank 0 ``mesh.control`` (the
  host's decisions sent) and ``mesh.broadcast`` (the staged input
  broadcast); ``stream.handover`` (a window to the drainer) and
  ``stream.flow`` (the ROI flow control's sleeps); ``stream.drain`` (the
  final flush);
- the drainer: ``drain.window`` (the wait for a window's event, its copy to
  the host, the unpacking and the calls to ``on_record``) and
  ``frame.hold`` (one a record, keyed by its frame: from the end of its
  dispatch's ``stream.submit`` to its hand-over to ``on_record``);
- the frame pump: ``pump.read`` (the source producing a frame);
- a mesh's other ranks: ``mesh.wait`` (``MeshFeed.follow`` waiting for rank
  0's next message) and ``mesh.broadcast``;
- counters: ``staging_waits`` (a staging slot still in flight),
  ``drain_blocked`` (a hand-over that found the drain queue full),
  ``graph_captures`` (a step or chunk graph captured), ``noise_host_draws``
  (a bank's step noise drawn by a torch.Generator on the host's call).

Two stores: aggregates by name (count, total and self time, self being the
total less the time the span's children cover), kept per thread and merged
when read (``totals``), and a bounded timeline of every span
(``timeline``, the newest ``TIMELINE_LEN``). A span costs two clock reads,
a small object, a tuple appended and a few integer adds: nothing touches
the device. ``stream_track`` reports its own run's share of the aggregates
(``Totals.since``).

``trace`` dumps a host and device trace when a directory is given, the
recorder's spans written into it on the trace's clock, and costs nothing
otherwise; ``device_kernels`` reads a trace's device time and calls by
kernel name (the one reader of ``key_averages()`` for the port's profile
tools), ``device_time_by_kernel`` its times alone;
``profiled_step_device_ms`` times a tracker step on the card with CUDA
events (runtime/benchmark.py's device span).
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import statistics
import threading
import time
from typing import Any, Callable, NamedTuple

import torch

TIMELINE_LEN = 65536  # about 20 s of the l16 cell's spans and its traced continuation
ANCHOR_CPU = "vpt.anchor"  # on the CPU, the profiled call that puts the host's clock on the trace's
ANCHOR_CUDA = "cudaDeviceSynchronize"


class _ThreadLog:
    """One thread's open spans (innermost last), aggregates and counters."""

    __slots__ = ("stack", "agg", "counts", "tid")

    def __init__(self):
        self.stack: list[Span] = []
        self.agg: dict[str, list[int]] = {}  # name -> [count, total ns, self ns]
        self.counts: dict[str, int] = {}
        self.tid = threading.get_native_id()


class _Local(threading.local):
    """The calling thread's log, made and registered on its first span."""

    def __init__(self, logs: list, lock: threading.Lock):
        self.log = _ThreadLog()
        with lock:
            logs.append(self.log)


class Span:
    """One span, a context manager (``SpanRecorder.span``). A span opened
    without a key takes the enclosing span's. ``end`` (ns) is set on exit."""

    __slots__ = ("_rec", "_log", "_child", "name", "key", "start", "end")

    def __init__(self, rec: "SpanRecorder", name: str, key):
        self._rec, self.name, self.key = rec, name, key

    def __enter__(self) -> "Span":
        log = self._log = self._rec._local.log
        stack = log.stack
        if self.key is None and stack:
            self.key = stack[-1].key
        self._child = 0
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = self.end = time.perf_counter_ns()
        log = self._log
        stack = log.stack
        stack.pop()
        total = end - self.start
        if stack:
            parent = stack[-1]
            parent._child += total
            parent = parent.name
        else:
            parent = None
        agg = log.agg.get(self.name)
        if agg is None:
            agg = log.agg[self.name] = [0, 0, 0]
        agg[0] += 1
        agg[1] += total
        agg[2] += total - self._child
        self._rec.timeline.append((self.name, self.start, end, log.tid, parent, self.key))


class Totals(NamedTuple):
    """A snapshot of the aggregates: {name: (count, total ns, self ns)} and
    {counter: value}, over every thread."""

    spans: dict[str, tuple[int, int, int]]
    counts: dict[str, int]

    def since(self, before: "Totals") -> dict[str, Any]:
        """What was added after `before`: {"spans": {name: {"n", "s",
        "self_s"}}, "counts": {counter: value}}, names with nothing added
        left out."""
        spans = {}
        for name, (n, t, s) in self.spans.items():
            n0, t0, s0 = before.spans.get(name, (0, 0, 0))
            if n > n0:
                spans[name] = {"n": n - n0, "s": (t - t0) * 1e-9, "self_s": (s - s0) * 1e-9}
        counts = {k: v - before.counts.get(k, 0) for k, v in self.counts.items() if v > before.counts.get(k, 0)}
        return {"spans": spans, "counts": counts}


class SpanRecorder:
    """Spans and counters of a process (see the module's docstring). Each
    timeline entry is (name, start ns, end ns, the thread's native id, the
    enclosing span's name or None, key)."""

    def __init__(self, maxlen: int = TIMELINE_LEN):
        self.timeline: collections.deque = collections.deque(maxlen=maxlen)
        self._logs: list[_ThreadLog] = []
        self._lock = threading.Lock()
        self._local = _Local(self._logs, self._lock)

    def span(self, name: str, key=None) -> Span:
        """``with recorder.span(name, key):`` times the block; key (a frame
        index) defaults to the enclosing span's."""
        return Span(self, name, key)

    def add(self, name: str, start_ns: int, end_ns: int, key=None) -> None:
        """A span whose ends were taken elsewhere (it may start on another
        thread): no enclosing span, self time its total."""
        log = self._local.log
        total = end_ns - start_ns
        agg = log.agg.get(name)
        if agg is None:
            agg = log.agg[name] = [0, 0, 0]
        agg[0] += 1
        agg[1] += total
        agg[2] += total
        self.timeline.append((name, start_ns, end_ns, log.tid, None, key))

    def count(self, name: str, n: int = 1) -> None:
        counts = self._local.log.counts
        counts[name] = counts.get(name, 0) + n

    def totals(self) -> Totals:
        with self._lock:
            logs = list(self._logs)
        spans: dict[str, list[int]] = {}
        counts: dict[str, int] = {}
        for log in logs:
            for name, agg in list(log.agg.items()):
                acc = spans.setdefault(name, [0, 0, 0])
                for i in range(3):
                    acc[i] += agg[i]
            for name, value in list(log.counts.items()):
                counts[name] = counts.get(name, 0) + value
        return Totals({k: tuple(v) for k, v in spans.items()}, counts)


SPANS = SpanRecorder()


@contextlib.contextmanager
def trace(profile_dir: str = ""):
    """Capture a host and device trace into profile_dir (a chrome trace,
    written on exit) if it is set; yields the ``torch.profiler.profile``
    object, or None when profile_dir is empty (then nothing is traced).

    The trace also holds the spans ``SPANS`` took while it ran (category
    ``program_span``, on their threads' rows, args ``key`` and ``parent``),
    moved onto the profiler's clock by an anchor: the host's clock read
    just before a call the profiler records (``cudaDeviceSynchronize`` on
    the card; a ``record_function`` on the CPU)."""
    if not profile_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        anchor_ns = time.perf_counter_ns()
        if cuda:
            torch.cuda.synchronize()
        else:
            with record_function(ANCHOR_CPU):
                pass
        yield prof
        end_ns = time.perf_counter_ns()
    path = os.path.join(profile_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    _write_spans(path, ANCHOR_CUDA if cuda else ANCHOR_CPU, anchor_ns, end_ns)


def _write_spans(path: str, anchor: str, anchor_ns: int, end_ns: int) -> None:
    """Add the timeline's spans that overlap [anchor_ns, end_ns] to the
    chrome trace at `path`, shifted by its first `anchor` event."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    found = [float(e["ts"]) for e in events if e.get("ph") == "X" and str(e.get("name", "")).startswith(anchor)]
    if not found:
        raise RuntimeError(f"the trace at {path} holds no anchor event {anchor!r}")
    shift = min(found) - anchor_ns / 1e3  # host perf_counter us -> trace us
    pid = os.getpid()
    for name, start, end, tid, parent, key in list(SPANS.timeline):
        if end > anchor_ns and start < end_ns:
            events.append({"ph": "X", "cat": "program_span", "name": name, "pid": pid, "tid": tid,
                           "ts": start / 1e3 + shift, "dur": (end - start) / 1e3,
                           "args": {"key": key, "parent": parent}})
    with open(path, "w") as f:
        json.dump(doc, f)


class KernelTime(NamedTuple):
    ms: float  # device time, summed over the calls
    calls: int


def device_kernels(prof) -> dict[str, KernelTime]:
    """Device time (ms) and calls by kernel name from a finished profile:
    CUDA events only (kernels, copies, memsets), summed over their calls; the
    CPU operators that launched them are left out, since they report the
    same device time again."""
    from torch.autograd import DeviceType

    return {e.key: KernelTime(e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def device_time_by_kernel(prof) -> dict[str, float]:
    """device_kernels' device times (ms) by kernel name."""
    return {k: v.ms for k, v in device_kernels(prof).items()}


def profiled_step_device_ms(step: Callable[[int], Any], device: torch.device, steps: int = 24) -> float | None:
    """Median device span (ms) of one tracker step on the card, or None on
    the CPU.

    step(i) enqueues the i-th of `steps` steps of a burst. A CUDA event is
    recorded on the current stream before and after each, and the host waits
    once, after the burst. A span holds everything the step enqueues on that
    stream: the copy of the frame into the graph's input, the noise keys' copy
    and the graph replay (with an eager tracker, every kernel of the step),
    and any time the card waits inside the step for the host to enqueue the
    rest of it. A failure on the card raises.
    """
    if torch.device(device).type != "cuda":
        return None
    stream = torch.cuda.current_stream(device)
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(steps)]
    for i, (start, end) in enumerate(events):
        start.record(stream)
        step(i)
        end.record(stream)
    events[-1][1].synchronize()
    return statistics.median(start.elapsed_time(end) for start, end in events)
