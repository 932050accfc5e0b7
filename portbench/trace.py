"""The traced slice: ``torch.profiler`` over a fixed count of dispatches of
the served stream, reduced to device intervals, kernels by name,
dispatches and the host's activity in the device's idle gaps.

A traced run traces a continuation of its stream after the window has
closed: the same tracker with the state the window left (its ``init`` is
not called again), each feed's clip played on from where the window's
source stopped, the same stream settings; ``SKIP`` dispatches to reach a
steady state, the cell's ``trace_dispatches`` (the slice) and ``TAIL``
more. The window
itself runs with no profiler in the process, so that the program's
counters read there (``stream_track``'s ``submit_s``) are the untraced
run's: a profiler that was once started in the process slows every later
host step. The continuation is traced with CUDA activity alone (kernels,
copies, CUDA runtime calls; no CPU operators, whose recording is most of
the profiler's host cost), started and stopped while no stream runs.

The slice's wall span runs from the frame source's handing over of its
first dispatch to that of the first after it, on the host's clock, moved
onto the trace's clock by an anchor: a call made just after the profiler
starts (``cudaDeviceSynchronize`` on the card; a ``record_function`` on the
CPU, where the tests run) at a known host time. The same shift places the
benchmark's own spans. ``kernel_table`` is a frozen copy of the
arithmetic of ``vitparticlefiltertracker_tpu_torch/utils/profiling.py``
``device_kernels`` (device time and calls by kernel name, CUDA events
only).
"""

from __future__ import annotations

import heapq
import json
import os
import tempfile
import time
from collections import defaultdict

ANCHOR_CPU = "portbench.anchor"
ANCHOR_CUDA = "cudaDeviceSynchronize"
SKIP = 20  # dispatches of the traced stream before the slice
TAIL = 5  # dispatches after it
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver", "cpu_op", "user_annotation")


class Frames:
    """The traced stream's frames from `start`: the frame before it (which
    ``stream_track`` hands to the tracker's ``init``, not called here), then
    SKIP + `count` + TAIL dispatches; on the camera's schedule for an open
    loop, as fast as they are taken for a closed one. ``marks``: when the
    slice's first dispatch and the first after it were handed over
    (perf_counter ns)."""

    def __init__(self, feeds, wl: dict, start: int, count: int, spans: list):
        self.feeds, self.start, self.count, self.spans = feeds, start, count, spans
        self.rate = float(wl["rate_fps"]) if wl["loop"] == "open" else 0.0
        self.marks = (0, 0)

    def __iter__(self):
        yield self.feeds.batch(self.start - 1)
        start, m0 = time.perf_counter(), 0
        for k in range(SKIP + self.count + TAIL):
            t0 = time.perf_counter_ns()
            batch = self.feeds.batch(self.start + k)
            if self.rate:
                while (left := start + k / self.rate - time.perf_counter()) > 0:
                    time.sleep(min(left, 0.002) if left > 0.0005 else 0)
            now = time.perf_counter_ns()
            self.spans.append(("source.camera" if self.rate else "source.frames", t0, now))
            if k == SKIP:
                m0 = now
            elif k == SKIP + self.count:
                self.marks = (m0, now)
            yield batch


def traced_slice(tracker, feeds, wl: dict, start: int, bboxes, stream_kwargs: dict, cuda: bool,
                 spans: list) -> "Slice":
    """Trace the served stream's continuation from frame `start` (see the
    module's docstring) and reduce it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from vitparticlefiltertracker_tpu_torch.runtime.streaming import stream_track

    frames = Frames(feeds, wl, start, wl["trace_dispatches"], spans)
    prof = profile(activities=[ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU])
    tracker.init = lambda *args, **kwargs: None  # the state the window left goes on
    prof.start()
    try:
        anchor_ns = time.perf_counter_ns()
        if cuda:
            torch.cuda.synchronize()
        else:
            with record_function(ANCHOR_CPU):
                pass
        stream_track(tracker, frames, bboxes, **stream_kwargs)
    finally:
        prof.stop()
        del tracker.init
    return Slice(_events(prof), frames.marks, spans, (ANCHOR_CUDA if cuda else ANCHOR_CPU, anchor_ns))


def _events(prof) -> list[dict]:
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


class Slice:
    """The reduced slice. Times in seconds; device intervals clipped to the
    slice's wall span."""

    def __init__(self, events: list[dict], marks: tuple[int, int], spans: list[tuple[str, int, int]],
                 anchor: tuple[str, int]):
        name, anchor_ns = anchor
        found = sorted(float(e["ts"]) for e in events if e.get("ph") == "X" and str(e.get("name", "")).startswith(name))
        if not found:
            raise RuntimeError(f"the trace holds no anchor event {name!r}")
        if marks[1] <= marks[0]:
            raise RuntimeError("the traced stream ended before its slice")
        shift = found[0] - anchor_ns / 1e3  # host perf_counter us -> trace us
        a0, a1 = marks[0] / 1e3 + shift, marks[1] / 1e3 + shift
        self.t0, self.t1 = a0, a1
        self.wall_s = (a1 - a0) * 1e-6
        self.kernels: list[tuple[str, float, float, tuple]] = []  # (name, start us, end us, grid)
        self.copies: list[tuple[str, float, float]] = []
        self.host: list[tuple[str, float, float]] = []
        self.graph_launches = 0
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = str(e.get("cat", "")).lower()
            s, d = float(e["ts"]), float(e["dur"])
            end = s + d
            name = str(e.get("name", ""))
            if cat in DEVICE_CATS:
                cs, ce = max(s, a0), min(end, a1)
                if ce <= cs:
                    continue
                if cat == "kernel":
                    self.kernels.append((name, cs, ce, tuple(e.get("args", {}).get("grid", ()))))
                else:
                    self.copies.append((name, cs, ce))
            elif cat in HOST_CATS:
                if cat == "cuda_runtime" and name.startswith("cudaGraphLaunch") and a0 <= s <= a1:
                    self.graph_launches += 1
                if end > a0 and s < a1:
                    self.host.append((f"{cat}:{name}", s, end))
        for name, s_ns, e_ns in spans:  # the benchmark's spans, on the trace's clock
            s, e = s_ns / 1e3 + shift, e_ns / 1e3 + shift
            if e > a0 and s < a1:
                self.host.append((f"portbench:{name}", s, e))
        self.busy_intervals = _union([(s, e) for _, s, e, _ in self.kernels] + [(s, e) for _, s, e in self.copies])
        self.busy_s = sum(e - s for s, e in self.busy_intervals) * 1e-6

    @property
    def dispatches(self) -> int:
        return self.graph_launches

    def device_s(self, keep) -> float:
        """Device seconds of the kernels whose name `keep` accepts."""
        return sum(e - s for name, s, e, _ in self.kernels if keep(name)) * 1e-6

    def copy_s(self) -> float:
        return sum(e - s for _, s, e in self.copies) * 1e-6

    def gaps(self) -> list[tuple[float, float]]:
        out, t = [], self.t0
        for s, e in self.busy_intervals:
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if t < self.t1:
            out.append((t, self.t1))
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time by
        what the host was doing (the host event that overlaps most of each
        gap; "no host event" where none does)."""
        ops = [[name[:160], s] for name, s in sorted(kernel_table(self).items(), key=lambda kv: -kv[1])[:top]]
        host = sorted(self.host, key=lambda h: h[1])
        idle: dict[str, float] = defaultdict(float)
        active: list[tuple[float, int]] = []  # (end, index into host), a heap
        i = 0
        for g0, g1 in self.gaps():
            while i < len(host) and host[i][1] < g1:
                heapq.heappush(active, (host[i][2], i))
                i += 1
            while active and active[0][0] <= g0:
                heapq.heappop(active)
            best, best_overlap = "no host event", 0.0
            for end, j in active:
                overlap = min(end, g1) - max(host[j][1], g0)
                if overlap > best_overlap:
                    best, best_overlap = host[j][0], overlap
            idle[best[:160]] += (g1 - g0) * 1e-6
        gaps = [[name, s] for name, s in sorted(idle.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": ops, "idle_gaps": gaps}


def kernel_table(sl: Slice) -> dict[str, float]:
    """Device seconds by operation name, kernels and copies."""
    out: dict[str, float] = defaultdict(float)
    for name, s, e, _ in sl.kernels:
        out[name] += (e - s) * 1e-6
    for name, s, e in sl.copies:
        out[name] += (e - s) * 1e-6
    return dict(out)


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]
