"""The program's own spans and counters, for the metric readers.

The program (``vitparticlefiltertracker_tpu_torch/utils/profiling.py``)
records spans where its work happens, on ``time.perf_counter_ns``, the clock
of the benchmark's own spans. Two readings:

- ``window_ms``: a span's seconds in the untraced window, from
  ``stream_track``'s share of the aggregates (``run.stats["spans"]``), over
  the window's dispatches or over the span's count;
- ``placed``: a span's timeline entries moved onto the traced slice's clock.
  The shift is the one ``trace.py`` took from its anchor, recovered from the
  run without it: ``Slice.t0`` is the host mark of the slice's first
  dispatch on the trace's clock, and the same mark on the host's clock is
  the end of the continuation's source span number ``trace.SKIP`` (the
  continuation's source spans are the last ``SKIP + trace_dispatches +
  TAIL`` ``source.*`` entries of ``run.spans``).

``timeline`` gives the recorder's own entries (name, start ns, end ns,
thread, parent, key), which ``harness.latency_parts`` reads by frame.

Each returns None where the program records no such span (a program without
the recorder), so that a metric reading it is left out of the result line.
"""

from __future__ import annotations

from portbench import trace

SOURCE_SPANS = ("source.frames", "source.camera")


def window_ms(run, name: str, per: str = "dispatch") -> float | None:
    """ms of span `name` in the window, a dispatch (`per` "dispatch") or a
    span (`per` "span"), or None."""
    spans = run.stats.get("spans") or {}
    if name not in spans:
        return None
    n = sum(run.stats.get("dispatches", {}).values()) if per == "dispatch" else spans[name]["n"]
    return spans[name]["s"] / n * 1e3 if n else None


def timeline():
    try:
        from vitparticlefiltertracker_tpu_torch.utils import profiling
    except ImportError:
        return None
    recorder = getattr(profiling, "SPANS", None)
    return None if recorder is None else list(recorder.timeline)


def shift_us(run) -> float | None:
    """Host perf_counter us -> the trace's us, as trace.py's anchor gave it."""
    sl = run.slice
    count = trace.SKIP + run.wl["trace_dispatches"] + trace.TAIL
    source = [s for s in run.spans if s[0] in SOURCE_SPANS][-count:]
    if sl is None or len(source) < count:
        return None
    return sl.t0 - source[trace.SKIP][2] / 1e3


def placed(run, name: str) -> list[tuple[float, float]] | None:
    """The program's `name` spans that overlap the traced slice, as (start,
    end) in the trace's us (sorted), or None."""
    shift, entries = shift_us(run), timeline()
    if shift is None or entries is None:
        return None
    sl = run.slice
    out = []
    for entry in entries:
        if entry[0] == name:
            s, e = entry[1] / 1e3 + shift, entry[2] / 1e3 + shift
            if e > sl.t0 and s < sl.t1:
                out.append((s, e))
    return sorted(out)


def overlap_us(a: list[tuple[float, float]], b: list[tuple[float, float]]) -> float:
    """Length of the intersection of two unions of intervals, each given
    sorted and disjoint."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total
