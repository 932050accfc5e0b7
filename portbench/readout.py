"""Quantities that several metric readers share, read from a harness.Run."""

from __future__ import annotations

import numpy as np


def submit_ms_per_dispatch(run) -> float | None:
    """The submitting thread's host time a dispatch (stream_track's
    ``submit_s`` over its dispatches), in ms."""
    n = sum(run.stats.get("dispatches", {}).values())
    return run.stats["submit_s"] / n * 1e3 if n else None


def device_ms_per_dispatch(run) -> float | None:
    """Device busy time of the traced slice (the union of kernel and copy
    intervals) over its dispatches, in ms."""
    sl = run.slice
    if sl is None or not sl.dispatches:
        return None
    return sl.busy_s / sl.dispatches * 1e3


def latency_percentile_ms(run, q: float) -> float | None:
    """The q-th percentile of the open loop's frame latencies (due time to
    record), in ms."""
    from portbench.harness import latencies_ms

    lat = latencies_ms(run)
    return float(np.percentile(lat, q)) if lat else None
