"""Tracing and profiling hooks: the port's counterpart of the JAX package's
``utils/profiling.py``, on ``torch.profiler`` and CUDA events.

``trace`` dumps a host and device trace when a directory is given and costs
nothing otherwise; ``device_kernels`` reads a trace's device time and calls
by kernel name (the one reader of ``key_averages()`` for the port's profile
tools), ``device_time_by_kernel`` its times alone; ``profiled_step_device_ms``
times a tracker step on the card with CUDA events (runtime/benchmark.py's
device span).
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Any, Callable, NamedTuple

import torch


@contextlib.contextmanager
def trace(profile_dir: str = ""):
    """Capture a host and device trace into profile_dir (a chrome trace,
    written on exit) if it is set; yields the ``torch.profiler.profile``
    object, or None when profile_dir is empty (then nothing is traced)."""
    if not profile_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(profile_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


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
    stream: the copy of the frame into the graph's input, the noise copies
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
