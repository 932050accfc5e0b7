"""A tracker step captured as CUDA graphs and replayed: the port's counterpart
of the JAX package's one jitted, state-donating step executable.

``StepGraphs`` holds, for one frame shape and dtype, the static buffers a
step reads (the frame, the step noise, the re-detection reseed normals; with
a leading K axis for K banks: frame [H, W, 3] shared or [K, H, W, 3], noise
[K, N, ...], reseed [K, N, 2]) and
one graph for each branch key (probe, scan) that the config can take. Every
graph reads the tracker state from the same static buffers and writes the
new state back into them as its last operations, so replaying a graph
advances the tracker in place. The graphs share one memory pool and are
never replayed at once.

A replay does not call the kernel wrappers, so their launch counts would
stand still: each graph records what its capture added to the counts (the
capture launches nothing) and adds it again on each replay. Warm-up launches
are not counted.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, Iterable

import torch

from vitparticlefiltertracker_tpu_torch.filters.particle import PFState, StepNoise
from vitparticlefiltertracker_tpu_torch.ops import attention
from vitparticlefiltertracker_tpu_torch.ops import patchify_window

# Each kernel wrapper with the name of its by-shape Counter.
_COUNTED = ((attention.flash_attention, "shapes"), (patchify_window.gather_patchify_window, "sizes"))


def read_counts() -> list[tuple[int, Counter]]:
    """The kernel wrappers' launch counts, copied."""
    return [(f.launches, Counter(getattr(f, by))) for f, by in _COUNTED]


def restore_counts(saved: list[tuple[int, Counter]]) -> None:
    for (f, by), (launches, by_shape) in zip(_COUNTED, saved):
        f.launches = launches
        setattr(f, by, Counter(by_shape))


def add_counts(delta: list[tuple[int, Counter]]) -> None:
    for (f, by), (launches, by_shape) in zip(_COUNTED, delta):
        f.launches += launches
        getattr(f, by).update(by_shape)


def _delta(before, after) -> list[tuple[int, Counter]]:
    return [(la - lb, ca - cb) for (lb, cb), (la, ca) in zip(before, after)]


def state_leaves(state) -> list[torch.Tensor]:
    """A TrackerState's tensors in field order (the particle state's two first)."""
    out = []
    for x in state:
        out.extend(x if isinstance(x, PFState) else (x,))
    return out


def clone_state(state):
    """A copy of a TrackerState in buffers of its own (leaves that alias one
    another, as init's template and anchor do, get one buffer each)."""
    return type(state)(*(PFState(*(y.clone() for y in x)) if isinstance(x, PFState) else x.clone()
                         for x in state))


def copy_state_(dst, src) -> None:
    """Write a TrackerState's values into another's buffers, leaf by leaf."""
    for d, s in zip(state_leaves(dst), state_leaves(src)):
        if d is not s:
            d.copy_(s)


# body(state, frame, noise, reseed, probe, scan) -> (new state, [12 K] f32 row)
StepBody = Callable[..., tuple[object, torch.Tensor]]


class StepGraphs:
    """The graphs of one frame shape and dtype over the static `state`.

    body: the step; it returns the new state and a [12 K] f32 row (the
    packed TrackOutput of the K filters, then their lost flags and lost
    counts; K = 1 without banks), and must be capturable: no host read and
    no copy from host memory. lead: the state's leading axes, () or (K,).
    """

    def __init__(self, body: StepBody, state, frame_shape, frame_dtype: torch.dtype, n: int,
                 keys: Iterable[tuple[bool, bool]], pool, lead: tuple[int, ...] = ()):
        dev = state.center.device
        self.frame = torch.zeros(frame_shape, dtype=frame_dtype, device=dev)
        self.noise = StepNoise(pos=torch.zeros((*lead, n, 2), device=dev), vel=torch.zeros((*lead, n, 2), device=dev),
                               scale=torch.zeros((*lead, n), device=dev), resample_u=torch.zeros(lead, device=dev))
        self.reseed = torch.zeros((*lead, n, 2), device=dev)
        self.graphs: dict[tuple[bool, bool], torch.cuda.CUDAGraph] = {}
        self.rows: dict[tuple[bool, bool], torch.Tensor] = {}
        self.counts: dict[tuple[bool, bool], list] = {}
        stream = torch.cuda.Stream(dev)
        for key in keys:
            probe, scan = key
            before = read_counts()
            # Warm-up on a copy of the state, on the capture stream (cuBLAS
            # workspaces, the kernels' first-use build and load, the
            # per-frame-size constants), then the capture itself.
            warm = clone_state(state)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                body(warm, self.frame, self.noise, self.reseed, probe, scan)
            torch.cuda.current_stream(dev).wait_stream(stream)
            del warm
            restore_counts(before)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool, stream=stream):
                new, row = body(state, self.frame, self.noise, self.reseed, probe, scan)
                copy_state_(state, new)
            self.counts[key] = _delta(before, read_counts())
            restore_counts(before)
            self.graphs[key] = graph
            self.rows[key] = row

    def replay(self, key: tuple[bool, bool]) -> torch.Tensor:
        """Run the step of branch `key` on the current stream -> its [12 K]
        row, a buffer the next replay of that graph overwrites."""
        self.graphs[key].replay()
        add_counts(self.counts[key])
        return self.rows[key]
