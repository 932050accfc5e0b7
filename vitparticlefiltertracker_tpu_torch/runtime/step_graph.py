"""A tracker step captured as one CUDA graph and replayed: the port's
counterpart of the JAX package's one jitted, state-donating step executable.

``StepGraphs`` holds, for one input shape and dtype, the static buffers a
step reads (given by the caller: its inputs, the frame or a chunk's stacked
ROI views and the global view that several graphs share; the noise keys,
[K, 2] int64 (seed, frame index) a bank, K = 1 for one filter, one buffer
that all of a tracker's graphs share) and one graph. The graph's first node
draws the step's noise on the card from the keys (ops/step_noise.py,
csrc/step_noise.cu: one kernel for every bank, the same bits as
filters/particle.py draw_step_noise) into buffers of its own, with a
leading K axis for K banks: frame [H, W, 3] shared or [K, H, W, 3], noise
[K, N, ...], and where global re-detection is configured the reseed normals
[K, N, 2]; a chunk of C steps adds a leading C axis and draws frame index +
c for step c. The host draws nothing: it copies its keys in before each
replay, as it fills the inputs (runtime/tracker.py ``_dispatch``). The graph
reads the tracker state from static buffers and writes the new state back
into them as its last operations, so replaying it advances the tracker in
place.

The step's two lost-only branches (the probe and the global re-detection
scan; ``lax.cond`` in the JAX package) are CUDA conditional (IF) nodes in
that graph: the step computes each predicate on the card, a one-thread
kernel sets the node's handle from it, and the branch's body runs on a
replay only where it is true (``csrc/graph_if.cu``). So the host chooses
nothing and reads nothing back. A branch writes its results into buffers
that the step filled with the not-taken values before the node. The bodies
are captured on a stream of their own, into a memory pool of their own.

A replay does not call the kernel wrappers, so their launch counts would
stand still: the graph records what its capture added to the counts outside
the branches (the capture launches nothing) and adds it again on each
replay. The noise kernel, the mesh's collectives (parallel/mesh.py) and
the "model" group's peer all-reduce kernel (ops/peer_allreduce.py) are
counted the same way: they are captured on the capture stream (or a
body's stream) like any kernel, after the warm-up has run each of them once
eagerly (the peer kernel's buffers grow there, never inside a capture).
Each branch body also adds one to a counter on the card when it runs;
``settle_counts`` reads those counters (one wait) and adds each body's
launches once for every time it ran. Warm-up launches are not counted.
"""

from __future__ import annotations

import weakref
from collections import Counter
from typing import Callable

import torch

from vitparticlefiltertracker_tpu_torch.filters.particle import PFState, StepNoise
from vitparticlefiltertracker_tpu_torch.ops import attention
from vitparticlefiltertracker_tpu_torch.ops import patchify_window, peer_allreduce, prenorm_junction, step_noise, swiglu
from vitparticlefiltertracker_tpu_torch.parallel import mesh

# Each counted call (the kernel wrappers, then the mesh's collectives) with
# the name of its by-shape Counter.
_COUNTED = ((attention.flash_attention, "shapes"), (patchify_window.gather_patchify_window, "sizes"),
            (mesh.all_gather, "shapes"), (mesh.all_reduce, "shapes"), (peer_allreduce.peer_all_reduce, "shapes"),
            (step_noise.step_noise, "shapes"), (swiglu.swiglu, "shapes"),
            (prenorm_junction.prenorm_junction, "shapes"))


def read_counts() -> list[tuple[int, Counter]]:
    """The kernel wrappers' launch counts, copied."""
    return [(f.launches, Counter(getattr(f, by))) for f, by in _COUNTED]


def restore_counts(saved: list[tuple[int, Counter]]) -> None:
    for (f, by), (launches, by_shape) in zip(_COUNTED, saved):
        f.launches = launches
        setattr(f, by, Counter(by_shape))


def add_counts(delta: list[tuple[int, Counter]], times: int = 1) -> None:
    if times == 0:
        return
    for (f, by), (launches, by_shape) in zip(_COUNTED, delta):
        f.launches += launches * times
        getattr(f, by).update({k: v * times for k, v in by_shape.items()})


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


# run_if(pred, body): run body() where the 0-d bool tensor `pred` holds.
RunIf = Callable[[torch.Tensor, Callable[[], None]], None]


def run_if_host(pred: torch.Tensor, body: Callable[[], None]) -> None:
    """The eager step's branch: the host reads the predicate (a wait on the
    card) and runs the body where it holds."""
    if bool(pred):
        body()


def run_if_always(pred: torch.Tensor, body: Callable[[], None]) -> None:
    """Every branch on every step; the step's merges keep the not-taken
    values where the predicate is false (what warm-up runs)."""
    body()


# body(state, *inputs, noise, reseed, run_if) -> (new state, f32 rows)
StepBody = Callable[..., tuple[object, torch.Tensor]]

_MAX_BRANCHES = 2  # a step's: the probe and the scan


class _Tally:
    """One StepGraphs' branch counters: how often each body ran (`taken`,
    on the card), the launches each adds, and the runs already counted. It
    outlives its graphs until settle_counts has counted it after they are
    gone, so the branch launches of a tracker dropped before a settle count."""

    def __init__(self, owner: "StepGraphs", taken: torch.Tensor):
        self.owner = weakref.ref(owner)
        self.taken = taken
        self.branch_counts: list[list] = []
        self.settled = [0] * taken.numel()

    def settle(self) -> None:
        if not self.branch_counts:
            return
        taken = self.taken.tolist()
        for i, delta in enumerate(self.branch_counts):
            add_counts(delta, taken[i] - self.settled[i])
        self.settled = taken


# Every StepGraphs' tally, until counted after its graphs are gone.
_TALLIES: list[_Tally] = []


def settle_counts() -> None:
    """Add to the kernel wrappers' counts the launches of every branch body
    that ran since the last call, also in graphs no longer alive (reads each
    graph's counters: one wait)."""
    for tally in list(_TALLIES):
        tally.settle()
        if tally.owner() is None:
            _TALLIES.remove(tally)


def capture_if(pred: torch.Tensor, body: Callable[[], None], body_stream: torch.cuda.Stream, body_pool) -> None:
    """Inside a CUDA graph capture on the current stream: capture body() as
    an IF node on `pred` (a 0-d bool on the card, computed on the current
    stream), its work on `body_stream` and its allocations in the memory
    pool `body_pool` (a graph_pool_handle() of its own: the capture's pool
    is keyed to the capture's stream). Each call holds one reference to the
    pool, which the caller releases (torch._C._cuda_releasePool) once the
    graph is gone."""
    from vitparticlefiltertracker_tpu_torch.ops._build import graph_if_library

    lib = graph_if_library()
    dev = pred.device
    pred = pred.reshape(()).to(torch.bool)
    rc = lib.vpt_if_begin(torch.cuda.current_stream(dev).cuda_stream, pred.data_ptr(), body_stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"vpt_if_begin failed with code {rc}")
    try:
        with torch.cuda.stream(body_stream):
            torch._C._cuda_beginAllocateCurrentStreamToPool(dev.index, body_pool)
            try:
                body()
            finally:
                torch._C._cuda_endAllocateToPool(dev.index, body_pool)
    finally:
        rc = lib.vpt_if_end(body_stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"vpt_if_end failed with code {rc}")


def _release_pool(device_index: int, pool, refs: list[int]) -> None:
    for _ in range(refs[0]):
        torch._C._cuda_releasePool(device_index, pool)


class StepGraphs:
    """The graph of one input shape and dtype over the static `state`.

    body: the step, called as body(state, *inputs, noise, reseed, run_if);
    it returns the new state and its f32 rows (the packed TrackOutput: [10 K]
    for the K filters of one step, K = 1 without banks; [C, 10] for a chunk
    of C steps), and must be capturable: no host read and no copy from host
    memory. It runs its lost-only branches through the run_if it is given.
    inputs: the static input buffers, which the caller fills before each
    replay. keys: the [K, 2] int64 noise keys, which the caller also fills
    before each replay. lead: the state's leading axes, () or (K,). steps:
    None for one step, C for a chunk of C steps (the noise and reseed
    buffers then have a leading C, and the graph up to two branches a step).
    reseed: whether the graph draws the re-detection reseed normals (else
    the body gets None).
    """

    def __init__(self, body: StepBody, state, inputs: tuple[torch.Tensor, ...], keys: torch.Tensor, n: int, pool,
                 lead: tuple[int, ...] = (), steps: int | None = None, reseed: bool = False):
        dev = state.center.device
        self._dev = dev
        self.inputs = inputs
        per = lead if steps is None else (steps, *lead)
        self.keys = keys
        self.noise = StepNoise(pos=torch.zeros((*per, n, 2), device=dev), vel=torch.zeros((*per, n, 2), device=dev),
                               scale=torch.zeros((*per, n), device=dev), resample_u=torch.zeros(per, device=dev))
        self.reseed = torch.zeros((*per, n, 2), device=dev) if reseed else None
        self._max_branches = _MAX_BRANCHES * (steps or 1)
        # Branch bodies: their stream and memory pool, how often each ran
        # (on the card), and the launches each capture added.
        self._body_stream = torch.cuda.Stream(dev)
        self._body_pool = torch.cuda.graph_pool_handle()
        self._pool_refs = [0]
        self.taken = torch.zeros(self._max_branches, dtype=torch.int64, device=dev)
        self._tally = _Tally(self, self.taken)
        self.branch_counts = self._tally.branch_counts
        stream = torch.cuda.Stream(dev)
        before = read_counts()
        # Warm-up on a copy of the state, on the capture stream, with every
        # branch run on the bodies' stream (cuBLAS workspaces of both
        # streams, the kernels' first-use build and load, the per-frame-size
        # constants), then the capture itself.
        warm = clone_state(state)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            step_noise.step_noise(keys, self.noise, self.reseed)
            body(warm, *inputs, self.noise, self.reseed, self._warm_if)
        torch.cuda.current_stream(dev).wait_stream(stream)
        del warm
        restore_counts(before)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool, stream=stream):
            step_noise.step_noise(keys, self.noise, self.reseed)
            new, self.row = body(state, *inputs, self.noise, self.reseed, self._capture_if)
            copy_state_(state, new)
        total = _delta(before, read_counts())
        self.counts = total
        for branch in self.branch_counts:
            self.counts = _delta(branch, self.counts)
        restore_counts(before)
        if self._pool_refs[0]:
            weakref.finalize(self, _release_pool, dev.index, self._body_pool, self._pool_refs)
        if any(t.owner() is None for t in _TALLIES):
            settle_counts()  # count and drop the tallies of graphs gone since the last settle
        _TALLIES.append(self._tally)

    def _warm_if(self, pred: torch.Tensor, body: Callable[[], None]) -> None:
        from vitparticlefiltertracker_tpu_torch.ops._build import graph_if_library

        rc = graph_if_library().vpt_if_load()
        if rc != 0:
            raise RuntimeError(f"vpt_if_load failed with code {rc}")
        current = torch.cuda.current_stream(self._dev)
        self._body_stream.wait_stream(current)
        with torch.cuda.stream(self._body_stream):
            body()
        current.wait_stream(self._body_stream)

    def _capture_if(self, pred: torch.Tensor, body: Callable[[], None]) -> None:
        """capture_if, counting the body's launches and its runs."""
        i = len(self.branch_counts)
        if i >= self._max_branches:
            raise RuntimeError(f"a step has at most {_MAX_BRANCHES} branches")
        before = read_counts()

        def counted():
            body()
            self.taken[i:i + 1].add_(1)

        self._pool_refs[0] += 1
        capture_if(pred, counted, self._body_stream, self._body_pool)
        self.branch_counts.append(_delta(before, read_counts()))

    def replay(self) -> torch.Tensor:
        """Run the step on the current stream -> its rows, a buffer the next
        replay overwrites."""
        self.graph.replay()
        add_counts(self.counts)
        return self.row
