"""Multi-object tracking: K independent filter banks in one batched step —
the port of the JAX package's ``runtime/banked.py``.

The JAX package gets its banks from ``jax.vmap`` of the single-object step.
The port's kernels are ``ctypes`` calls that ``torch.func.vmap`` cannot see
through, so the bank axis is written out instead: the tracker's one step
(``runtime/tracker.py:build_tracker_fns``) takes state with a leading K on
every leaf, and runs one ViT forward for all K search windows (K1 at
[K, 12, 196, 64] in dense mode; in crop mode one K2 launch over the K
windows and one forward of all K * N crops). Two forms:

- ``MultiTracker``: K filters on one shared frame (surveillance: K objects).
- ``MultiStreamTracker``: K filters, each on its own frame (K videos served
  in lockstep).

Bank k draws the noise that a single Tracker with seed k draws at its own
frame index. On the card each step of either is one replay of a captured
CUDA graph (runtime/step_graph.py), as for the single-object Tracker; the
host keeps each bank's seed and frame index, and the graph's IF nodes run a
lost-only branch for all banks when any bank's flag on the card needs it.

On a mesh (runtime.mesh_*, parallel/mesh.py) the banks ride "bank": rank b
holds the contiguous banks ``bank_slice`` gives it, seeded with their
global indices, so each bank draws what it draws without a mesh; inside a
bank the particle and model axes work as for the single Tracker; the
packed rows are all-gathered into the [K, ...] layout, so every rank
returns every bank.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from vitparticlefiltertracker_tpu_torch.config import Config
from vitparticlefiltertracker_tpu_torch.parallel.mesh import Mesh, bank_slice, make_mesh
from vitparticlefiltertracker_tpu_torch.runtime.step_graph import clone_state, state_leaves
from vitparticlefiltertracker_tpu_torch.runtime.tracker import (
    PFState,
    TrackerState,
    _Fns,
    _GraphStepper,
    build_tracker_fns,
)
from vitparticlefiltertracker_tpu_torch.utils.platform import resolve_device


def banked_bboxes(init_bbox, banks: int) -> np.ndarray:
    """[K, 4] bboxes for K banks: tile a single box; pass through (and
    validate) per-target boxes a multi-object source already provides."""
    b = np.asarray(init_bbox, np.float32)
    if b.ndim == 1:
        return np.tile(b, (banks, 1))
    if b.shape != (banks, 4):
        raise ValueError(
            f"source provides {b.shape[0]} init bboxes but runtime.banks="
            f"{banks}; set runtime.banks to match the source's target count"
        )
    return b


def _checked_fns(cfg: Config, width: int) -> _Fns:
    """build_tracker_fns, with init held to `width` boxes and seeds."""
    fns = build_tracker_fns(cfg)

    def init(prm, frame, bboxes: torch.Tensor, seeds, cloud=None):
        seeds = [int(s) for s in (seeds.tolist() if isinstance(seeds, torch.Tensor) else seeds)]
        if tuple(bboxes.shape) != (width, 4) or len(seeds) != width:
            raise ValueError(f"expected [{width}, 4] boxes and {width} seeds, got {tuple(bboxes.shape)} "
                             f"and {len(seeds)}")
        return fns.init(prm, frame, bboxes, seeds, cloud=cloud)

    return fns._replace(init=init)


def build_banked_fns(cfg: Config) -> _Fns:
    """(init, step, track_clip) over banked state: leading axis K =
    runtime.banks on every state leaf, the tracker's own step.

    init(params, frame [H, W, 3], bboxes [K, 4], seeds [K], cloud=None) -> state
    step(params, state, frame [H, W, 3], noise=None, ...) -> (state, TrackOutput [K])
    track_clip(params, state, frames [T, H, W, 3], ...) -> (state, TrackOutput [T, K])

    One weight set serves all K filters; the K search windows go through one
    ViT forward at B = K.
    """
    return _checked_fns(cfg.resolve(), cfg.runtime.banks)


def build_multistream_fns(cfg: Config, num_streams: int = 1) -> _Fns:
    """Multi-stream serving: K independent videos, one batched step. Unlike
    the banked fns (K filters on one shared frame), each bank gets its own
    frame.

    init(params, frames [K, H, W, 3], bboxes [K, 4], seeds [K], cloud=None) -> state
    step(params, state, frames [K, H, W, 3], noise=None, ...) -> (state, TrackOutput [K])
    track_clip(params, state, clips [T, K, H, W, 3], ...) -> (state, TrackOutput [T, K])
    """
    return _checked_fns(cfg.resolve(), num_streams)


def _config_mesh(cfg: Config, mesh: Mesh | None, width: int, what: str, device) -> tuple[Mesh | None, slice]:
    """The banked tracker's mesh (the given one, or make_mesh from
    runtime.mesh_* when their product is above 1) and this rank's banks of
    `width`; ValueError when the bank axis does not divide them."""
    r = cfg.runtime
    if mesh is None and r.mesh_banks * r.mesh_particles * r.mesh_model > 1:
        mesh = make_mesh(r.mesh_banks, r.mesh_particles, r.mesh_model, device=resolve_device(device))
    if mesh is None:
        return None, slice(0, width)
    return mesh, bank_slice(mesh, width, what)


class MultiTracker(_GraphStepper):
    """K-object tracker over one shared frame stream (K = runtime.banks):
    init(frame, bboxes [K, 4]); step(frame) -> K records; reinit_bank; the
    device-side steps .step_device, .step_packed and .track_clip_device
    (outputs with a leading K, the packed row in the JAX package's layout).

    device: "cuda" (default) or "cpu"; graphs=False runs the step eagerly
    on the card. Each step is one graph replay on the card (see
    runtime/tracker.py:_GraphStepper); ``step`` waits once a step, for its
    records. mesh: a parallel.mesh.Mesh, or None, when runtime.mesh_*
    makes one; every rank calls the same methods on the same inputs.
    """

    def __init__(self, cfg: Config, vit_params=None, device="cuda", graphs: bool = True, mesh: Mesh | None = None):
        cfg.resolve()
        self.banks = cfg.runtime.banks
        mesh, self._mine = _config_mesh(cfg, mesh, self.banks, "runtime.banks", device)
        width = self._mine.stop - self._mine.start
        self._setup(cfg, vit_params, device, graphs, (width,), mesh, banks=self.banks)

    def init(self, frame, bboxes) -> None:
        """bboxes [K, 4], bank k seeded with filter.seed + k."""
        seeds = [int(self.cfg.filter.seed) + k for k in range(self.banks)][self._mine]
        self._start(frame, np.asarray(bboxes, np.float32).reshape(self.banks, 4)[self._mine], seeds)

    def step(self, frame) -> list[dict[str, Any]]:
        """Track one frame for every bank -> one host-side record a bank
        (the JAX package's keys), after one wait for the card."""
        t0 = time.perf_counter()
        out = self._read(self._all_banks(self._advance(self.stage(frame))))
        ms = (time.perf_counter() - t0) * 1e3
        k = self.banks
        v = out.astype(np.float64)
        return [
            {
                "bank": i,
                "position": [float(v[2 * i]), float(v[2 * i + 1])],
                "box": [float(v[2 * k + 2 * i]), float(v[2 * k + 2 * i + 1])],
                "conf": float(v[6 * k + i]),
                "ess": float(v[7 * k + i]),
                "resampled": bool(v[8 * k + i]),
                "lost": bool(v[9 * k + i]),
                "step_ms": ms,
            }
            for i in range(k)
        ]

    def reinit_bank(self, k: int, frame, bbox, seed: int | None = None) -> None:
        """Re-target bank k mid-stream (objects enter and leave): a fresh
        single-object state from (frame, bbox), seed filter.seed + k unless
        given, written into row k of the banked state; bank k restarts at
        frame index 0 and the other banks are untouched. On the card the
        fresh row (lost flag and lost count cleared) is copied into the
        graph's static buffers, which the graph and its branch predicates
        read in place. On a mesh every rank calls it, and the ranks that
        hold bank k re-target it."""
        if self._state is None:
            raise RuntimeError("call init() first")
        if not 0 <= k < self.banks:
            raise IndexError(f"bank {k} out of range [0, {self.banks})")
        seed = int(self.cfg.filter.seed) + k if seed is None else int(seed)
        if not self._mine.start <= k < self._mine.stop:
            return
        k -= self._mine.start  # this rank's row
        bbox_t = torch.as_tensor(np.asarray(bbox, np.float32).reshape(4), device=self.device)
        fresh = state_leaves(self._fns.init(self.vit_params, self._frame(frame), bbox_t, seed))
        if self.graphs:
            for dst, src in zip(state_leaves(self._static), fresh):
                dst[k].copy_(src)
            if not self._donate:
                self._state = clone_state(self._static)
        else:
            leaves = [x.clone() for x in state_leaves(self._state)]
            for dst, src in zip(leaves, fresh):
                dst[k] = src
            self._state = TrackerState(PFState(*leaves[:2]), *leaves[2:])
        self._seed[k], self._frame_idx[k] = seed, 0


class MultiStreamTracker(_GraphStepper):
    """K independent video streams served in lockstep, one batched step a
    frame batch [K, H, W, 3]: the same per-stream semantics as K separate
    Trackers with seeds filter.seed + i (the same weights). init(frames,
    bboxes, seeds=None); .step_device, .step_packed and .track_clips_device
    (clips [T, K, H, W, 3]). runtime.donate_state and graphs as for
    MultiTracker.
    """

    def __init__(self, cfg: Config, num_streams: int, vit_params=None, device="cuda", graphs: bool = True,
                 mesh: Mesh | None = None):
        cfg.resolve()
        self.k = num_streams
        mesh, mine = _config_mesh(cfg, mesh, num_streams, "num_streams", device)
        self._setup(cfg, vit_params, device, graphs, (mine.stop - mine.start,), mesh, banks=num_streams)
        if mesh is not None:
            self._frame_sl = mine  # each frame batch [K, ...]: this rank's streams

    def init(self, frames, bboxes, seeds=None) -> None:
        """frames [K, H, W, 3]; bboxes [K, 4]; seeds [K] (default seed + i)."""
        if seeds is None:
            seeds = [int(self.cfg.filter.seed) + i for i in range(self.k)]
        mine = self._frame_sl or slice(0, self.k)
        self._start(frames[mine], np.asarray(bboxes, np.float32).reshape(self.k, 4)[mine],
                    [int(s) for s in seeds][mine])

    def track_clips_device(self, clips_dev: torch.Tensor):
        """clips_dev [T, K, H, W, 3] -> TrackOutput [T, K]: T batched steps."""
        return self.track_clip_device(clips_dev)
