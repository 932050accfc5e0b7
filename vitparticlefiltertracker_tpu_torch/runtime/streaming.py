"""Streaming decode -> track pipeline: the port of the JAX package's
``runtime/streaming.py``.

A producer thread decodes frames into a bounded queue (``FramePump``). The
submitting thread stages each frame in pinned host memory and enqueues one
step (``step_packed``: one graph replay on the card, whose output is one
packed f32 row); it never waits for the card mid-stream. Rows are read back
in windows of ``readback_window`` frames by a drainer thread, one stacked
device-to-host copy a window, so the device queue stays full.

ROI streaming (``roi_px > 0``): the step samples only a search window, so
the host ships a crop around the predicted target and, every few frames, a
decimated whole frame for global re-detection (``RoiShipper``), both
through the pinned staging slots; the decimated view stays on the card in
between. With a native source (io/native.py) only those rectangles or
resampled views are ever read. ``chunk > 1`` tracks C frames a dispatch
(``step_chunk_packed``: one graph replay on the card), and steer workers
read the newest rows back to aim the next crops.

Threads and streams. torch's current stream is per thread: the submitting
thread records an event on its stream after a dispatch, and a reader (the
drainer, a steer worker) makes its own stream wait for that event before it
copies rows to the host, then waits for its own stream only. The rows are
copies that later steps leave alone (``step_packed``), and each is marked
as used on the reader's stream. The pinned staging slots (the tracker's
``staging``) are deep enough for every array that can be in flight while a
reader or the flow control holds the submitter back; a wait for a slot is
counted (``staging_waits``).

Spans and counters (utils/profiling.py ``SPANS``) time each part where it
runs: the submitting thread's ``stream.ingest``, ``stream.submit`` (a
dispatch: staging, the noise keys, launch, ROI shipping, a mesh's messages),
``stream.handover``, ``stream.flow`` and ``stream.drain``; the drainer's
``drain.window`` and ``frame.hold``; the pump's ``pump.read``; a mesh
follower's ``mesh.wait``. ``stream_track`` returns its run's share.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from vitparticlefiltertracker_tpu_torch.ops.image import FrameView, StreamFrame
from vitparticlefiltertracker_tpu_torch.runtime.tracker import pack_track_output, unpack_track_output
from vitparticlefiltertracker_tpu_torch.utils.profiling import SPANS


class OutputPacker:
    """A TrackOutput as one flat f32 row and back: pack_track_output's
    layout, [10] for one filter, [10 K] for K banks (all K positions, then
    all K boxes, ...). ``unpack`` gives numpy fields of the JAX package's
    OutputPacker shapes: position [2] or [K, 2], conf [] or [K], and the
    flags as bools; a chunk's rows [C, 10] give fields with a leading C."""

    def __init__(self, banks: int | None = None):
        self.banks = banks

    def pack(self, out) -> torch.Tensor:
        return pack_track_output(out)

    def unpack(self, row: np.ndarray):
        fields = unpack_track_output(torch.from_numpy(np.asarray(row, np.float32)), self.banks)
        return type(fields)(*(x.numpy() for x in fields))


def _to_tensor(array: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(array))


class RoiShipper:
    """Host-side ROI extraction for the streaming pipeline.

    The step only samples a search window of a few hundred px around the
    target. The shipper crops a ROI of fixed size around the predicted
    target centre (the newest steered position advanced by its velocity:
    records trail the stream) and ships only that, plus the whole frame
    decimated by `glob_stride` every `glob_every` frames for global
    re-detection; the decimated view stays on the card in between. The step
    on a ROI equals the full-frame step while the search window lies inside
    it (ops/image.py FrameView); a target that escapes it collapses the
    confidence, and global re-detection on the decimated view reseeds.

    roi_out > 0 (native sources only): the ROI span ships as a roi_out²
    bilinear view at the fractional stride span / roi_out (read_view),
    the grid the device's window resample reads.

    stage: how a host array goes to the card (the tracker's ``stage``:
    pinned staging slots on the card); by default a CPU tensor. device: where
    the global view's zero origin lives. Steps read the arrays it returns
    (``ship*``) and copy the global view to the card only when it is not the
    tensor the last step read (Tracker._glob_view). Origins, clamps and the
    fractional stride are the JAX package's numbers, bit for bit.
    """

    def __init__(self, frame_hw: tuple[int, int], roi_px: int, init_center, roi_stride: int = 1,
                 glob_stride: int = 8, glob_every: int = 4, roi_out: int = 0, stage=None, device="cpu"):
        h, w = int(frame_hw[0]), int(frame_hw[1])
        s = max(1, int(roi_stride))
        self._out = int(roi_out)
        if self._out > 0:
            span = min(int(roi_px), h, w)
            self._sv = span / self._out  # the view's fractional stride (fixed)
        else:
            # The span (frame px), clamped to the frame and rounded to a
            # stride multiple, so that the strided slice keeps one shape.
            span = min(int(roi_px), h, w) // s * s
        if span <= 0:
            raise ValueError(f"stream ROI {roi_px}px too small for stride {s}")
        self._h, self._w = h, w
        self._span, self._s = span, s
        self._gs = max(1, int(glob_stride))
        self._glob_every = max(1, int(glob_every))
        self._stage = _to_tensor if stage is None else stage
        self._zero2 = torch.zeros(2, dtype=torch.float32, device=device)
        self._glob: FrameView | None = None  # reused between refreshes
        self._last_pos = np.asarray(init_center, np.float32)
        self._last_vel = np.zeros(2, np.float32)
        self._last_idx = 0
        self._last_lost = False
        self._idx = 0
        # Steer workers call observe() while the submitting thread predicts:
        # (pos, vel, idx) is read and written under a lock, so that an older
        # record never overwrites a newer one and a prediction never mixes
        # two records.
        self._obs_lock = threading.Lock()

    def _predict(self, idx: int) -> np.ndarray:
        """Dead-reckoned target centre at frame `idx` from the newest
        steered observation."""
        with self._obs_lock:
            pos, vel, last = self._last_pos, self._last_vel, self._last_idx
        return pos + vel * max(0, idx - last)

    def _origin(self, idx: int) -> tuple[int, int]:
        """The ROI's top-left corner (frame px) for frame idx, inside the frame."""
        pred = self._predict(idx)
        span = self._span
        ox = int(np.clip(round(pred[0] - span / 2), 0, self._w - span))
        oy = int(np.clip(round(pred[1] - span / 2), 0, self._h - span))
        return ox, oy

    @property
    def shipped_bytes_per_frame(self) -> float:
        """Steady-state bytes shipped to the card a frame."""
        roi = (self._out if self._out else self._span // self._s) ** 2 * 3
        gh, gw = -(-self._h // self._gs), -(-self._w // self._gs)
        return roi + gh * gw * 3 / self._glob_every

    def example(self, dtype=np.uint8) -> StreamFrame:
        """A StreamFrame of one frame shaped as this shipper's (zeros, on
        the host): what Tracker.prepare_stream captures the graphs for."""
        side = self._out if self._out else self._span // self._s
        stride = self._sv if self._out else float(self._s)
        glob = (-(-self._h // self._gs), -(-self._w // self._gs), 3)
        return StreamFrame(track=FrameView(_to_tensor(np.zeros((side, side, 3), dtype)), torch.zeros(2), stride),
                           glob=FrameView(_to_tensor(np.zeros(glob, dtype)), torch.zeros(2), float(self._gs)))

    def _ship_glob(self, pixels: np.ndarray) -> None:
        self._glob = FrameView(self._stage(pixels), self._zero2, float(self._gs))

    def _track(self, pixels: np.ndarray, origin, stride: float) -> FrameView:
        return FrameView(self._stage(pixels), self._stage(np.asarray(origin, np.float32)), stride)

    def ship(self, frame: np.ndarray, idx: int | None = None) -> StreamFrame:
        """Ship one frame's ROI. `idx` is the record's frame index (what
        observe() later sees for this frame); without it an internal counter
        is used, and dead reckoning runs one frame short."""
        if idx is None:
            idx = self._idx
        self._idx = idx + 1
        with SPANS.span("roi.ship"):
            ox, oy = self._origin(idx)
            span, s = self._span, self._s
            roi = frame[oy : oy + span : s, ox : ox + span : s]
            if self._glob is None or idx % self._glob_every == 0:
                self._ship_glob(frame[:: self._gs, :: self._gs])
            return StreamFrame(track=self._track(roi, [ox, oy], float(s)), glob=self._glob)

    def _read_native(self, reader, idx: int, ox: int, oy: int) -> tuple[np.ndarray, list, float]:
        """One ROI read from a native source -> (pixels, origin, stride)."""
        if self._out:
            # A resampled view: sample centres inset half a stride, so the
            # out² grid covers [o, o + span] on each axis.
            sv = self._sv
            vx, vy = ox + 0.5 * sv, oy + 0.5 * sv
            return reader.read_view(idx, vx, vy, sv, self._out), [vx, vy], sv
        return reader.read_rect(idx, ox, oy, self._span, self._span, self._s), [ox, oy], float(self._s)

    def ship_native(self, reader, frame_idx: int) -> StreamFrame:
        """A ROI read straight from a native source (read_rect, or read_view
        with roi_out): the whole frame never reaches Python."""
        self._idx = frame_idx  # the glob cadence follows the frame index
        with SPANS.span("roi.ship"):
            ox, oy = self._origin(frame_idx)
            track = self._track(*self._read_native(reader, frame_idx, ox, oy))
            if self._glob is None or frame_idx % self._glob_every == 0:
                self._ship_glob(reader.read_rect(frame_idx, 0, 0, self._w, self._h, self._gs))
            return StreamFrame(track=track, glob=self._glob)

    def _chunk_views(self, idxs, read_one) -> StreamFrame:
        """C ROI reads stacked into one StreamFrame (pixels [C, h, w, 3],
        origins [C, 2]): one copy to the card for the crops, one for the
        origins, one dispatch. Every centre extrapolates from the same
        newest observation, as the one-frame path does between steering
        updates."""
        pxs, orgs = [], []
        for idx in idxs:
            px, org, sv = read_one(idx, *self._origin(idx))
            pxs.append(px)
            orgs.append(org)
        return StreamFrame(track=self._track(np.stack(pxs), orgs, sv), glob=self._glob)

    def ship_native_chunk(self, reader, idxs) -> StreamFrame:
        """ship_native for C frames: C native ROI reads, one stacked copy."""
        self._idx = idxs[-1]
        with SPANS.span("roi.ship"):
            if self._glob is None or any(i % self._glob_every == 0 for i in idxs):
                self._ship_glob(reader.read_rect(idxs[0], 0, 0, self._w, self._h, self._gs))
            return self._chunk_views(idxs, lambda idx, ox, oy: self._read_native(reader, idx, ox, oy))

    def ship_chunk(self, frames, idxs) -> StreamFrame:
        """ship for C numpy frames: C host crops, one stacked copy."""
        self._idx = idxs[-1]
        frame_of = dict(zip(idxs, frames))
        span, s = self._span, self._s

        def read_one(idx, ox, oy):
            return frame_of[idx][oy : oy + span : s, ox : ox + span : s], [ox, oy], float(s)

        with SPANS.span("roi.ship"):
            if self._glob is None or any(i % self._glob_every == 0 for i in idxs):
                self._ship_glob(frames[-1][:: self._gs, :: self._gs])
            return self._chunk_views(idxs, read_one)

    def observe(self, rec: dict) -> None:
        """Feed a record read back (it trails the stream) to steer the ROI.
        A record older than the newest seen is ignored (steer workers run
        concurrently); the check and the update are one step under the
        lock."""
        with self._obs_lock:
            if int(rec["frame"]) < self._last_idx:
                return
            self._last_pos = np.asarray(rec["position"], np.float32)
            self._last_vel = np.asarray(rec.get("velocity", (0.0, 0.0)), np.float32)
            self._last_idx = int(rec["frame"])
            if "lost" in rec:
                self._last_lost = bool(rec["lost"])

    @property
    def observed_idx(self) -> int:
        """The newest frame index whose estimate has steered the ROI."""
        return self._last_idx

    @property
    def lost_seen(self) -> bool:
        """True while the newest steered record reports the tracker lost:
        the stream loop then caps its submit-ahead at one chunk, so that a
        re-detection's jump re-aims the crop within about a chunk
        (runtime.stream_lost_throttle)."""
        return self._last_lost


class FramePump:
    """Producer thread: decode/generate frames into a bounded queue.

    The queue bound provides backpressure so a fast decoder can't overrun
    host memory; `depth` ~ 2-4 is enough to hide decode jitter.

    The pump is its own (thread-safe) iterator: `__next__` is a single
    atomic `queue.get`, so several consumer threads may drain one pump and
    partition the stream exactly. The end-of-stream sentinel is re-enqueued
    on observation so every consumer sees StopIteration, and a producer
    error is raised in one consumer only.
    """

    _SENTINEL = object()

    def __init__(self, source: Iterable[np.ndarray], depth: int = 3):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._thread = threading.Thread(target=self._run, args=(source,), daemon=True)
        self._err: BaseException | None = None
        self._err_raised = False
        self._err_lock = threading.Lock()
        self._thread.start()

    def _run(self, source) -> None:
        try:
            frames, i = iter(source), 0
            while True:
                with SPANS.span("pump.read", i):
                    frame = next(frames, self._SENTINEL)
                if frame is self._SENTINEL:
                    break
                self._q.put(frame)
                i += 1
        except BaseException as e:  # surfaced on the consumer side
            self._err = e
        finally:
            self._q.put(self._SENTINEL)

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        item = self._q.get()
        if item is self._SENTINEL:
            # Put the sentinel back so every other consumer also stops (the
            # queue has room: the producer is done).
            self._q.put(self._SENTINEL)
            if self._err is not None:
                with self._err_lock:
                    if not self._err_raised:  # raise once, not per consumer
                        self._err_raised = True
                        raise self._err
            raise StopIteration
        return item


def _complete(tracker) -> None:
    """Wait for every step submitted on this thread's stream: one stream
    synchronize on the card, nothing on the CPU."""
    if tracker.device.type == "cuda":
        torch.cuda.current_stream(tracker.device).synchronize()


def _read_row(row: torch.Tensor, event, stream, bufs: dict) -> np.ndarray:
    """One packed row (or a chunk's rows) on the host. On the card: `stream`
    waits for `event` (recorded after the row's dispatch on the submitting
    thread's stream), copies the row into a pinned buffer of this reader's,
    and this thread waits for `stream` alone."""
    if stream is None:
        return row.numpy()
    with torch.cuda.stream(stream):
        stream.wait_event(event)
        row.record_stream(stream)
        buf = bufs.get(tuple(row.shape))
        if buf is None:
            buf = bufs[tuple(row.shape)] = torch.empty(row.shape, dtype=row.dtype).pin_memory()
        buf.copy_(row, non_blocking=True)
    stream.synchronize()
    return buf.numpy().copy()


# -- one reader for a mesh: rank 0 reads, every rank steps --------------------------

_END, _FRAME, _INIT, _PREPARE, _STEP, _PACKED, _ROI, _CHUNK = range(8)


class MeshFeed:
    """The frames of a stream on a mesh (parallel/mesh.py), read once, by
    rank 0.

    Every rank of a mesh must step on the same frames, and only rank 0 opens
    the source (a camera, the native ring, a video, a pump). Rank 0's
    tracker is wrapped (``leader``): before each dispatch it sends the
    host's decisions (the operation, the dispatch size, whether a new global
    view ships; the end of the stream) to the other ranks
    as a small int64 tensor over the mesh's gloo group (``host_group``), and
    broadcasts the staged input from its device buffer over the mesh's
    device group (``all_group``: NCCL on the card, on the submitting
    stream): the frame, or a ROI StreamFrame's tracking pixels and origins
    and, when a new one ships, its global view. Each of the other ranks
    runs ``follow``: the same calls on its own tracker, each input broadcast
    into a device buffer of its own, so the replays on every rank read the
    same bytes. A follower waits on the host for rank 0's next message and
    never on the card. Rare set-up messages (the init frame's shape and
    boxes, the ROI views' shapes and dispatch sizes) go as objects.
    """

    def __init__(self, mesh):
        import torch.distributed as dist

        self.mesh = mesh
        self.rank = dist.get_rank(mesh.all_group)
        # The span of a host message: rank 0 sends it, the others wait for it.
        self._sent = "mesh.control" if self.rank == 0 else "mesh.wait"
        self._bufs: dict = {}  # (role, shape, dtype) -> this rank's device buffer for the broadcasts
        self._glob = None  # the last global view handed to the tracker (its identity marks a new one)
        self._zero2 = torch.zeros(2, dtype=torch.float32, device=mesh.device)
        self.ended = False

    @staticmethod
    def of(tracker) -> "MeshFeed | None":
        """The feed of a tracker on a mesh (of one rank too: rank 0 then
        broadcasts to itself), else None."""
        mesh = getattr(tracker, "mesh", None)
        return None if mesh is None or mesh.all_group is None else MeshFeed(mesh)

    # -- the wire ------------------------------------------------------------------
    def _control(self, *values) -> list[int]:
        import torch.distributed as dist

        with SPANS.span(self._sent):
            msg = torch.zeros(3, dtype=torch.int64)
            if self.rank == 0:
                msg[: len(values)] = torch.tensor(values, dtype=torch.int64)
            dist.broadcast(msg, src=0, group=self.mesh.host_group)
            return msg.tolist()

    def _object(self, value=None):
        import torch.distributed as dist

        with SPANS.span(self._sent):
            box = [value]
            dist.broadcast_object_list(box, src=0, group=self.mesh.host_group)
            return box[0]

    def _tensor(self, role: str, x: torch.Tensor | None, shape, dtype) -> torch.Tensor:
        """Rank 0's `x` (a host or device tensor) broadcast into every rank's
        device buffer for that role ("frame", "track", "origin", "glob"),
        shape and dtype -> the buffer (valid until the next broadcast for
        its key: the step that reads it is enqueued first, on the same
        stream). A buffer a role: a global view of the ROI's shape must not
        overwrite the ROI pixels broadcast just before it."""
        import torch.distributed as dist

        key = (role, tuple(shape), dtype)
        buf = self._bufs.get(key)
        if buf is None:
            buf = self._bufs[key] = torch.empty(key[1], dtype=dtype, device=self.mesh.device)
        with SPANS.span("mesh.broadcast"):
            if self.rank == 0:
                buf.copy_(x, non_blocking=True)
            dist.broadcast(buf, src=0, group=self.mesh.all_group)
        return buf

    def _view(self, frame: StreamFrame | None, c: int, glob_new: bool, spec: dict) -> StreamFrame:
        """A ROI StreamFrame (C stacked views, or one) on every rank's device."""
        (h, w, ch), tdt, stride = spec["track"]
        gshape, gdt, gstride = spec["glob"]
        track = frame.track if frame is not None else None
        lead = (c,) if c else ()
        pixels = self._tensor("track", track.pixels if track else None, (*lead, h, w, ch), tdt)
        origin = self._tensor("origin", track.origin if track else None, (*lead, 2), torch.float32)
        if glob_new:
            # A new view object over the same buffer, so the tracker copies it in.
            self._glob = self._tensor("glob", frame.glob.pixels if frame else None, gshape, gdt).view(gshape)
        return StreamFrame(FrameView(pixels, origin, stride), FrameView(self._glob, self._zero2, gstride))

    def end(self) -> None:
        """Rank 0: the end of the stream (once)."""
        if self.rank == 0 and not self.ended:
            self.ended = True
            self._control(_END)

    # -- rank 0 ------------------------------------------------------------------
    def leader(self, tracker) -> "_Leader":
        return _Leader(tracker, self)

    # -- the other ranks -------------------------------------------------------------
    def follow(self, tracker) -> dict[str, Any]:
        """Rank r > 0: make rank 0's calls on `tracker` until the end of the
        stream -> {"frames", "dispatches": {size: count}, "spans"} ("spans":
        this run's share of the span recorder's aggregates, as
        stream_track's, ``mesh.wait`` among them)."""
        before = SPANS.totals()
        spec, frame, frames, dispatches = None, None, 0, {}
        while True:
            op, c, glob_new = self._control()
            if op == _END:
                break
            if op == _FRAME:
                frame = self._object()  # (shape, dtype) of the frames from here on
                continue
            if op == _INIT:
                tracker.init(self._tensor("frame", None, *frame), self._object())
                continue
            if op == _PREPARE:
                spec, sizes = self._object()
                tracker.prepare_stream(_example(spec), sizes)
                continue
            if op in (_STEP, _PACKED):
                x = self._tensor("frame", None, *frame)
                (tracker.step if op == _STEP else tracker.step_packed)(x)
            else:
                x = self._view(None, c if op == _CHUNK else 0, bool(glob_new), spec)
                (tracker.step_chunk_packed if op == _CHUNK else tracker.step_packed)(x)
            size = c if op == _CHUNK else 1
            frames += size
            dispatches[size] = dispatches.get(size, 0) + 1
        _complete(tracker)
        return {"frames": frames, "dispatches": dispatches, "spans": SPANS.totals().since(before)["spans"]}


def _spec(frame: StreamFrame) -> dict:
    """A ROI StreamFrame's shapes (of one frame's view), dtypes and strides."""
    t, g = frame.track, frame.glob
    return {"track": (tuple(t.pixels.shape[-3:]), t.pixels.dtype, float(t.stride)),
            "glob": (tuple(g.pixels.shape), g.pixels.dtype, float(g.stride))}


def _example(spec: dict) -> StreamFrame:
    """Zeros on the host shaped as `spec` (what prepare_stream captures for)."""
    (shape, dtype, stride), (gshape, gdtype, gstride) = spec["track"], spec["glob"]
    return StreamFrame(FrameView(torch.zeros(shape, dtype=dtype), torch.zeros(2), stride),
                       FrameView(torch.zeros(gshape, dtype=gdtype), torch.zeros(2), gstride))


class _Leader:
    """Rank 0's tracker on a MeshFeed: each call that steps (or sets up the
    steps) first sends the others its decisions and its inputs, then makes
    the call on the broadcast device buffers. Anything else is the
    tracker's."""

    def __init__(self, tracker, feed: MeshFeed):
        self._tracker, self._feed = tracker, feed
        self._frame = None
        self._spec = None
        self._glob_sent = None  # the host tensor of the global view sent last

    def __getattr__(self, name):
        return getattr(self._tracker, name)

    def _copied(self, *xs) -> None:
        for x in xs:  # staged slots: their copies to the card are enqueued
            self._tracker.staging.copied(x)

    def _frame_dev(self, op: int, frame) -> torch.Tensor:
        """Send `op` and broadcast `frame` (a host array or tensor) -> its
        device buffer. A frame of a new shape or dtype is announced first."""
        x = torch.from_numpy(np.ascontiguousarray(frame)) if isinstance(frame, np.ndarray) else frame
        if self._frame != (tuple(x.shape), x.dtype):
            self._frame = (tuple(x.shape), x.dtype)
            self._feed._control(_FRAME)
            self._feed._object(self._frame)
        self._feed._control(op)
        dev = self._feed._tensor("frame", x, *self._frame)
        self._copied(x)
        return dev

    def init(self, frame, bbox) -> None:
        x = self._frame_dev(_INIT, frame)
        bbox = np.asarray(bbox, np.float32).tolist()
        self._feed._object(bbox)
        self._tracker.init(x, bbox)

    def prepare_stream(self, example: StreamFrame, sizes) -> None:
        self._spec = _spec(example)
        self._feed._control(_PREPARE)
        self._feed._object((self._spec, list(sizes)))
        self._tracker.prepare_stream(example, sizes)

    def step(self, frame):
        return self._tracker.step(self._frame_dev(_STEP, self._tracker.stage(frame)))

    def step_packed(self, x) -> torch.Tensor:
        if not isinstance(x, StreamFrame):
            return self._tracker.step_packed(self._frame_dev(_PACKED, x))
        return self._tracker.step_packed(self._roi(_ROI, x))

    def step_chunk_packed(self, x: StreamFrame) -> torch.Tensor:
        return self._tracker.step_chunk_packed(self._roi(_CHUNK, x))

    def _roi(self, op: int, frame: StreamFrame) -> StreamFrame:
        c = frame.track.pixels.shape[0] if op == _CHUNK else 0
        glob_new = frame.glob.pixels is not self._glob_sent
        self._feed._control(op, c, int(glob_new))
        view = self._feed._view(frame, c, glob_new, self._spec)
        self._glob_sent = frame.glob.pixels
        self._copied(frame.track.pixels, frame.track.origin, *((frame.glob.pixels,) if glob_new else ()))
        return view


def stream_track(
    tracker,
    source: Iterable[np.ndarray],
    init_bbox,
    on_record: Callable[[dict[str, Any]], None] | None = None,
    readback_window: int = 4,
    pump_depth: int = 3,
    roi_px: int = 0,
    roi_stride: int = 1,
    glob_stride: int = 8,
    glob_every: int = 4,
    roi_out: int = 0,
    steer_lag: int = 16,
    chunk: int = 1,
    steer_workers: int = 2,
    chunk_max: int = 0,
    fps_target: float = 60.0,
    lost_throttle: bool = True,
) -> dict[str, Any]:
    """Run the decode -> track pipeline over a source.

    tracker: Tracker, MultiTracker or MultiStreamTracker (init / stage /
    step_packed; step_chunk_packed and prepare_stream for ROI streaming).
    init_bbox: [4], or [K, 4] for K banks or streams. Returns summary stats
    (fps, frames, per-stage breakdown). Records go to on_record with
    `readback_window` frames of latency: one a frame, with K-vector fields
    for K banks or streams (the serve command fans them out per stream).

    Stage accounting (all measured in this run, after the tracker's init,
    from the span recorder, utils/profiling.py ``SPANS``):
      * spans: {name: {"n": count, "s": total seconds, "self_s": the total
        less its child spans'}} of every span taken in the run, on any
        thread (the names are listed in utils/profiling.py). A dispatch is
        one ``stream.submit``, whose children are ``step.stage``,
        ``step.noise``, ``step.launch``, ``roi.ship`` and, on a mesh,
        ``mesh.control`` and ``mesh.broadcast``; ``frame.hold`` is one a
        record, from the end of its dispatch's ``stream.submit`` to its
        call to on_record.
      * ingest_wait_s: time the submitter waited on the decode pump (or the
        native source's frame indices): ``stream.ingest``
      * submit_s: host time shipping and staging frames and enqueueing
        steps (the card runs them later: this is submission cost, not
        device compute): ``stream.submit``
      * readback_s: time handing windows to the drainer (it waits only when
        the drainer is two windows behind; each wait counted in
        drain_blocked) and, with ROI steering, in the flow control's
        sleeps: ``stream.handover`` and ``stream.flow``
      * drain_s: the final flush: the last window's records and the wait
        for every step in flight: ``stream.drain``
      * staging_waits: waits for a pinned staging slot still in flight;
        graph_captures: step or chunk graphs captured during the run (each
        a stall; init captures every shape the stream uses);
        noise_host_draws: banks whose step noise the host drew with a
        torch.Generator (the CPU and the eager step; 0 through the graphs,
        which draw it on the card).
    The seconds are rounded to the millisecond. wall_s (and fps) runs from
    the first frame's read, as in the JAX package; init_s is its share for
    the tracker's init (on the card with the graphs' captures and the
    staging slots' allocation). An operator sees the spans above the
    kernels in the trace ``runtime.profile_dir`` names (the stream and
    serve commands; utils/profiling.py ``trace``).

    roi_px > 0: ROI streaming through a RoiShipper (roi_stride, glob_stride,
    glob_every, roi_out as its arguments; roi_out needs a native source, and
    one filter). A source with ``read_rect`` (io/native.py) is read as
    frame 0 in full, then only rectangles or views. Steer workers
    (`steer_workers` threads) read rows a few frames behind the newest back
    to aim the crops; the submitter stays at most `steer_lag` frames ahead
    of the newest steered frame (one chunk while it is lost, with
    lost_throttle), sleeping on the host, not waiting for the card.

    chunk > 1 (requires roi_px > 0): `chunk` frames a dispatch
    (step_chunk_packed: one graph replay on the card); a tail shorter than
    a chunk goes through the one-frame ROI step. chunk_max > chunk: the
    dispatch size doubles (chunk, 2 chunk, ... up to chunk_max) while the
    rate over the last 2 s stays under fps_target, and halves again above
    1.6 fps_target, at least 4 dispatches apart; the pending window is
    handed over at a switch so that each window holds rows of one size. A
    chunk equals its frames' single steps, so a switch changes no record.
    Every size's graph is captured at init.
    """
    feed = MeshFeed.of(tracker)
    if feed is not None and feed.rank != 0:
        return feed.follow(tracker)  # rank 0 reads the source and sends each dispatch's inputs
    if feed is not None:
        tracker = feed.leader(tracker)
    bbox = np.asarray(init_bbox, np.float32)
    if chunk > 1 and roi_px <= 0:
        raise ValueError("stream chunking (chunk > 1) requires roi_px > 0")
    native_roi = roi_px > 0 and hasattr(source, "read_rect")
    if roi_px > 0:
        if bbox.ndim != 1:
            raise ValueError("ROI streaming supports a single tracker/stream")
        if roi_out > 0 and not native_roi:
            raise ValueError("roi_out (resampled-view ROI) requires a native source (io/native.py read_view)")
    packer = OutputPacker(None if bbox.ndim == 1 else bbox.shape[0])
    cuda = tracker.device.type == "cuda"
    # The dispatch sizes: doublings of `chunk` up to chunk_max.
    sizes = [chunk]
    while chunk_max and chunk > 1 and sizes[-1] * 2 <= chunk_max:
        sizes.append(sizes[-1] * 2)
    t0 = time.perf_counter()
    if native_roi:
        # The native ROI path reads frame 0 in full, then only the search
        # window's rectangle or view and the periodic decimated frame.
        frame0 = source.read(0)
        it = iter(range(1, len(source)))
    else:
        pump = FramePump(source, depth=pump_depth)
        it = iter(pump)
        frame0 = next(it)
    tracker.init(frame0, init_bbox)
    shipper = None
    if roi_px > 0:
        shipper = RoiShipper(frame0.shape[:2], roi_px, bbox[:2] + bbox[2:] / 2.0, roi_stride=roi_stride,
                             glob_stride=glob_stride, glob_every=glob_every, roi_out=roi_out, stage=tracker.stage,
                             device=tracker.device)
        # Every dispatch size and the one-frame tail, captured now.
        tracker.prepare_stream(shipper.example(frame0.dtype), sorted({*sizes, 1}) if chunk > 1 else [1])
    if cuda:
        _reserve_staging(tracker, frame0, shipper, sizes if chunk > 1 else [], readback_window, steer_lag,
                         glob_every)
    init = time.perf_counter() - t0
    before = SPANS.totals()

    # Entries are (frame_idx, packed rows, dispatch size, the dispatch's
    # stream.submit span); a window goes to the drainer with the event
    # recorded after its last dispatch. hist holds the newest entries for
    # the steer workers, each with its own event.
    pending: list[tuple[int, torch.Tensor, int, Any]] = []
    hist: list[tuple[int, torch.Tensor, int, Any]] = []
    drain_q: queue.Queue = queue.Queue(maxsize=2)
    drain_err: list[BaseException] = []
    drain_stream = torch.cuda.Stream(tracker.device) if cuda and on_record is not None else None
    drained = [0]  # windows drained: the drainer's waits for the card
    fetches = [0]  # rows the steer workers read back
    steer_stop = False

    def _drain_worker() -> None:
        # Runs until the None sentinel even after an error: a dead consumer
        # with windows still queued would deadlock the submitter's puts, so
        # on error it keeps consuming and discards.
        while True:
            item = drain_q.get()
            if item is None:
                return
            if drain_err:
                continue
            try:
                with SPANS.span("drain.window", item[0][-1][0]):
                    _drain(*item, packer, on_record, drain_stream)
                drained[0] += 1
            except BaseException as e:  # surfaced after the loop
                drain_err.append(e)

    def _event():
        if not cuda:
            return None
        event = torch.cuda.Event()
        event.record()
        return event

    def _hand_over(window) -> None:
        item = (window, _event())
        try:
            drain_q.put_nowait(item)
        except queue.Full:  # the drainer is two windows behind
            SPANS.count("drain_blocked")
            drain_q.put(item)

    def _pass_on() -> None:
        """Hand the pending window to the drainer (timed), and start a new one."""
        nonlocal pending, pending_frames
        if pending and not drain_err:
            with SPANS.span("stream.handover"):
                _hand_over(pending)
        pending, pending_frames = [], 0

    def steer_margin(size: int) -> int:
        # In hist entries (a dispatch of `size` frames each): read about
        # steer_lag / 2 frames behind the newest, and keep an entry a
        # worker within reach so that none of them starves.
        return max(1, steer_workers, steer_lag // (2 * max(1, size)))

    steer_lock = threading.Lock()
    steer_claimed = [0]

    def _steer_worker() -> None:
        # Reads a row a few frames behind the newest dispatch: (nearly)
        # done on the card, so the wait is short. The claim counter keeps
        # the workers on distinct entries, and observe() drops a record
        # older than the newest.
        stream = torch.cuda.Stream(tracker.device) if cuda else None
        bufs: dict = {}
        while not steer_stop:
            # The oldest unclaimed entry within the margin (taking only the
            # first could leave every worker idle while the flow control
            # holds hist still).
            recent = hist[-(steer_margin(hist[-1][2] if hist else chunk) + 1):]
            item = None
            with steer_lock:
                for e in recent:
                    if e[0] > steer_claimed[0]:
                        item = e
                        steer_claimed[0] = e[0]
                        break
            if item is None:
                time.sleep(0.001)
                continue
            idx, packed, size, event = item
            try:
                out = packer.unpack(_read_row(packed, event, stream, bufs))
            except BaseException as e:
                drain_err.append(e)
                return
            fetches[0] += 1
            pos, vel, lost = out.position, out.velocity, out.lost
            if size > 1:  # a chunk's rows: steer on its newest frame
                pos, vel, lost = pos[-1], vel[-1], lost[-1]
            shipper.observe({"frame": idx, "position": pos.tolist(), "velocity": vel.tolist(),
                             "lost": bool(np.any(lost))})

    drainer = None
    steerers: list[threading.Thread] = []
    if on_record is not None:
        drainer = threading.Thread(target=_drain_worker, daemon=True)
        drainer.start()
    if shipper is not None:
        steerers = [threading.Thread(target=_steer_worker, daemon=True) for _ in range(max(1, steer_workers))]
        for th in steerers:
            th.start()

    def _finish_drainer() -> None:
        """Flush the pending window and join the drainer (idempotent; safe
        after a drain error, when the worker discards until the sentinel)."""
        nonlocal drainer, pending
        if drainer is None:
            return
        if pending and not drain_err:
            _hand_over(pending)
        pending = []
        drain_q.put(None)
        drainer.join()
        drainer = None

    def _stop_steerers() -> None:
        nonlocal steer_stop
        steer_stop = True
        for th in steerers:
            th.join()

    def _record(idx: int, packed: torch.Tensor, size: int, submit) -> None:
        """Queue a dispatch's rows (submitted in the span `submit`) for the
        drainer and the steer workers."""
        if shipper is not None:
            hist.append((idx, packed, size, _event()))
            if len(hist) > 64:
                del hist[:-64]
        if on_record is not None:
            pending.append((idx, packed, size, submit))

    def _flow_control(lag: int) -> None:
        """Hold the submitter at most `lag` frames ahead of the newest
        steered frame (sleeps on the host)."""
        with SPANS.span("stream.flow"):
            while n - shipper.observed_idx > lag and not drain_err:
                time.sleep(0.0005)

    n = 0
    dispatches: dict[int, int] = {}
    cur_i = 0
    rate_marks: list[tuple[float, int]] = []  # (wall time, frames submitted)
    last_switch_n = 0
    pending_frames = 0
    try:
        while chunk > 1:  # the chunked ROI loop: C frames a copy and a dispatch
            cur = sizes[cur_i]
            with SPANS.span("stream.ingest", n + 1):
                if native_roi:
                    idxs, frames = [], None
                    for _ in range(cur):
                        i = next(it, None)
                        if i is None:
                            break
                        idxs.append(i)
                else:
                    frames = []
                    while len(frames) < cur:
                        f = next(it, None)
                        if f is None:
                            break
                        frames.append(f)
                    idxs = list(range(n + 1, n + 1 + len(frames)))
            if not idxs:
                break
            if len(idxs) < cur:
                # A tail shorter than a chunk: the one-frame ROI step, its
                # rows in a window of their own after the chunks' windows.
                _pass_on()
                for j, idx in enumerate(idxs):
                    with SPANS.span("stream.submit", idx) as sp:
                        dev = shipper.ship_native(source, idx) if native_roi else shipper.ship(frames[j], idx)
                        _record(idx, tracker.step_packed(dev), 1, sp)
                        dispatches[1] = dispatches.get(1, 0) + 1
                    n += 1
                break
            with SPANS.span("stream.submit", idxs[-1]) as sp:
                dev = shipper.ship_native_chunk(source, idxs) if native_roi else shipper.ship_chunk(frames, idxs)
                _record(idxs[-1], tracker.step_chunk_packed(dev), cur, sp)
                dispatches[cur] = dispatches.get(cur, 0) + 1
                if on_record is not None:
                    pending_frames += len(idxs)
            n += len(idxs)
            if pending_frames > readback_window:
                _pass_on()
            if steer_lag > 0:
                # While the newest steered record is lost, at most a chunk
                # ahead, so that a re-detection's jump re-aims the next crop.
                _flow_control(cur if (lost_throttle and shipper.lost_seen) else steer_lag)
            if len(sizes) > 1:
                # The rate over about the last 2 s (at least 3 marks): up a
                # size below fps_target, down above 1.6 fps_target, at least
                # 4 dispatches apart; the pending window is handed over so
                # that each window holds one size.
                now = time.perf_counter()
                rate_marks.append((now, n))
                while len(rate_marks) > 2 and now - rate_marks[0][0] > 2.0:
                    rate_marks.pop(0)
                span = now - rate_marks[0][0]
                if len(rate_marks) >= 3 and span > 0.5 and n - last_switch_n >= 4 * cur:
                    rate = (n - rate_marks[0][1]) / span
                    new_i = cur_i
                    if rate < fps_target and cur_i + 1 < len(sizes):
                        new_i = cur_i + 1
                    elif rate > 1.6 * fps_target and cur_i > 0:
                        new_i = cur_i - 1
                    if new_i != cur_i:
                        _pass_on()
                        cur_i = new_i
                        last_switch_n = n
                        rate_marks.clear()
        while chunk == 1:
            with SPANS.span("stream.ingest", n + 1):
                frame = next(it, None)
            if frame is None:
                break
            with SPANS.span("stream.submit", n + 1) as sp:
                if native_roi:
                    dev = shipper.ship_native(source, frame)  # the frame is an index
                elif shipper is not None:
                    # Record frames count from 1 (frame 0 is the init frame);
                    # passing the index keeps dead reckoning exact.
                    dev = shipper.ship(frame, n + 1)
                else:
                    dev = tracker.stage(frame)
                _record(n + 1, tracker.step_packed(dev), 1, sp)
            n += 1
            if len(pending) > readback_window:
                _pass_on()  # blocks only on the drainer's backpressure
            if shipper is not None and steer_lag > 0:
                # Flow control: the submit-ahead over the newest steered
                # estimate is capped, which bounds both the steering lag and
                # the frames in flight.
                _flow_control(1 if (lost_throttle and shipper.lost_seen) else steer_lag)
        if chunk == 1:
            dispatches[1] = n
        with SPANS.span("stream.drain"):
            if feed is not None:
                feed.end()
            _finish_drainer()
            _stop_steerers()
            if not drain_err:
                _complete(tracker)
    finally:
        if feed is not None:
            feed.end()  # the other ranks stop too when the loop fails
        # Teardown on every exit: the drainer discards queued items after an
        # error, so put(None) cannot block.
        if drainer is not None:
            drain_q.put(None)
            drainer.join()
            drainer = None
        _stop_steerers()
    if drain_err:
        raise drain_err[0]
    wall = time.perf_counter() - t0
    run = SPANS.totals().since(before)
    spans, counts = run["spans"], run["counts"]

    def seconds(*names: str) -> float:
        return round(sum(spans[k]["s"] for k in names if k in spans), 3)

    stats = {
        "frames": n,
        "wall_s": wall,
        "fps": n / wall if wall > 0 else 0.0,
        "init_s": round(init, 3),
        "ingest_wait_s": seconds("stream.ingest"),
        "submit_s": seconds("stream.submit"),
        "readback_s": seconds("stream.handover", "stream.flow"),
        "drain_s": seconds("stream.drain"),
        "drain_windows": drained[0],
        "staging_waits": counts.get("staging_waits", 0),
        "drain_blocked": counts.get("drain_blocked", 0),
        "graph_captures": counts.get("graph_captures", 0),
        "noise_host_draws": counts.get("noise_host_draws", 0),
        "dispatches": dispatches,
        "spans": spans,
    }
    if shipper is not None:
        stats.update(shipped_bytes_per_frame=shipper.shipped_bytes_per_frame, steer_fetches=fetches[0])
    return stats


def _reserve_staging(tracker, frame0: np.ndarray, shipper: RoiShipper | None, sizes: list[int],
                     readback_window: int, steer_lag: int, glob_every: int) -> None:
    """Allocate the pinned staging slots now, deep enough for every array in
    flight. Whole frames: the submitter holds at most one window pending, the
    drain queue two and the drainer one. ROI streaming: as many frames as the
    flow control lets run ahead of the newest steered (and so copied) frame
    (the whole-frame bound without it), in slots of each chunk size, of the
    one-frame step and of the global view; and the noise keys of as many
    dispatches."""
    ahead = 4 * (readback_window + 1) + 1
    staging = tracker.staging
    if steer_lag > 0 and shipper is not None:
        ahead = steer_lag + 2 * max(sizes, default=1)
    if tracker.graphs:
        tracker.reserve_keys(ahead + 2)
    if shipper is None:
        staging.depth = max(staging.depth, ahead)
        staging.reserve(frame0)
        return
    ex = shipper.example(frame0.dtype)
    track, glob = ex.track.pixels.numpy(), ex.glob.pixels.numpy()
    for c in sizes:
        staging.reserve(np.zeros((c, *track.shape), track.dtype), ahead // c + 2)
        staging.reserve(np.zeros((c, 2), np.float32), ahead // c + 2)
    staging.reserve(track, ahead + 2)
    staging.reserve(np.zeros(2, np.float32), ahead + 2)
    staging.reserve(glob, ahead // max(1, glob_every) + 2)


def _drain(pending, event, packer: OutputPacker, on_record, stream) -> None:
    """Read back a window of packed rows in one device-to-host copy and emit
    one record a frame (a chunk's rows: one a row, the entry's index its
    last frame's). On the card the copy runs on `stream`, after `event`
    (recorded on the submitting thread's stream after the window's last
    dispatch): one wait, for that stream. A window holds rows of one size.
    Each record's ``frame.hold`` span ends as it goes to on_record."""
    rows = [p for _, p, _, _ in pending]
    if stream is not None:
        with torch.cuda.stream(stream):
            stream.wait_event(event)
            for row in rows:
                row.record_stream(stream)
            buf = torch.stack(rows).cpu().numpy()
    else:
        buf = torch.stack(rows).numpy()
    for (idx, _, size, submit), row in zip(pending, buf):
        out = packer.unpack(row)
        if size > 1:
            c = out.position.shape[0]
            for j in range(c):
                SPANS.add("frame.hold", submit.end, time.perf_counter_ns(), idx - c + 1 + j)
                on_record({
                    "frame": idx - c + 1 + j,
                    "position": out.position[j].tolist(),
                    "box": out.box[j].tolist(),
                    "velocity": out.velocity[j].tolist(),
                    "conf": float(out.conf[j]),
                    "ess": float(out.ess[j]),
                    "lost": bool(out.lost[j]),
                })
            continue
        SPANS.add("frame.hold", submit.end, time.perf_counter_ns(), idx)
        on_record({
            "frame": idx,
            "position": out.position.tolist(),
            "box": out.box.tolist(),
            "velocity": out.velocity.tolist(),
            "conf": out.conf.tolist(),
            "ess": out.ess.tolist(),
            "lost": out.lost.astype(bool).tolist(),
        })
