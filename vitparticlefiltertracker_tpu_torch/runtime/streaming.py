"""Streaming decode -> track pipeline: the port of the JAX package's
``runtime/streaming.py`` for whole frames (no ROI, one frame a dispatch).

A producer thread decodes frames into a bounded queue (``FramePump``). The
submitting thread stages each frame in pinned host memory and enqueues one
step (``step_packed``: one graph replay on the card, whose output is one
packed f32 row); it never waits for the card mid-stream. Rows are read back
in windows of ``readback_window`` frames by a drainer thread, one stacked
device-to-host copy a window, so the device queue stays full.

Threads and streams. torch's current stream is per thread: the submitting
thread records an event on its stream after the last step of a window, and
the drainer makes its own stream wait for that event before it stacks the
window's rows and copies them to the host. The rows are copies that later
steps leave alone (``step_packed``), and each is marked as used on the
drainer's stream. The pinned staging slots (the tracker's ``staging``) are
deep enough for every frame that can be in flight while a drainer holds the
submitter back; a wait for a slot is counted there.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from vitparticlefiltertracker_tpu_torch.runtime.tracker import pack_track_output, unpack_track_output


class OutputPacker:
    """A TrackOutput as one flat f32 row and back: pack_track_output's
    layout, [10] for one filter, [10 K] for K banks (all K positions, then
    all K boxes, ...). ``unpack`` gives numpy fields of the JAX package's
    OutputPacker shapes: position [2] or [K, 2], conf [] or [K], and the
    flags as bools."""

    def __init__(self, banks: int | None = None):
        self.banks = banks

    def pack(self, out) -> torch.Tensor:
        return pack_track_output(out)

    def unpack(self, row: np.ndarray):
        fields = unpack_track_output(torch.from_numpy(np.asarray(row, np.float32)), self.banks)
        return type(fields)(*(x.numpy() for x in fields))


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
            for frame in source:
                self._q.put(frame)
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


def stream_track(
    tracker,
    source: Iterable[np.ndarray],
    init_bbox,
    on_record: Callable[[dict[str, Any]], None] | None = None,
    readback_window: int = 4,
    pump_depth: int = 3,
    roi_px: int = 0,
    chunk: int = 1,
) -> dict[str, Any]:
    """Run the decode -> track pipeline over a source of whole frames.

    tracker: Tracker, MultiTracker or MultiStreamTracker (init / stage /
    step_packed). init_bbox: [4], or [K, 4] for K banks or streams.
    Returns summary stats (fps, frames, per-stage breakdown). Records go to
    on_record with `readback_window` frames of latency: one a frame, with
    K-vector fields for K banks or streams (the serve command fans them out
    per stream).

    Stage accounting (all measured in this run):
      * ingest_wait_s: time the submitter waited on the decode pump
      * submit_s: host time staging frames and enqueueing steps (the card
        runs them later: this is submission cost, not device compute)
      * readback_s: time handing windows to the drainer (it waits only when
        the drainer is two windows behind)
      * drain_s: the final flush: the last window's records and the wait
        for every step in flight.
    wall_s (and fps) runs from the first frame's read, as in the JAX
    package; init_s is its share for the tracker's init (on the card with
    the step's graph capture and the staging slots' allocation).

    roi_px > 0 (ROI streaming) and chunk > 1 are not ported yet.
    """
    if roi_px > 0:
        raise NotImplementedError(
            "ROI streaming (runtime.stream_roi > 0) is not ported yet; see ROADMAP.md (open items §1, 1b)")
    if chunk > 1:
        raise ValueError("stream chunking (chunk > 1) requires roi_px > 0")
    bbox = np.asarray(init_bbox, np.float32)
    packer = OutputPacker(None if bbox.ndim == 1 else bbox.shape[0])
    pump = FramePump(source, depth=pump_depth)
    it = iter(pump)
    t0 = time.perf_counter()
    frame0 = next(it)
    tracker.init(frame0, init_bbox)
    # Every frame in flight keeps its staging slot: the submitter holds at
    # most one window pending, the drain queue two, and the drainer one.
    tracker.staging.depth = max(tracker.staging.depth, 4 * (readback_window + 1) + 1)
    cuda = tracker.device.type == "cuda"
    if cuda:
        tracker.staging.reserve(frame0)
    init = time.perf_counter() - t0

    # Entries are (frame_idx, packed row); a window goes to the drainer with
    # the event recorded after its last step.
    pending: list[tuple[int, torch.Tensor]] = []
    drain_q: queue.Queue = queue.Queue(maxsize=2)
    drain_err: list[BaseException] = []
    drain_stream = torch.cuda.Stream(tracker.device) if cuda and on_record is not None else None
    drained = [0]  # windows drained: the drainer's waits for the card

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
                _drain(*item, packer, on_record, drain_stream)
                drained[0] += 1
            except BaseException as e:  # surfaced after the loop
                drain_err.append(e)

    def _hand_over(window) -> None:
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record()
        drain_q.put((window, event))

    drainer = None
    if on_record is not None:
        drainer = threading.Thread(target=_drain_worker, daemon=True)
        drainer.start()

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

    n = 0
    ingest_wait = submit = readback = 0.0
    try:
        while True:
            t = time.perf_counter()
            frame = next(it, None)
            ingest_wait += time.perf_counter() - t
            if frame is None:
                break
            t = time.perf_counter()
            packed = tracker.step_packed(tracker.stage(frame))
            if on_record is not None:
                pending.append((n + 1, packed))
            submit += time.perf_counter() - t
            n += 1
            if len(pending) > readback_window and not drain_err:
                done, pending = pending, []
                t = time.perf_counter()
                _hand_over(done)  # blocks only on the drainer's backpressure
                readback += time.perf_counter() - t
        t = time.perf_counter()
        _finish_drainer()
    finally:
        # Teardown on every exit: the drainer discards queued items after an
        # error, so put(None) cannot block.
        if drainer is not None:
            drain_q.put(None)
            drainer.join()
            drainer = None
    if drain_err:
        raise drain_err[0]
    _complete(tracker)
    drain = time.perf_counter() - t
    wall = time.perf_counter() - t0
    return {
        "frames": n,
        "wall_s": wall,
        "fps": n / wall if wall > 0 else 0.0,
        "init_s": round(init, 3),
        "ingest_wait_s": round(ingest_wait, 3),
        "submit_s": round(submit, 3),
        "readback_s": round(readback, 3),
        "drain_s": round(drain, 3),
        "drain_windows": drained[0],
        "staging_waits": tracker.staging.waits,
    }


def _drain(pending, event, packer: OutputPacker, on_record, stream) -> None:
    """Read back a window of packed rows in one device-to-host copy and emit
    one record a row. On the card the copy runs on `stream`, after `event`
    (recorded on the submitting thread's stream after the window's last
    step): one wait, for that stream."""
    rows = [p for _, p in pending]
    if stream is not None:
        with torch.cuda.stream(stream):
            stream.wait_event(event)
            for row in rows:
                row.record_stream(stream)
            buf = torch.stack(rows).cpu().numpy()
    else:
        buf = torch.stack(rows).numpy()
    for (idx, _), row in zip(pending, buf):
        out = packer.unpack(row)
        on_record(
            {
                "frame": idx,
                "position": out.position.tolist(),
                "box": out.box.tolist(),
                "velocity": out.velocity.tolist(),
                "conf": out.conf.tolist(),
                "ess": out.ess.tolist(),
                "lost": out.lost.astype(bool).tolist(),
            }
        )
