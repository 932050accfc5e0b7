"""Output sinks — the port's own copy of the JAX package's ``io/sink.py``:
one JSONL record per frame, to a file or stdout, and an overlay video of
the tracked boxes (OpenCV, imported only when a frame is drawn)."""

from __future__ import annotations

import json
import sys
from typing import IO, Any

import numpy as np


class JsonlSink:
    def __init__(self, path: str = ""):
        self._own = bool(path)
        self._f: IO[str] = open(path, "w") if path else sys.stdout

    def write(self, record: dict[str, Any]) -> None:
        self._f.write(json.dumps(record, default=_np_default) + "\n")
        if not self._own:
            self._f.flush()

    def close(self) -> None:
        if self._own:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _np_default(o):
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, np.bool_):
        return bool(o)
    raise TypeError(f"not JSON serializable: {type(o)}")


class OverlaySink:
    """Draw the tracked box(es) on each frame and encode an mp4 (OpenCV).

    `write` takes one record (one object), `write_multi` a list of K records
    (one a bank): every bank's box is drawn in its own colour, red when lost.
    """

    _BANK_COLORS = [  # BGR; index = bank % len
        (0, 255, 0), (255, 160, 0), (0, 200, 255), (255, 0, 200),
        (180, 255, 0), (0, 120, 255), (255, 0, 80), (120, 0, 255),
    ]

    def __init__(self, path: str, fps: float = 30.0):
        self.path = path
        self.fps = fps
        self._writer = None

    def write(self, frame: np.ndarray, record: dict[str, Any]) -> None:
        self.write_multi(frame, [record])

    def write_multi(self, frame: np.ndarray, records: list[dict[str, Any]]) -> None:
        import cv2

        if self._writer is None:
            h, w = frame.shape[:2]
            self._writer = cv2.VideoWriter(self.path, cv2.VideoWriter_fourcc(*"mp4v"), self.fps, (w, h))
        img = cv2.cvtColor(frame, cv2.COLOR_RGB2BGR)
        for k, record in enumerate(records):
            x, y = record["position"]
            bw, bh = record["box"]
            color = (0, 0, 255) if record.get("lost") else self._BANK_COLORS[k % len(self._BANK_COLORS)]
            cv2.rectangle(img, (int(x - bw / 2), int(y - bh / 2)), (int(x + bw / 2), int(y + bh / 2)), color, 2)
        self._writer.write(img)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.release()


def make_sink(output: str) -> JsonlSink:
    return JsonlSink(output)
