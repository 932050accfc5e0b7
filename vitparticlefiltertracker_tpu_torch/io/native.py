"""ctypes binding for the native frame-ingestion runtime (``native/vpt_io.cpp``):
the port's own copy of the JAX package's ``io/native.py``.

The C++ library runs a producer thread, outside the interpreter lock, that
fills a bounded prefetch ring; Python reads numpy views of its slots. It
also reads a strided rectangle (``read_rect``) or a bilinear view at a
fractional stride (``read_view``) of a frame without making the whole frame:
the ROI streaming path ships only those. Sources:

  * NativeRawSource       — mmap'ed packed-RGB24 file [T, H, W, 3]
  * NativeSyntheticSource — C++ procedural moving-square clip

Both duck-type the frame-source protocol (io/video.py) and carry
``init_bbox``, and the synthetic one ``truth``, as the Python sources do.

The library is built at first use by ``g++`` with ``native/Makefile``'s flags
into the package's gitignored ``_build/``, named by a hash of the source and
the flags (so an unchanged source is not rebuilt), and never into
``native/``. When it cannot be built, ``available()`` is False and
open_source falls back to the pure-Python sources.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Iterator

import numpy as np

from vitparticlefiltertracker_tpu_torch.ops._build import BUILD_DIR, PKG_DIR

SOURCE = PKG_DIR.parent / "native" / "vpt_io.cpp"
# native/Makefile's CXXFLAGS and LDFLAGS.
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared", "-pthread"]
_lib = None


def build_library(source: Path = SOURCE) -> Path:
    """Compile the source with g++ into _build/, named by a hash of the
    source and the flags (unless that library exists) -> the library's
    path. Raises OSError if the compiler is missing or fails."""
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    so = BUILD_DIR / f"libvpt_io_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *CXX_FLAGS[:-2], str(source), "-o", str(tmp), *CXX_FLAGS[-2:]],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise OSError(f"g++ failed ({proc.returncode}) for {source}:\n{proc.stderr}")
    for old in BUILD_DIR.glob("libvpt_io_*.so"):
        if old.name != so.name:
            old.unlink(missing_ok=True)  # keep only the current source's library
    os.replace(tmp, so)
    return so


def load_library():
    """Load the native library (building it at first use); raises OSError if
    it is unavailable. Callers gate on ``available()`` for the fallback."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_library()))
    p, i, i64, u8p = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    for name, restype, argtypes in (
        ("vpt_open_raw", p, [ctypes.c_char_p, i64, i, i]),
        ("vpt_open_synthetic", p, [i64, i, i, ctypes.c_uint64]),
        ("vpt_num_frames", i64, [p]),
        ("vpt_frame_bytes", i64, [p]),
        ("vpt_synth_truth", None, [p, i64, f32p]),
        ("vpt_synth_init_bbox", None, [p, f32p]),
        ("vpt_read_frame", i, [p, i64, u8p]),
        ("vpt_read_rect", i, [p, i64, i, i, i, i, i, u8p]),
        ("vpt_read_view", i, [p, i64, ctypes.c_float, ctypes.c_float, ctypes.c_float, i, u8p]),
        ("vpt_stream_start", i, [p, i]),
        ("vpt_stream_next", u8p, [p, ctypes.POINTER(i64)]),
        ("vpt_stream_release", None, [p]),
        ("vpt_close", None, [p]),
    ):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    _lib = lib
    return lib


def available() -> bool:
    try:
        load_library()
        return True
    except OSError:
        return False


def _u8(out: np.ndarray):
    return out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class _NativeSource:
    """The ring-streaming iterator and random-access reads over a native
    source handle."""

    def __init__(self, handle: int, height: int, width: int, depth: int = 3):
        if not handle:
            raise RuntimeError("native source open failed")
        self._lib = load_library()
        self._h = ctypes.c_void_p(handle)
        self.height, self.width = height, width
        self.depth = depth
        self._streaming = False

    def __len__(self) -> int:
        return int(self._lib.vpt_num_frames(self._h))

    def read(self, idx: int) -> np.ndarray:
        """One whole frame, read synchronously into a new array."""
        out = np.empty((self.height, self.width, 3), np.uint8)
        if self._lib.vpt_read_frame(self._h, idx, _u8(out)) != 0:
            raise IndexError(idx)
        return out

    def read_rect(self, idx: int, x0: int, y0: int, w: int, h: int, stride: int = 1) -> np.ndarray:
        """The rectangle [y0, y0 + h) x [x0, x0 + w) of frame idx at `stride`
        (ceil(h / stride) x ceil(w / stride) px), without making the frame:
        the runtime touches the rectangle's bytes only."""
        out = np.empty((-(-h // stride), -(-w // stride), 3), np.uint8)
        if self._lib.vpt_read_rect(self._h, idx, x0, y0, w, h, stride, _u8(out)) != 0:
            raise ValueError(f"read_rect out of range: idx={idx} rect=({x0},{y0},{w},{h})")
        return out

    def read_view(self, idx: int, origin_x: float, origin_y: float, stride: float, out_size: int) -> np.ndarray:
        """A square bilinear view at a fractional stride: pixel [j, i]
        samples frame idx at (origin + (i, j) * stride), clamped at the
        edges: the grid the device's window resample reads."""
        out = np.empty((out_size, out_size, 3), np.uint8)
        if self._lib.vpt_read_view(self._h, idx, origin_x, origin_y, stride, out_size, _u8(out)) != 0:
            raise ValueError(f"read_view: bad idx={idx} or stride={stride}")
        return out

    def _start(self) -> None:
        if self._streaming:
            # The C++ ring is in order and runs once a source; a second
            # iteration would resume mid-stream.
            raise RuntimeError("native stream already consumed — reopen the source to iterate again")
        if self._lib.vpt_stream_start(self._h, self.depth) != 0:
            raise RuntimeError("stream already started")
        self._streaming = True

    def __iter__(self) -> Iterator[np.ndarray]:
        """Frames through the native prefetch ring, each a copy of its slot
        (released at once, so the producer never waits on Python). For no
        copy, iter_views()."""
        for view in self.iter_views():
            yield view.copy()

    def iter_views(self) -> Iterator[np.ndarray]:
        """Numpy views into the ring's slots, each valid until the next
        iteration (the slot is released when the generator resumes)."""
        lib = self._lib
        self._start()
        idx = ctypes.c_int64()
        nbytes = int(lib.vpt_frame_bytes(self._h))
        holding = False
        try:
            while True:
                ptr = lib.vpt_stream_next(self._h, ctypes.byref(idx))
                if not ptr:
                    return
                holding = True
                yield np.ctypeslib.as_array(ptr, shape=(nbytes,)).reshape(self.height, self.width, 3)
                lib.vpt_stream_release(self._h)
                holding = False
        finally:
            # An early exit releases the held slot, so the producer thread is
            # not left waiting on the ring.
            if holding:
                lib.vpt_stream_release(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.vpt_close(self._h)
            self._h = ctypes.c_void_p()

    def __del__(self):  # best effort
        try:
            self.close()
        except Exception:
            pass


class NativeRawSource(_NativeSource):
    """mmap'ed packed-RGB24 raw clip ([T, H, W, 3] bytes on disk)."""

    def __init__(self, path: str, height: int, width: int, num_frames: int = 0, depth: int = 3):
        lib = load_library()
        super().__init__(lib.vpt_open_raw(path.encode(), num_frames, height, width), height, width, depth)


class NativeSyntheticSource(_NativeSource):
    """C++ procedural moving-square clip (io/synthetic.py's motion model,
    another texture)."""

    def __init__(self, num_frames: int, height: int, width: int, seed: int = 0, depth: int = 3):
        lib = load_library()
        super().__init__(lib.vpt_open_synthetic(num_frames, height, width, seed), height, width, depth)
        bbox = (ctypes.c_float * 4)()
        lib.vpt_synth_init_bbox(self._h, bbox)
        self.init_bbox = np.asarray(bbox[:], np.float32)

    @property
    def truth(self) -> np.ndarray:
        out = np.empty((len(self), 2), np.float32)
        buf = (ctypes.c_float * 2)()
        for t in range(len(self)):
            self._lib.vpt_synth_truth(self._h, t, buf)
            out[t] = buf[:]
        return out
