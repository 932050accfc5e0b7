"""Input sources: synthetic clips, image sequences, video files, cameras,
raw RGB24 files and the native ring's sources (io/native.py) — the port's
own copy of the JAX package's ``io/video.py``. All sources yield RGB uint8
[H, W, 3] numpy arrays. OpenCV and imageio are imported only inside the
readers that use them.
"""

from __future__ import annotations

import glob as globlib
import os
from typing import Iterator

import numpy as np

from vitparticlefiltertracker_tpu_torch.io import synthetic

VIDEO_EXTS = {".mp4", ".avi", ".mov", ".mkv", ".webm", ".m4v", ".y4m"}
IMAGE_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".ppm"}


class SyntheticSource:
    """`synthetic:<name>` — procedural clip with ground truth attached."""

    def __init__(self, name: str, num_frames: int, height: int, width: int, seed: int = 0):
        if name.startswith("multi-"):
            k = int(name.split("-", 1)[1])
            self.frames, self.truth, self.init_bbox = synthetic.make_multi_clip(
                k, num_frames=num_frames, height=height, width=width, seed=seed
            )
        else:
            self.frames, self.truth, self.init_bbox = synthetic.make_clip(
                name, num_frames=num_frames, height=height, width=width, seed=seed
            )

    def __iter__(self) -> Iterator[np.ndarray]:
        yield from self.frames

    def __len__(self) -> int:
        return len(self.frames)


class ImageSequenceSource:
    """Glob of image files, sorted lexicographically (read with imageio)."""

    def __init__(self, pattern: str, num_frames: int = 0):
        self.paths = sorted(globlib.glob(pattern))
        if num_frames:
            self.paths = self.paths[:num_frames]
        if not self.paths:
            raise FileNotFoundError(f"no images match {pattern!r}")

    def __iter__(self) -> Iterator[np.ndarray]:
        import imageio.v3 as iio

        for p in self.paths:
            img = iio.imread(p)
            if img.ndim == 2:
                img = np.stack([img] * 3, axis=-1)
            yield np.ascontiguousarray(img[..., :3], dtype=np.uint8)

    def __len__(self) -> int:
        return len(self.paths)


class VideoFileSource:
    """Decoded video file: OpenCV when it is installed and opens the file,
    imageio otherwise."""

    def __init__(self, path: str, num_frames: int = 0):
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        self.path = path
        self.num_frames = num_frames
        self._len = 0
        try:
            import cv2

            cap = cv2.VideoCapture(path)
            # imageio also takes the files cv2's build cannot open.
            self._use_cv2 = cap.isOpened()
            if self._use_cv2:
                self._len = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
            cap.release()
        except ImportError:
            self._use_cv2 = False

    def _iter_cv2(self) -> Iterator[np.ndarray]:
        import cv2

        cap = cv2.VideoCapture(self.path)
        if not cap.isOpened():
            raise RuntimeError(f"cannot decode {self.path!r}")
        try:
            count = 0
            while True:
                ok, frame = cap.read()
                if not ok:
                    return
                yield np.ascontiguousarray(frame[..., ::-1])  # BGR -> RGB
                count += 1
                if self.num_frames and count >= self.num_frames:
                    return
        finally:
            cap.release()

    def _iter_imageio(self) -> Iterator[np.ndarray]:
        import imageio.v3 as iio

        count = 0
        for frame in iio.imiter(self.path):
            yield np.ascontiguousarray(frame[..., :3], dtype=np.uint8)
            count += 1
            if self.num_frames and count >= self.num_frames:
                return

    def __iter__(self) -> Iterator[np.ndarray]:
        return self._iter_cv2() if self._use_cv2 else self._iter_imageio()

    def __len__(self) -> int:
        return self.num_frames or self._len


class RawMemmapSource:
    """Pure-Python packed-RGB24 reader (np.memmap): the fallback for
    `*.rgb24` sources when the native library is unavailable."""

    def __init__(self, path: str, height: int, width: int, num_frames: int = 0):
        frame_bytes = height * width * 3
        total = os.path.getsize(path) // frame_bytes
        self._n = min(num_frames, total) if num_frames else total
        self._mm = np.memmap(path, dtype=np.uint8, mode="r", shape=(total, height, width, 3))

    def __iter__(self) -> Iterator[np.ndarray]:
        for i in range(self._n):
            yield np.asarray(self._mm[i])

    def __len__(self) -> int:
        return self._n


class CameraSource:
    """Live camera feed (`camera:<index>`) through OpenCV."""

    def __init__(self, index: int, num_frames: int = 0):
        self.index = index
        self.num_frames = num_frames

    def __iter__(self) -> Iterator[np.ndarray]:
        import cv2

        cap = cv2.VideoCapture(self.index)
        if not cap.isOpened():
            raise RuntimeError(f"cannot open camera {self.index}")
        try:
            count = 0
            while True:
                ok, frame = cap.read()
                if not ok:
                    return
                yield np.ascontiguousarray(frame[..., ::-1])  # BGR -> RGB
                count += 1
                if self.num_frames and count >= self.num_frames:
                    return
        finally:
            cap.release()

    def __len__(self) -> int:
        return self.num_frames


def open_source(
    source: str,
    num_frames: int = 0,
    frame_size: tuple[int, int] = (224, 224),
    seed: int = 0,
):
    """Dispatch on the config's io.source string, in the JAX package's order:
    cameras, native sources, synthetic clips, image globs, video files; a
    source no reader takes raises ValueError. Native sources
    (`native-synthetic:...`, `*.rgb24`) fall back to the pure-Python ones,
    with a warning, when the native library cannot be built."""
    if source.startswith("camera:"):
        return CameraSource(int(source.split(":", 1)[1]), num_frames)
    if source.startswith("native-synthetic:") or source.endswith(".rgb24"):
        from vitparticlefiltertracker_tpu_torch.io import native

        if native.available():
            if source.endswith(".rgb24"):
                return native.NativeRawSource(source, frame_size[0], frame_size[1], num_frames)
            return native.NativeSyntheticSource(num_frames or 30, frame_size[0], frame_size[1], seed=seed)
        import warnings

        warnings.warn("native io library unavailable (g++ build of native/vpt_io.cpp failed?); "
                      "falling back to the pure-Python source", stacklevel=2)
        if source.endswith(".rgb24"):
            return RawMemmapSource(source, frame_size[0], frame_size[1], num_frames)
        return SyntheticSource("moving-square", num_frames or 30, frame_size[0], frame_size[1], seed=seed)
    if source.startswith("synthetic:"):
        return SyntheticSource(
            synthetic.parse_synthetic_source(source),
            num_frames=num_frames or 30,
            height=frame_size[0],
            width=frame_size[1],
            seed=seed,
        )
    ext = os.path.splitext(source)[1].lower()
    if "*" in source or "?" in source or ext in IMAGE_EXTS:
        return ImageSequenceSource(source, num_frames)
    if ext in VIDEO_EXTS:
        return VideoFileSource(source, num_frames)
    raise ValueError(f"cannot infer source type from {source!r}")
