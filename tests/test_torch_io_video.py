"""The port's I/O remainder on the CPU: video files and cameras
(vitparticlefiltertracker_tpu_torch/io/video.py: VideoFileSource,
CameraSource, open_source's dispatch) and the overlay video
(io/sink.py: OverlaySink; the track command's io.overlay).

Mirrors tests/test_io_and_streaming.py's video round trip,
tests/test_sinks.py's overlay tests and tests/test_camera.py (a fake
cv2.VideoCapture serves a synthetic clip), and holds the port to the JAX
package: the same mp4 decodes to equal arrays through both, and the same
frames and records through both OverlaySinks decode to equal videos.
"""

import json
import os
import sys

import numpy as np
import pytest
import test_torch_tracker_e2e  # noqa: F401  (one intra-op thread a test worker)

from vitparticlefiltertracker_tpu.io import sink as jsink
from vitparticlefiltertracker_tpu.io import video as jvideo
from vitparticlefiltertracker_tpu_torch.cli import main
from vitparticlefiltertracker_tpu_torch.config import Config
from vitparticlefiltertracker_tpu_torch.io import sink as tsink
from vitparticlefiltertracker_tpu_torch.io import video as tvideo
from vitparticlefiltertracker_tpu_torch.io.synthetic import make_clip

cv2 = pytest.importorskip("cv2")

TINY_SETS = ["model.variant=vit-t16", "model.image_size=64", "model.dtype=float32",
             "model.use_flash_attention=false", "filter.num_particles=32", "io.num_frames=4",
             "io.frame_size=[96, 96]"]


def _write_clip(path: str, n: int = 5) -> list[np.ndarray]:
    """A 48x64 mp4 of smooth gradients (which survive lossy encoding)."""
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (64, 48))
    yy, xx = np.mgrid[0:48, 0:64]
    frames = [np.stack([(xx * 4 + i * 30) % 256, (yy * 5) % 256, np.full_like(xx, 60 + i * 10)],
                       axis=-1).astype(np.uint8) for i in range(n)]
    for f in frames:
        w.write(f[..., ::-1])  # the writer takes BGR
    w.release()
    return frames


def _decode(path: str) -> np.ndarray:
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return np.stack(frames)


def _cli(*sets: str) -> int:
    return main(["track", "--device", "cpu", "--quiet", *(x for s in (*TINY_SETS, *sets) for x in ("--set", s))])


# ---------------------------------------------------------------------------
# Video files
# ---------------------------------------------------------------------------

def test_video_file_roundtrip(tmp_path):
    """A real encoded video decodes into RGB uint8 frames close to what was
    written (lossy codec)."""
    path = str(tmp_path / "clip.mp4")
    frames = _write_clip(path)
    src = tvideo.open_source(path)
    assert isinstance(src, tvideo.VideoFileSource) and len(src) == 5
    got = list(src)
    assert len(got) == 5
    assert got[0].shape == (48, 64, 3) and got[0].dtype == np.uint8
    for a, b in zip(got, frames):
        assert np.abs(a.astype(np.int32) - b.astype(np.int32)).mean() < 20.0


@pytest.mark.parametrize("num_frames", [0, 3])
def test_video_file_decodes_as_jax(tmp_path, num_frames):
    """The same mp4 through both packages' open_source: equal arrays, the
    num_frames limit and len() honoured alike."""
    path = str(tmp_path / "clip.mp4")
    _write_clip(path)
    mine, ref = tvideo.open_source(path, num_frames), jvideo.open_source(path, num_frames)
    assert len(mine) == len(ref)
    a, b = list(mine), list(ref)
    assert len(a) == len(b) == (num_frames or 5)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_video_file_without_cv2_reads_with_imageio(tmp_path, monkeypatch):
    """Without OpenCV both packages pick the imageio reader."""
    path = str(tmp_path / "clip.mp4")
    _write_clip(path)
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert tvideo.VideoFileSource(path)._use_cv2 is False
    assert jvideo.VideoFileSource(path)._use_cv2 is False


def test_missing_video_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tvideo.open_source(str(tmp_path / "absent.mp4"))


# ---------------------------------------------------------------------------
# The overlay video
# ---------------------------------------------------------------------------

def _overlay_inputs():
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 255, size=(64, 96, 3), dtype=np.uint8) for _ in range(6)]
    records = [{"position": [48.0 + i, 32.0], "box": [20.0, 16.0], "lost": i == 3} for i in range(6)]
    return frames, records


def test_overlay_sink_writes_video(tmp_path):
    path = str(tmp_path / "overlay.mp4")
    sink = tsink.OverlaySink(path, fps=10.0)
    for frame, rec in zip(*_overlay_inputs()):
        sink.write(frame, rec)
    sink.close()
    assert os.path.getsize(path) > 0
    cap = cv2.VideoCapture(path)
    assert cap.isOpened()
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    assert n == 6


@pytest.mark.parametrize("banks", [1, 3])
def test_overlay_sink_encodes_as_jax(tmp_path, banks):
    """The same frames and records through both packages' OverlaySink (one
    record a frame, or three banks' with write_multi) decode to equal videos."""
    frames, records = _overlay_inputs()
    paths = []
    for name, module in (("port", tsink), ("jax", jsink)):
        paths.append(str(tmp_path / f"{name}.mp4"))
        sink = module.OverlaySink(paths[-1], fps=10.0)
        for frame, rec in zip(frames, records):
            if banks == 1:
                sink.write(frame, rec)
            else:
                sink.write_multi(frame, [{**rec, "position": [rec["position"][0] + 10 * k, 32.0 + 4 * k],
                                          "lost": rec["lost"] and k == 1} for k in range(banks)])
        sink.close()
    a, b = _decode(paths[0]), _decode(paths[1])
    assert a.shape == (6, 64, 96, 3) and np.array_equal(a, b)


def test_cli_overlay_end_to_end(tmp_path):
    out, ov = str(tmp_path / "recs.jsonl"), str(tmp_path / "ov.mp4")
    assert _cli("io.source=synthetic:moving-square", f"io.output={out}", f"io.overlay={ov}") == 0
    recs = [json.loads(ln) for ln in open(out)]
    assert len(recs) == 3 and "position" in recs[0]
    assert os.path.getsize(ov) > 0
    assert len(_decode(ov)) == 3


def test_cli_multibank_overlay_draws_all_banks(tmp_path, monkeypatch):
    """A banked track with io.overlay draws every bank's box on every frame,
    in its bank's colour (red when lost)."""
    drawn = []
    rectangle = cv2.rectangle

    def spy(img, p0, p1, color, thickness):
        drawn.append(color)
        return rectangle(img, p0, p1, color, thickness)

    monkeypatch.setattr(cv2, "rectangle", spy)
    out, ov = str(tmp_path / "recs.jsonl"), str(tmp_path / "ov_multi.mp4")
    assert _cli("runtime.banks=2", "io.source=synthetic:multi-2", f"io.output={out}", f"io.overlay={ov}") == 0
    recs = [json.loads(ln) for ln in open(out)]
    assert len(recs) == 2 * 3 and os.path.getsize(ov) > 0
    colors = tsink.OverlaySink._BANK_COLORS
    want = [(0, 0, 255) if r["lost"] else colors[r["bank"]] for r in recs]
    assert drawn == want
    assert len(_decode(ov)) == 3


# ---------------------------------------------------------------------------
# Cameras (a fake cv2.VideoCapture; no camera exists here)
# ---------------------------------------------------------------------------

class FakeCapture:
    """cv2.VideoCapture stand-in serving a synthetic clip in BGR."""

    instances: list["FakeCapture"] = []

    def __init__(self, index):
        self.index = index
        self.frames, self.truth, self.init_bbox = make_clip("moving-square", 12, 192, 192, seed=0)
        self.pos = 0
        self.released = False
        FakeCapture.instances.append(self)

    def isOpened(self):
        return self.index == 0  # camera 0 exists, others don't

    def read(self):
        if self.pos >= len(self.frames):
            return False, None
        f = self.frames[self.pos]
        self.pos += 1
        return True, np.ascontiguousarray(f[..., ::-1])  # RGB -> BGR

    def release(self):
        self.released = True


@pytest.fixture
def fake_cv2(monkeypatch):
    FakeCapture.instances.clear()
    monkeypatch.setattr(cv2, "VideoCapture", FakeCapture)
    return cv2


def test_camera_source_reads_rgb_and_releases(fake_cv2):
    src = tvideo.open_source("camera:0", num_frames=5)
    assert isinstance(src, tvideo.CameraSource) and len(src) == 5
    frames = list(src)
    cap = FakeCapture.instances[-1]
    assert len(frames) == 5 and cap.released
    np.testing.assert_array_equal(frames[0], cap.frames[0])


def test_camera_source_exhausts_stream(fake_cv2):
    frames = list(tvideo.CameraSource(0, num_frames=0))
    assert len(frames) == 12
    assert FakeCapture.instances[-1].released


def test_camera_source_release_on_consumer_abort(fake_cv2):
    it = iter(tvideo.CameraSource(0))
    next(it)
    it.close()
    assert FakeCapture.instances[-1].released


def test_camera_source_unopenable(fake_cv2):
    with pytest.raises(RuntimeError, match="cannot open camera 3"):
        next(iter(tvideo.CameraSource(3)))


def test_camera_frames_equal_jax(fake_cv2):
    mine = list(tvideo.open_source("camera:0", num_frames=6))
    ref = list(jvideo.open_source("camera:0", num_frames=6))
    assert len(mine) == len(ref) == 6 and all(np.array_equal(a, b) for a, b in zip(mine, ref))


def test_tracker_runs_on_camera_source(fake_cv2):
    """The track path over a live feed: camera source -> Tracker.run on the CPU."""
    from vitparticlefiltertracker_tpu_torch.runtime.tracker import Tracker

    cfg = Config.from_dict({
        "model": {"variant": "vit-t16", "image_size": 64, "dtype": "float32", "use_flash_attention": False},
        "filter": {"num_particles": 128},
        "io": {"source": "camera:0", "num_frames": 8},
    })
    src = tvideo.open_source(cfg.io.source, num_frames=cfg.io.num_frames)
    cap_bbox = make_clip("moving-square", 12, 192, 192, seed=0)[2]
    recs = list(Tracker(cfg, device="cpu").run(src, init_bbox=cap_bbox))
    assert len(recs) == 7
    truth = FakeCapture.instances[-1].truth
    errs = [np.hypot(r["position"][0] - truth[r["frame"]][0], r["position"][1] - truth[r["frame"]][1]) for r in recs]
    assert float(np.mean(errs)) < 12.0, errs
