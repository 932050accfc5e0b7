"""The port's native frame-ingestion binding
(vitparticlefiltertracker_tpu_torch/io/native.py) against the JAX package's
(vitparticlefiltertracker_tpu/io/native.py), on the same library source.

Each test mirrors one of tests/test_native_io.py and holds the port's reads
equal to the JAX package's reader byte for byte. The port builds
native/vpt_io.cpp with g++ into its own _build/ and writes nothing into
native/.
"""

import os

import numpy as np
import pytest

from vitparticlefiltertracker_tpu_torch.io import native as tnative


@pytest.fixture(scope="module")
def jnative():
    """The JAX package's binding (its own build of the same source)."""
    from vitparticlefiltertracker_tpu.io import native

    if not native.available():
        pytest.skip("the JAX package's native library is unavailable")
    return native


@pytest.fixture(autouse=True)
def port_library():
    assert tnative.available(), "the port's native library did not build"


def _write_clip(path, clip):
    with open(path, "wb") as f:
        f.write(clip.tobytes())
    return str(path)


def test_synthetic_stream_order_and_shape(jnative):
    src, ref = tnative.NativeSyntheticSource(12, 120, 160, seed=7), jnative.NativeSyntheticSource(12, 120, 160, seed=7)
    frames, want = list(src), list(ref)
    assert len(frames) == 12
    assert frames[0].shape == (120, 160, 3) and frames[0].dtype == np.uint8
    assert not np.array_equal(frames[0], frames[-1])  # the target moves
    for a, b in zip(frames, want):
        np.testing.assert_array_equal(a, b)
    src.close()
    ref.close()


def test_synthetic_stream_matches_random_access(jnative):
    src, ref = tnative.NativeSyntheticSource(8, 96, 128, seed=3), jnative.NativeSyntheticSource(8, 96, 128, seed=3)
    direct = [src.read(i) for i in range(8)]
    for i, (a, b) in enumerate(zip(direct, list(src))):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, ref.read(i))
    src.close()
    ref.close()


def test_synthetic_truth_and_bbox(jnative):
    src, ref = tnative.NativeSyntheticSource(10, 224, 224, seed=0), jnative.NativeSyntheticSource(10, 224, 224, seed=0)
    truth = src.truth
    np.testing.assert_array_equal(truth, ref.truth)
    np.testing.assert_array_equal(src.init_bbox, ref.init_bbox)
    assert truth.shape == (10, 2) and truth[-1, 0] > truth[0, 0]
    bbox = src.init_bbox
    np.testing.assert_allclose(bbox[:2] + bbox[2:] / 2, truth[0], atol=0.51)
    f0 = src.read(0)
    center_px = f0[int(truth[0, 1]), int(truth[0, 0])].astype(np.int32)
    assert center_px[0] > 200 and abs(int(center_px[0]) - int(f0[5, 5, 0])) > 30
    src.close()
    ref.close()


def test_raw_roundtrip(tmp_path, jnative):
    clip = np.random.default_rng(0).integers(0, 255, size=(5, 64, 48, 3), dtype=np.uint8)
    path = _write_clip(tmp_path / "clip.rgb24", clip)
    src, ref = tnative.NativeRawSource(path, 64, 48), jnative.NativeRawSource(path, 64, 48)
    assert len(src) == len(ref) == 5
    for i, (a, b) in enumerate(zip(list(src), list(ref))):
        np.testing.assert_array_equal(a, clip[i])
        np.testing.assert_array_equal(a, b)
    src.close()
    ref.close()


def test_raw_truncates_to_num_frames(tmp_path, jnative):
    path = _write_clip(tmp_path / "c.rgb24", np.zeros((6, 8, 8, 3), np.uint8))
    src, ref = tnative.NativeRawSource(path, 8, 8, num_frames=4), jnative.NativeRawSource(path, 8, 8, num_frames=4)
    assert len(src) == len(ref) == 4
    assert len(list(src)) == 4
    src.close()
    ref.close()


def test_open_source_dispatches_native(tmp_path, jnative):
    from vitparticlefiltertracker_tpu.io.video import open_source as j_open_source
    from vitparticlefiltertracker_tpu_torch.io.video import open_source

    src = open_source("native-synthetic:moving-square", 5, (64, 64), seed=1)
    assert isinstance(src, tnative.NativeSyntheticSource)
    want = list(j_open_source("native-synthetic:moving-square", 5, (64, 64), seed=1))
    got = list(src)
    assert len(got) == 5 and all(np.array_equal(a, b) for a, b in zip(got, want))
    path = _write_clip(tmp_path / "x.rgb24", np.zeros((3, 32, 32, 3), np.uint8))
    src2 = open_source(path, 0, (32, 32))
    assert isinstance(src2, tnative.NativeRawSource) and len(list(src2)) == 3


def test_stream_early_exit_releases_and_reiter_raises():
    """Leaving the stream early does not wedge the producer, and a second
    iteration raises instead of resuming mid-stream."""
    src = tnative.NativeSyntheticSource(50, 32, 32, seed=0, depth=2)
    it = iter(src)
    for _ in range(3):
        next(it)
    it.close()  # the held slot is released
    with pytest.raises(RuntimeError, match="already consumed"):
        next(iter(src))
    src.close()


def test_rgb24_python_memmap_fallback(tmp_path, jnative):
    from vitparticlefiltertracker_tpu.io.video import RawMemmapSource as JRawMemmapSource
    from vitparticlefiltertracker_tpu_torch.io.video import RawMemmapSource

    clip = np.arange(4 * 8 * 8 * 3, dtype=np.uint8).reshape(4, 8, 8, 3)
    path = _write_clip(tmp_path / "c.rgb24", clip)
    got, want = list(RawMemmapSource(path, 8, 8, num_frames=3)), list(JRawMemmapSource(path, 8, 8, num_frames=3))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[1], clip[1])


def test_stream_backpressure_bounded():
    """A consumer that holds at most one slot sees every frame in order
    (the ring's slots are reused in turn)."""
    src = tnative.NativeSyntheticSource(100, 32, 32, seed=0, depth=2)
    it = iter(src)
    first = next(it)
    assert len(list(it)) == 99 and first.shape == (32, 32, 3)
    src.close()


def test_read_rect_matches_frame_slice_synthetic(jnative):
    src, ref = tnative.NativeSyntheticSource(10, 200, 260, seed=5), jnative.NativeSyntheticSource(10, 200, 260, seed=5)
    for idx, (x0, y0, w, h, s) in [
        (0, (0, 0, 260, 200, 1)),  # whole frame
        (3, (40, 30, 120, 96, 1)),  # interior rect
        (3, (40, 30, 120, 96, 4)),  # strided interior rect
        (7, (0, 0, 260, 200, 8)),  # decimated whole frame
        (9, (257, 197, 3, 3, 1)),  # bottom-right corner
    ]:
        got = src.read_rect(idx, x0, y0, w, h, s)
        np.testing.assert_array_equal(got, src.read(idx)[y0 : y0 + h : s, x0 : x0 + w : s])
        np.testing.assert_array_equal(got, ref.read_rect(idx, x0, y0, w, h, s))
    src.close()
    ref.close()


def test_read_rect_matches_frame_slice_raw(tmp_path, jnative):
    clip = np.random.default_rng(1).integers(0, 255, size=(4, 60, 80, 3), dtype=np.uint8)
    path = _write_clip(tmp_path / "clip.rgb24", clip)
    src, ref = tnative.NativeRawSource(path, 60, 80), jnative.NativeRawSource(path, 60, 80)
    got = src.read_rect(2, 10, 8, 48, 40, 3)
    np.testing.assert_array_equal(got, clip[2, 8 : 8 + 40 : 3, 10 : 10 + 48 : 3])
    np.testing.assert_array_equal(got, ref.read_rect(2, 10, 8, 48, 40, 3))
    src.close()
    ref.close()


def test_read_rect_rejects_out_of_range():
    src = tnative.NativeSyntheticSource(4, 50, 50, seed=0)
    with pytest.raises(ValueError):
        src.read_rect(0, 40, 40, 20, 20, 1)  # past the frame's edge
    with pytest.raises(ValueError):
        src.read_rect(99, 0, 0, 10, 10, 1)  # no such frame
    src.close()


def test_read_view_matches_numpy_bilinear(jnative):
    src, ref = tnative.NativeSyntheticSource(6, 180, 240, seed=9), jnative.NativeSyntheticSource(6, 180, 240, seed=9)
    idx, ox, oy, stride, out = 3, 20.5, 14.25, 2.75, 48
    view = src.read_view(idx, ox, oy, stride, out)
    np.testing.assert_array_equal(view, ref.read_view(idx, ox, oy, stride, out))
    got, frame = view.astype(np.float64), src.read(idx).astype(np.float64)
    fy = np.clip(oy + np.arange(out) * stride, 0, 179)
    fx = np.clip(ox + np.arange(out) * stride, 0, 239)
    y0 = fy.astype(int)
    y1, wy = np.minimum(y0 + 1, 179), fy - y0
    x0 = fx.astype(int)
    x1, wx = np.minimum(x0 + 1, 239), fx - x0
    want = ((1 - wy)[:, None, None] * ((1 - wx)[None, :, None] * frame[y0][:, x0] + wx[None, :, None] * frame[y0][:, x1])
            + wy[:, None, None] * ((1 - wx)[None, :, None] * frame[y1][:, x0] + wx[None, :, None] * frame[y1][:, x1]))
    np.testing.assert_allclose(got, np.floor(want + 0.5), atol=1.0)
    src.close()
    ref.close()


def test_read_view_stride1_is_identity():
    src = tnative.NativeSyntheticSource(4, 100, 120, seed=2)
    np.testing.assert_array_equal(src.read_view(1, 10.0, 20.0, 1.0, 32), src.read(1)[20:52, 10:42])
    src.close()


def test_build_writes_nothing_into_native(tmp_path, monkeypatch):
    """A build from scratch (into an empty build directory) goes to that
    directory, named by the source's hash, and leaves native/ as it was."""
    native_dir = tnative.SOURCE.parent

    def listing():
        return {p.name: (p.stat().st_size, p.stat().st_mtime_ns) for p in native_dir.iterdir()}

    before = listing()
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
    so = tnative.build_library()
    assert so.parent == tmp_path / "_build" and so.exists() and so.name.startswith("libvpt_io_")
    assert tnative.build_library() == so  # cached on the hash: not rebuilt
    assert listing() == before
    assert os.path.getsize(so) > 0
