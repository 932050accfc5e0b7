"""Each metric reader on a recorded event list (a chrome trace's events as
the profiler exports them) and a recorded run."""

import pytest

from portbench import counts, harness, trace
from tiny import BENCH

K1 = "(anonymous namespace)::attn_tiled_bf16_kernel((anonymous namespace)::Problem)"
GEMM = "nvjet_tst_192x96_64x5_2x1_v_bz_NNT"
ADD = "void at::native::elementwise_kernel<128, 2, at::native::CUDAFunctor_add<float>>"


def _events():
    """A 1000 us slice (host marks 0.1 and 1.1 ms after the anchor) with two dispatches: per dispatch a K1 launch of 20
    us on the serve cell's grid, a GEMM of 100 us, an add of 30 us and a
    copy of 50 us; one K1 launch of another grid; host events."""
    # The anchor: a runtime call at host time 0 ns, 900 us on the trace's clock.
    ev = [{"ph": "X", "cat": "cuda_runtime", "name": trace.ANCHOR_CUDA, "ts": 900.0, "dur": 2.0}]
    for t0 in (1000.0, 1500.0):
        ev += [
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": t0, "dur": 5.0},
            {"ph": "X", "cat": "kernel", "name": K1, "ts": t0 + 10, "dur": 20.0, "args": {"grid": [768, 1, 1]}},
            {"ph": "X", "cat": "kernel", "name": GEMM, "ts": t0 + 30, "dur": 100.0, "args": {"grid": [4, 2, 1]}},
            {"ph": "X", "cat": "kernel", "name": ADD, "ts": t0 + 130, "dur": 30.0, "args": {"grid": [9, 1, 1]}},
            {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)", "ts": t0 + 160, "dur": 50.0},
        ]
    ev += [
        {"ph": "X", "cat": "kernel", "name": K1, "ts": 1900.0, "dur": 10.0, "args": {"grid": [156, 1, 1]}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 1220.0, "dur": 200.0},
        {"ph": "X", "cat": "kernel", "name": ADD, "ts": 500.0, "dur": 10.0},  # before the slice: left out
    ]
    return ev


def _run():
    wl, cfg = harness.cell_files("b16-serve16-480p")
    run = harness.Run("b16-serve16-480p", wl, cfg, 10.0, True)
    run.slice = trace.Slice(_events(), (100_000, 1_100_000), [("source.frames", 800_000, 900_000)],
                            (trace.ANCHOR_CUDA, 0))
    run.stats = {"submit_s": 0.5, "dispatches": {1: 250}}
    run.family = harness.load_family("vit")
    run.flops_per_frame = run.family.flops_per_frame(cfg["dims"], cfg["tracker_config"])
    return run


def _read(name, run):
    return harness.load_reader(name)(run)


def test_slice_reduction():
    sl = _run().slice
    assert sl.wall_s == pytest.approx(1e-3)
    assert sl.dispatches == 2
    assert sl.busy_s == pytest.approx((2 * 200 + 10) * 1e-6)
    bd = sl.breakdown()
    assert bd["device_ops"][0] == [GEMM, pytest.approx(200e-6)]
    gaps = dict(bd["idle_gaps"])
    # Each gap goes whole to the host event that overlaps most of it.
    assert gaps["cuda_runtime:cudaStreamSynchronize"] == pytest.approx(300e-6)
    assert gaps["portbench:source.frames"] == pytest.approx(190e-6)
    assert gaps["cuda_runtime:cudaGraphLaunch"] == pytest.approx(10e-6)
    assert gaps["no host event"] == pytest.approx(90e-6)


@pytest.mark.parametrize("name, expect", [
    ("device_ms_per_dispatch", 0.205),
    ("tail_ms_per_dispatch", 0.030),
    ("device_idle_pct", 59.0),
    ("submit_ms_per_dispatch", 2.0),
])
def test_reader_values(name, expect):
    assert _read(name, _run()) == pytest.approx(expect)


def test_k1_roofline_counts_only_the_cells_grid():
    run = _run()
    least = counts.k1_least_s(16, 12, 196, 64)
    assert _read("k1_roofline_pct", run) == pytest.approx(100.0 * 2 * least / 40e-6)


def test_step_mfu():
    run = _run()
    want = 100.0 * run.flops_per_frame * 2 * 16 / 1e-3 / counts.PEAK_BF16_FLOPS
    assert _read("step_mfu_pct", run) == pytest.approx(want)


def test_readers_without_a_trace_return_nothing():
    run = _run()
    run.slice = None
    for name in ("device_ms_per_dispatch", "tail_ms_per_dispatch", "device_idle_pct", "k1_roofline_pct",
                 "step_mfu_pct", "device_ms_per_frame.live"):
        assert _read(name, run) is None


def test_end_to_end_readers():
    run = _run()
    run.window = (100.0, 110.0)
    run.records = [(99.0, {"frame": 1}), (100.5, {"frame": 2}), (109.9, {"frame": 3}), (110.2, {"frame": 4})]
    assert _read("frames_per_s", run) == pytest.approx(2 * 16 / 10.0)
    run.setup_s = 12.5
    assert _read("setup_s", run) == 12.5
    live = harness.Run("b16-live-480p-60fps", *harness.cell_files("b16-live-480p-60fps"), 10.0, False)
    live.window_frames = list(range(1, 101))
    live.due = {f: f / 60.0 for f in live.window_frames}
    live.records = [(f / 60.0 + 0.001 * f, {"frame": f}) for f in live.window_frames]
    assert _read("latency_p50_ms", live) == pytest.approx(50.5)
    assert _read("latency_p95_ms", live) == pytest.approx(95.05)
    assert _read("frames_per_s", live) is None


def test_every_listed_metric_has_a_reader():
    spec = harness.benchmark_spec()
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.load_reader(m["name"])), m["name"]
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
