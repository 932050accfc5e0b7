"""The program's spans as the benchmark reads them (portbench/program_spans.py
and the metrics that read it) on tiny CPU runs, and the readers on a run of
a program that records no spans."""

import math

import pytest

from portbench import harness, program_spans
from tiny import make

SUBMIT_PARTS = ("stage_ms_per_dispatch", "noise_ms_per_dispatch", "launch_ms_per_dispatch")


def _traced(tmp_path, monkeypatch, cell: str, **kw):
    """A traced tiny run -> (result line, the harness's Run)."""
    bd = make(tmp_path, cell=cell, **kw)
    seen = {}
    real = harness._metrics

    def keep(run, traced, bench_dir):
        seen["run"] = run
        return real(run, traced, bench_dir)

    monkeypatch.setattr(harness, "_metrics", keep)
    out = harness.run_cell(cell, 2**32 + 17, 1.5, True, "cpu", bench_dir=bd)
    return out, seen["run"]


def test_closed_loop_reads_the_programs_spans(tmp_path, monkeypatch):
    """Two feeds, closed loop: each new metric reads a finite positive
    number; stage, noise and launch lie within the submission; the placed
    stream.submit spans that start in the slice number its dispatches; the
    device idle inside them is part of the device's idle time."""
    out, run = _traced(tmp_path, monkeypatch, "tiny-serve", feeds=2)
    assert out["correct"], out["checks"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    for name in (*SUBMIT_PARTS, "idle_submit_pct"):
        assert math.isfinite(m[name]) and m[name] > 0, name
    dispatches = sum(run.stats["dispatches"].values())
    # submit_s is rounded to the millisecond.
    assert sum(m[k] for k in SUBMIT_PARTS) <= m["submit_ms_per_dispatch"] + 0.5 / dispatches
    submits = program_spans.placed(run, "stream.submit")
    starts = [s for s, _ in submits if run.slice.t0 <= s < run.slice.t1]
    assert abs(len(starts) - run.wl["trace_dispatches"]) <= 1
    assert m["idle_submit_pct"] <= m["device_idle_pct"]
    assert out["notes"]["stream"]["spans"]["stream.submit"]["n"] == dispatches


def test_open_loop_reads_the_hold(tmp_path, monkeypatch):
    """One feed at 30 frames/s: hold_ms_per_frame.live is the mean
    frame.hold, a record's wait after its dispatch, shorter than its
    latency from the frame's due time."""
    out, run = _traced(tmp_path, monkeypatch, "tiny-live", feeds=1, loop="open")
    assert out["correct"], out["checks"]
    hold = out["metrics"]["hold_ms_per_frame.live"]["value"]
    spans = run.stats["spans"]["frame.hold"]
    assert math.isfinite(hold) and hold > 0 and hold == pytest.approx(spans["s"] / spans["n"] * 1e3)
    assert hold < max(harness.latencies_ms(run))


def test_readers_without_the_programs_spans_return_nothing(tmp_path, monkeypatch):
    """A program that records no spans (its stats have no "spans", its
    profiling module no recorder): every new reader returns None, so the
    result line leaves its metric out."""
    _, run = _traced(tmp_path, monkeypatch, "tiny-serve", feeds=2)
    run.stats = {k: v for k, v in run.stats.items() if k != "spans"}
    monkeypatch.setattr(program_spans, "timeline", lambda: None)
    for name in (*SUBMIT_PARTS, "hold_ms_per_frame.live", "idle_submit_pct"):
        assert harness.load_reader(name)(run) is None, name


def test_overlap_of_interval_unions():
    a = [(0.0, 2.0), (5.0, 9.0)]
    b = [(1.0, 6.0), (8.0, 8.5), (10.0, 11.0)]
    assert program_spans.overlap_us(a, b) == pytest.approx(1.0 + 1.0 + 0.5)
    assert program_spans.overlap_us(a, []) == 0.0
