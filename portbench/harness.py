"""One run of one cell: set-up, the measured window through the users' path,
the traced slice, the metrics, and the check that decides ``correct``.

Everything that belongs to one cell, configuration or per-layer metric is
a file found by its name: ``workloads/<cell>.json`` (its configuration and
traffic, chips, traced slice, audit and the check's limits),
``traffic/<mix>.json`` (feeds, frame size, scene, clips, loop, rate),
``configs/<config>.json`` (the tracker's configuration as it is run, with
its published source), ``families/<family>.py`` (the model family the
configuration's ``family`` key names, ``vit`` without one: its weights, its
plain forward, its FLOPs a frame and K1's shape), ``metrics/<metric>.py``
(a ``read(run)`` that returns a number or None). Which metrics a cell
reports is read from ``BENCHMARK.json``.

The window drives ``runtime/streaming.py`` ``stream_track`` over a
``Tracker`` (one feed, as the ``stream`` command) or a
``MultiStreamTracker`` (feeds in lockstep, as the ``serve`` command), with
the program's own stream settings. Frames come from host memory: each feed
plays a clip of the cell's pool forward and then backward, from an offset
of its own. For several feeds the source stacks their frames itself: it
stands in for ``cli.cmd_serve``'s per-feed ``FramePump`` and its
``lockstep`` stacking, so a change to that glue does not show here.

With a trace, the window runs untraced and a traced continuation follows
it (``trace.py``).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from portbench import check, program_spans, scenes, trace
from portbench.reference import step as ref
from portbench.reference.noise import splitmix64

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vitparticlefiltertracker_tpu")
FAMILY_FUNCTIONS = ("weights", "tokens", "flops_per_frame", "attention")
DEFAULT_FAMILY = "vit"  # the family of a configuration without a "family" key


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_files(cell: str, bench_dir: Path = BENCH_DIR) -> tuple[dict, dict]:
    """(workload, configuration) of a cell, by name: the cell's file
    (configuration and traffic names, chips, trace slice, audit, limits)
    merged over its traffic's (feeds, frames, scene, loop, rate)."""
    cell_file = load_json(bench_dir / "workloads" / f"{cell}.json")
    wl = {**load_json(bench_dir / "traffic" / f"{cell_file['traffic']}.json"), **cell_file}
    return wl, load_json(bench_dir / "configs" / f"{wl['config']}.json")


def cell_metrics(spec: dict, cell: str, traced: bool) -> list[dict]:
    """The BENCHMARK.json entries a run of `cell` reports: its end-to-end
    metrics, or with a trace its per-layer ones."""
    entries = spec["per_layer"] if traced else spec["end_to_end"]
    return [m for m in entries if "workloads" not in m or cell in m["workloads"]]


def _load_module(path: Path, name: str):
    mod_spec = importlib.util.spec_from_file_location(name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def load_reader(name: str, bench_dir: Path = BENCH_DIR):
    """metrics/<name>.py's read(run) -> float or None."""
    return _load_module(bench_dir / "metrics" / f"{name}.py", f"portbench_metric_{name}").read


def load_family(name: str, bench_dir: Path = BENCH_DIR):
    """families/<name>.py, the model family a configuration names: its
    ``weights(seed, dims, device)`` (the tree the program and the reference
    load), ``tokens(params, images, rc, quant=None)`` (the plain float32
    forward: grid tokens [B, g*g, D] after the final norm, any prefix token
    dropped), ``flops_per_frame(dims, tracker_config)`` and
    ``attention(dims, tracker_config)`` (K1's (heads, tokens, head dim) for
    one window, prefix tokens counted)."""
    path = bench_dir / "families" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"portbench: the configuration's model family {name!r} has no file {path}")
    mod = _load_module(path, f"portbench_family_{name}")
    missing = [f for f in FAMILY_FUNCTIONS if not callable(getattr(mod, f, None))]
    if missing:
        raise ValueError(f"portbench: the model family {path} lacks {missing}")
    return mod


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    import sys

    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def _log(t_process: float, msg: str) -> None:
    import sys

    print(f"portbench +{time.perf_counter() - t_process:7.2f}s {msg}", file=sys.stderr, flush=True)


def sub_seed(seed: int, tag: int) -> int:
    return splitmix64((int(seed) & 0xFFFFFFFFFFFFFFFF) ^ tag)


class Feeds:
    """The cell's host frames: a pool of clips, each feed playing one forward
    and backward from an offset of its own."""

    def __init__(self, wl: dict, seed: int, device):
        h, w = wl["frame_size"]
        t = wl["clip_frames"]
        self.k = wl["feeds"]
        self.clips, self.truth = [], []
        for c in range(wl["clip_pool"]):
            frames, truth, size = scenes.make_clip(wl["scene"], t, h, w, sub_seed(seed, 0xC11B + c), device)
            self.clips.append(frames.cpu().numpy())
            self.truth.append(truth)
            del frames
        self.size = size
        self.period = 2 * t - 2
        per_clip = -(-self.k // len(self.clips))
        self.offsets = [(f // len(self.clips)) * self.period // per_clip for f in range(self.k)]

    def index(self, seq: int, feed: int) -> tuple[int, int]:
        p = (seq + self.offsets[feed]) % self.period
        t = self.period // 2 + 1
        return feed % len(self.clips), (p if p < t else self.period - p)

    def frame(self, seq: int, feed: int) -> np.ndarray:
        c, i = self.index(seq, feed)
        return self.clips[c][i]

    def batch(self, seq: int) -> np.ndarray:
        """One dispatch's input: a frame, or [K, H, W, 3] for K feeds."""
        if self.k == 1:
            return self.frame(seq, 0)
        return np.stack([self.frame(seq, f) for f in range(self.k)])

    def bbox(self, feed: int) -> np.ndarray:
        c, i = self.index(0, feed)
        (cx, cy), (tw, th) = self.truth[c][i], self.size
        return np.asarray([cx - tw / 2, cy - th / 2, tw, th], np.float32)


class Run:
    """What one run recorded, for the metric readers and the check."""

    def __init__(self, cell: str, wl: dict, cfg: dict, seconds: float, traced: bool):
        self.cell, self.wl, self.cfg, self.seconds, self.traced = cell, wl, cfg, seconds, traced
        self.feeds = wl["feeds"]
        self.banked = self.feeds > 1
        self.records: list[tuple[float, dict]] = []  # (arrival, record)
        self.due: dict[int, float] = {}  # open loop: frame -> when it was due
        self.handed: dict[int, float] = {}  # open loop: frame -> when the generator handed it over
        self.first_record = threading.Event()
        self.first_record_t = math.inf
        self.window = (math.inf, math.inf)
        self.window_frames: list[int] = []  # open loop: the frames due in the window
        self.lateness: list[float] = []  # open loop: how late the generator handed each frame over
        self.stats: dict = {}
        self.spans: list[tuple[str, int, int]] = []  # (name, start ns, end ns), perf_counter clock
        self.slice: trace.Slice | None = None
        self.setup_s = math.nan
        self.states: dict[int, dict] = {}
        self.records_by_frame: dict[int, dict] = {}
        self.bboxes: list[np.ndarray] = []
        self.frame_of = None
        self.family = None  # the configuration's model family (load_family)
        self.flops_per_frame = 0.0

    def on_record(self, rec: dict) -> None:
        now = time.perf_counter()
        self.records.append((now, rec))
        if not self.first_record.is_set():
            self.first_record_t = now
            self.first_record.set()

    def first_window_frame(self) -> int:
        """The first frame due (open loop) or recorded (closed) in the window."""
        if self.window_frames:
            return self.window_frames[0]
        frames = [r["frame"] for _, r in self.in_window()]
        return min(frames) if frames else 0

    def in_window(self) -> list[tuple[float, dict]]:
        t0, t1 = self.window
        return [(t, r) for t, r in self.records if t0 <= t <= t1]


class Source:
    """The cell's traffic: the frames of `feeds` handed to the program's
    frame pump, in a closed loop (each next frame always ready) or an open
    loop (a camera's schedule at `rate_fps`, times counted from when each
    frame was due)."""

    def __init__(self, run: Run, feeds: Feeds, wl: dict, seconds: float):
        self.run, self.feeds, self.seconds = run, feeds, seconds
        self.open = wl["loop"] == "open"
        self.rate = float(wl.get("rate_fps", 0.0))
        self.warmup_s = float(wl["warmup_s"])
        self.stop = threading.Event()
        self.next_seq = 1  # the next frame the source would hand over

    def __iter__(self):
        run, spans = self.run, self.run.spans
        yield self.feeds.batch(0)  # the init frame
        seq = 1
        if not self.open:
            while not self.stop.is_set():
                if run.first_record.is_set() and run.window[0] == math.inf:
                    t0 = run.first_record_t + self.warmup_s
                    run.window = (t0, t0 + self.seconds)
                if time.perf_counter() > run.window[1]:
                    return
                t0 = time.perf_counter_ns()
                batch = self.feeds.batch(seq)
                spans.append(("source.frames", t0, time.perf_counter_ns()))
                yield batch
                seq += 1
                self.next_seq = seq
            return
        # Open loop: frames as fast as the pump takes them until the first
        # record (the program is up), then on the camera's schedule.
        while not run.first_record.is_set() and not self.stop.is_set():
            yield self.feeds.batch(seq)
            seq += 1
            self.next_seq = seq
        start = time.perf_counter()
        warm = int(round(self.warmup_s * self.rate))
        count = int(round(self.seconds * self.rate))
        run.window = (start + warm / self.rate, start + (warm + count) / self.rate)
        k = 0
        while not self.stop.is_set():
            due = start + k / self.rate
            if warm <= k < warm + count:
                run.window_frames.append(seq)
            t0 = time.perf_counter_ns()
            batch = self.feeds.batch(seq)
            while (left := due - time.perf_counter()) > 0:
                time.sleep(min(left, 0.002) if left > 0.0005 else 0)
            now = time.perf_counter()
            spans.append(("source.camera", t0, time.perf_counter_ns()))
            run.due[seq] = due
            run.handed[seq] = now
            if k >= warm:
                run.lateness.append(now - due)
            yield batch
            seq += 1
            self.next_seq = seq
            k += 1
            if k >= warm + count and (self._all_in() or now > run.window[1] + 60.0):
                return

    def _all_in(self) -> bool:
        got = {r["frame"] for _, r in self.run.records}
        return all(f in got for f in self.run.window_frames)


def _tracker(wl: dict, cfg, weights, device):
    if wl["feeds"] > 1:
        from vitparticlefiltertracker_tpu_torch.runtime.banked import MultiStreamTracker

        return MultiStreamTracker(cfg, num_streams=wl["feeds"], vit_params=weights, device=device)
    from vitparticlefiltertracker_tpu_torch.runtime.tracker import Tracker

    return Tracker(cfg, vit_params=weights, device=device)


def _stream_kwargs(wl: dict, cfg) -> dict:
    """The program's own stream settings, as its commands pass them: the
    ``stream`` command's for one feed, none for the ``serve`` command."""
    if wl["feeds"] > 1:
        return {}
    from vitparticlefiltertracker_tpu_torch.cli import stream_kwargs

    return stream_kwargs(cfg)


def _bursts(seed: int, wl: dict, window: tuple[float, float]) -> list[float]:
    rng = np.random.default_rng(sub_seed(seed, 0xA0D1))
    t0, t1 = window
    span = t1 - t0
    return sorted(float(x) for x in t0 + span * rng.uniform(0.05, 0.95, wl["audit"]["bursts"]))


def run_cell(cell: str, seed: int, seconds: float, traced: bool, device: str = "cuda",
             t_process: float | None = None, bench_dir: Path = BENCH_DIR, plant=None,
             control: bool = False) -> dict[str, Any]:
    """One run of `cell` -> the result line's dict (without the import
    check, which the caller makes once the window has closed). `plant`
    (tests only): a function(tracker) that breaks the timed path. `control`
    (portbench/control.py only): also read the control, the reference in
    float8 in the program's place, on the same snapshots."""
    from vitparticlefiltertracker_tpu_torch.config import Config
    from vitparticlefiltertracker_tpu_torch.runtime.streaming import stream_track

    t_process = time.perf_counter() if t_process is None else t_process
    wl, cfgf = cell_files(cell, bench_dir)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    run = Run(cell, wl, cfgf, seconds, traced)
    tc = json.loads(json.dumps(cfgf["tracker_config"]))
    tc["filter"]["seed"] = sub_seed(seed, 0xF117) & 0x7FFFFFFF
    cfg = Config.from_dict(tc)
    dims = cfgf["dims"]
    run.family = family = load_family(cfgf.get("family", DEFAULT_FAMILY), bench_dir)
    run.flops_per_frame = family.flops_per_frame(dims, tc)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    weights = family.weights(sub_seed(seed, 0x3E16), dims, dev)
    _log(t_process, "weights made")
    feeds = Feeds(wl, seed, dev)
    run.bboxes = [feeds.bbox(f) for f in range(feeds.k)]
    _log(t_process, "clips made")
    tracker = _tracker(wl, cfg, weights, dev)
    _log(t_process, "tracker built")
    if plant is not None:
        plant(tracker)
    source = Source(run, feeds, wl, seconds)
    bboxes = run.bboxes[0] if feeds.k == 1 else np.stack(run.bboxes)
    kwargs = _stream_kwargs(wl, cfg)
    watcher = _Watcher(run, wl, seed, tracker)
    watcher.start()
    try:
        run.stats = stream_track(tracker, source, bboxes, on_record=run.on_record, **kwargs)
    finally:
        source.stop.set()
        watcher.stop()
    run.setup_s = run.window[0] - t_process
    _log(t_process, f"stream done: window {run.window[0] - t_process:.2f}..{run.window[1] - t_process:.2f}s")
    if traced:
        # After the window, so that no profiler has run in the process while
        # the window's counters were taken.
        run.slice = trace.traced_slice(tracker, feeds, wl, source.next_seq, bboxes, kwargs, cuda, run.spans)
        _log(t_process, "traced slice read")
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    result_metrics = _metrics(run, traced, bench_dir)

    # The check, after the program is gone.
    run.states = watcher.auditor.states() if watcher.auditor is not None else {}
    run.records_by_frame = {r["frame"]: r for _, r in run.records}
    run.frame_of = feeds.frame
    del tracker, weights, watcher
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    rc = ref.RefConfig(tc, dims, family.tokens)
    ref_weights = family.weights(sub_seed(seed, 0x3E16), dims, dev)
    tie = wl["check"]["tie_tol"]
    first_frame = run.first_window_frame()
    cmp = check.compare(run, ref_weights, rc, tie, dev, first_frame=first_frame)
    control_readings = None
    if control:
        ctl = check.compare(run, ref_weights, rc, tie, dev, check.Fp8StandIn(), first_frame=first_frame)
        control_readings = {"values": ctl.values(wl["check"]["numbers"]), "counts": ctl.counts,
                            "largest_at": ctl.where, "summary": ctl.summary()}
    _log(t_process, "reference check done")
    ok, rows = check.verdict(cmp, wl["check"], wl["audit"]["min_steps"])
    attempted, failed = _attempts(run)
    out = {
        "correct": bool(ok and failed == 0),
        "attempted": attempted,
        "failed": failed,
        "metrics": result_metrics,
        "device": _device(dev, wl, memory_peak, run),
    }
    if traced and run.slice is not None:
        out["breakdown"] = run.slice.breakdown()
    out["notes"] = _notes(run, cmp)
    if control_readings is not None:
        out["control"] = control_readings
    out["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in rows}
    return out

def _metrics(run: Run, traced: bool, bench_dir: Path) -> dict:
    spec = benchmark_spec(bench_dir.parent)
    out = {}
    for m in cell_metrics(spec, run.cell, traced):
        value = load_reader(m["name"], bench_dir)(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def _attempts(run: Run) -> tuple[int, int]:
    """Feed-frames due in the window and those whose record never came or
    holds a number that is not finite."""
    def bad(rec: dict) -> bool:
        return not all(np.all(np.isfinite(np.asarray(rec[k], np.float64))) for k in ("position", "conf", "ess"))

    if run.window_frames:
        got = {r["frame"]: r for _, r in run.records}
        failed = sum(1 for f in run.window_frames if f not in got or bad(got[f]))
        return len(run.window_frames) * run.feeds, failed * run.feeds
    recs = run.in_window()
    return len(recs) * run.feeds, sum(run.feeds for _, r in recs if bad(r))


def _device(dev, wl: dict, memory_peak: int, run: Run) -> dict:
    out = {"platform": "gpu" if dev.type == "cuda" else dev.type,
           "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "count": wl["chips"], "memory_peak_bytes": int(memory_peak)}
    if run.slice is not None:
        out["busy_s"] = run.slice.busy_s
        out["window_s"] = run.slice.wall_s
    return out


def _notes(run: Run, cmp: check.Comparison) -> dict:
    notes = {"family": run.cfg.get("family", DEFAULT_FAMILY), "flops_per_frame": run.flops_per_frame,
             "k1_shape": [run.feeds, *run.family.attention(run.cfg["dims"], run.cfg["tracker_config"])],
             "records": len(run.records), "window_records": len(run.in_window()),
             "stream": {k: v for k, v in run.stats.items() if k != "dispatches"},
             "dispatches": sum(run.stats.get("dispatches", {}).values()),
             "snapshots": len(run.states), "compared": cmp.counts, "largest_at": cmp.where,
             "gaps_p50_p90_max": cmp.summary()}
    if run.slice is not None and run.slice.dispatches:
        # The traced slice's dispatch period beside the untraced window's
        # (closed loop), and the device time a dispatch.
        notes["trace"] = {"dispatches": run.slice.dispatches, "period_ms": run.slice.wall_s / run.slice.dispatches * 1e3,
                          "device_ms": run.slice.busy_s / run.slice.dispatches * 1e3}
        if not run.window_frames and notes["window_records"]:
            notes["trace"]["window_period_ms"] = run.seconds / notes["window_records"] * 1e3
    lat = latencies_ms(run)
    if lat:
        notes["latency_p99_ms"] = float(np.percentile(lat, 99))
        notes["latency_samples"] = len(lat)
        notes["generator_late_p99_ms"] = float(np.percentile(np.asarray(run.lateness) * 1e3, 99))
        notes["generator_late_max_ms"] = float(np.max(np.asarray(run.lateness) * 1e3))
        notes["latency_parts_p50_ms"] = latency_parts(run)
        interval = 1e3 / float(run.wl["rate_fps"])
        levels = np.bincount((np.asarray(lat) // interval).astype(int))
        notes["latency_frame_intervals"] = levels.tolist()
    return notes


def latency_parts(run) -> dict[str, float]:
    """Open loop: medians over the window's frames of the parts a latency
    sums: the generator's lateness (due to handed over), the wait until the
    program's ``stream.submit`` of the frame starts, the submission, and the
    hold from its end to the record (the program's spans, by frame)."""
    timeline = program_spans.timeline()
    if not timeline:
        return {}
    submit = {e[5]: (e[1] / 1e9, e[2] / 1e9) for e in timeline if e[0] == "stream.submit"}
    arrival = {r["frame"]: t for t, r in run.records}
    parts: dict[str, list[float]] = {"late": [], "wait": [], "submit": [], "hold": []}
    for f in run.window_frames:
        if f in submit and f in arrival and f in run.handed:
            s, e = submit[f]
            for k, v in (("late", run.handed[f] - run.due[f]), ("wait", s - run.handed[f]), ("submit", e - s),
                         ("hold", arrival[f] - e)):
                parts[k].append(v * 1e3)
    return {k: float(np.median(v)) for k, v in parts.items() if v}


def latencies_ms(run: Run) -> list[float]:
    """Open loop: ms from each window frame's due time to its record."""
    if not run.window_frames:
        return []
    arrival = {r["frame"]: t for t, r in run.records}
    return [(arrival[f] - run.due[f]) * 1e3 for f in run.window_frames if f in arrival]


class _Watcher:
    """Starts the auditor once the window is known."""

    def __init__(self, run: Run, wl: dict, seed: int, tracker):
        self.run, self.wl, self.seed, self.tracker = run, wl, seed, tracker
        self.auditor: check.Auditor | None = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="portbench-watcher", daemon=True)
        self._error: BaseException | None = None

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()
        if self.auditor is not None:
            self.auditor.stop()
        if self._error is not None:
            raise self._error

    def _run(self) -> None:
        try:
            run = self.run
            while run.window[0] == math.inf:
                if self._stop.wait(0.005):
                    return
            audit = self.wl["audit"]
            self.auditor = check.Auditor(self.tracker, _bursts(self.seed, self.wl, run.window), audit["per_burst"],
                                         audit["gap_s"], run.spans)
            self.auditor.start()
        except BaseException as e:  # surfaced by stop()
            self._error = e
