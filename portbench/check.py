"""The comparison that decides ``correct``.

The tracker is a particle filter: resampling is discrete, so two exact
implementations that round differently part after a few steps, and a
reference that runs free from the first frame would compare two different
clouds. So the reference follows the program step by step from the
program's own state, and the state is read where the timed path leaves it:

- During the window an auditor thread of the benchmark takes ``bursts``
  snapshots of the tracker's state at times drawn from the seed, each a
  burst of a few snapshots a fraction of a step apart. A snapshot is one
  ``torch.cat`` of the state leaves' bytes, enqueued on the stream the
  steps run on, so it lands between two steps and holds one step's state;
  its ``frame_idx`` leaf says which.
- After the window (memory peak read, the program freed) the reference
  (``reference/step.py``, float32, TF32 off) runs the step from each
  snapshot S_j on frame j + 1 with the draws of (seed, j) and compares its
  record with the record the program delivered for frame j + 1, feed by
  feed: the position (px), the confidence, the effective sample size (ESS)
  of the weights the step estimated and resampled from. Where the burst
  also holds S_j+1, it compares the state the step left: the template, the
  cloud's weighted mean (px), and particle by particle the cloud that
  propagation and resampling drew (the share of particles that lie
  elsewhere than the reference's: from the same draws, a particle lies
  elsewhere only where the two sides picked another ancestor). The start is checked by itself: every filter's
  anchor (its first template, which no step changes) against the
  reference's template from frame 0 and the initial box.

Discrete decisions whose reference margin lies within ``tie_tol`` of the
threshold (the lost gate, the template update) follow the program's side.
"""

from __future__ import annotations

import math
import threading
import time

import torch

from portbench.reference import noise as ref_noise
from portbench.reference import step as ref

STATE_NAMES = ("particles", "log_weights", "template", "anchor", "box_wh", "center", "prev_scale", "key",
               "frame_idx", "conf", "lost", "lost_count", "conf_ema", "coast_xy", "coast_vel", "coast_acc", "blend")
# Kinds of sample: a step's position gap (px; and of the steps where both
# sides are locked), confidence gap, ESS gap (relative to the reference's);
# a transition's RMS gap in the template, gap in the cloud's weighted mean
# (px), share of particles elsewhere than the reference's; a feed's RMS gap
# in its anchor (its first template).
SAMPLES = ("pos_px", "pos_locked_px", "conf", "ess_rel", "template_rms", "cloud_px", "ancestors", "anchor_rms")
# A particle lies elsewhere than the reference's where its position differs
# by more than this (px): far above float32 rounding of the same draws, far
# below the spread of one step's position noise.
ANCESTOR_PX = 0.01
# A compared number is a statistic of one kind of sample over the run; each
# cell names its numbers and limits (workloads/<cell>.json, "check").
STATS = {"p50": lambda v: _percentile(v, 50), "p90": lambda v: _percentile(v, 90),
         "max": lambda v: _percentile(v, 100), "mean": lambda v: sum(v) / len(v) if v else 0.0}


def _leaves(state) -> list[torch.Tensor]:
    out = []
    for x in state:
        out.extend(x if isinstance(x, tuple) else (x,))
    return out


class Auditor:
    """Takes the state snapshots during the window (see the module's
    docstring). ``times``: perf_counter instants of the bursts."""

    def __init__(self, tracker, times: list[float], per_burst: int, gap_s: float, spans: list):
        self.tracker, self.times, self.per_burst, self.gap_s, self.spans = tracker, times, per_burst, gap_s, spans
        self.snaps: list[torch.Tensor] = []
        self.layout: list[tuple] | None = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="portbench-auditor", daemon=True)

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()

    def _snapshot(self) -> None:
        leaves = _leaves(self.tracker.state)
        if self.layout is None:
            self.layout = [(tuple(x.shape), x.dtype, x.numel() * x.element_size()) for x in leaves]
        # One kernel: lands between two of the steps enqueued on this stream.
        self.snaps.append(torch.cat([x.reshape(-1).view(torch.uint8) for x in leaves]))

    def _run(self) -> None:
        for t in self.times:
            while not self._stop.is_set() and time.perf_counter() < t:
                time.sleep(min(0.01, max(0.0, t - time.perf_counter())))
            if self._stop.is_set() or self.tracker.state is None:
                return
            for i in range(self.per_burst):
                t0 = time.perf_counter_ns()
                self._snapshot()
                self.spans.append(("audit.snapshot", t0, time.perf_counter_ns()))
                time.sleep(self.gap_s)

    def states(self) -> dict[int, dict]:
        """The snapshots decoded on the host, by frame index (of bank 0)."""
        out = {}
        for snap in self.snaps:
            raw = snap.cpu()
            st, i = {}, 0
            for name, (shape, dtype, nbytes) in zip(STATE_NAMES, self.layout):
                st[name] = raw[i:i + nbytes].clone().view(dtype).reshape(shape)
                i += nbytes
            out[int(st["frame_idx"].reshape(-1)[0])] = st
        return out


def fp8_quant(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale a tensor (amax to 448)."""
    amax = x.detach().abs().amax().clamp(min=1e-12)
    s = 448.0 / amax
    return (x * s).to(torch.float8_e4m3fn).to(torch.float32) / s


def _bank(st: dict, b: int | None) -> dict:
    return {k: (v if b is None else v[b]) for k, v in st.items()}


def _seed_of(key: torch.Tensor) -> int:
    hi, lo = (int(v) for v in key.reshape(2).tolist())
    return (hi << 32) | lo


class Comparison:
    """Readings of the program (or of a stand-in for it) against the
    reference over one run's snapshots: every gap as a sample, and each
    compared number a statistic of one kind of sample."""

    def __init__(self):
        self.samples: dict[str, list[float]] = {k: [] for k in SAMPLES}
        # steps and transitions compared, anchors checked; feeds whose state is
        # at another frame than the snapshot's first feed (mismatched), and
        # snapshots older than the window's first record (stale).
        self.counts = {"steps": 0, "transitions": 0, "anchors": 0, "mismatched": 0, "stale": 0}
        self.where: dict[str, dict] = {}  # where each kind's largest sample was taken

    def add(self, key: str, value: float, **where) -> None:
        if not math.isfinite(value):
            value = math.inf
        if not self.samples[key] or value >= max(self.samples[key]):
            self.where[key] = where
        self.samples[key].append(value)

    def values(self, numbers: dict) -> dict[str, float]:
        """The compared numbers ({name: {"of": kind, "stat": ...}}) of this run."""
        return {name: STATS[n["stat"]](self.samples[n["of"]]) for name, n in numbers.items()}

    def summary(self) -> dict[str, list[float]]:
        """[p50, p90, max, count, mean] of each kind of sample."""
        return {k: [_percentile(v, 50), _percentile(v, 90), _percentile(v, 100), len(v),
                    sum(v) / len(v) if v else 0.0] for k, v in self.samples.items()}


def _percentile(values: list[float], q: float) -> float:
    if not values:
        return 0.0
    v = sorted(values)
    return float(v[min(len(v) - 1, int(math.ceil(q / 100.0 * len(v))) - 1 if q > 0 else 0)])


def compare(run, params, rc: ref.RefConfig, tie_tol: float, device, stand_in=None,
            first_frame: int = 0) -> Comparison:
    """Run the reference from every snapshot of `run` (harness.Run) and
    compare. stand_in(params, rc, st, frame, noise) -> (new state, record)
    replaces the program's outputs with a computation of its own (the
    control). A snapshot older than `first_frame` is stale."""
    cmp = Comparison()
    states = run.states
    frames = run.frame_of
    banked = run.banked
    with ref.full_f32():
        anchors_done = False
        for j, st in sorted(states.items()):
            rec = run.records_by_frame.get(j + 1)
            nxt = states.get(j + 1)
            if j < first_frame:
                cmp.counts["stale"] += 1
            for b in range(st["center"].shape[0] if banked else 1):
                s = _bank(st, b if banked else None)
                if int(s["frame_idx"]) != j or (nxt is not None
                                                and int(_bank(nxt, b if banked else None)["frame_idx"]) != j + 1):
                    cmp.counts["mismatched"] += 1
                    continue
                s = {k: v.to(device) for k, v in s.items()}
                frame = torch.from_numpy(frames(j + 1, b)).to(device)
                nz = ref_noise.step_noise(_seed_of(s["key"]), j, rc.n, device)
                program_update = None
                if nxt is not None:
                    n1 = _bank(nxt, b if banked else None)
                    program_update = not torch.equal(n1["template"], _bank(st, b if banked else None)["template"])
                if stand_in is None:
                    if rec is None:
                        continue
                    got = _record_of(rec, b if banked else None)
                    got_state = None if nxt is None else {k: v.to(device) for k, v in n1.items()}
                else:
                    got_state, got = stand_in(params, rc, s, frame, nz)
                    got = {k: (v if isinstance(v, bool) else torch.as_tensor(v)) for k, v in got.items()}
                    program_update = None
                new, want = ref.step(params, rc, s, frame, nz, program_lost=got["lost"],
                                     program_update=program_update, tie_tol=tie_tol)
                cmp.counts["steps"] += 1
                where = {"frame": j + 1, "feed": b, "lost": [bool(got["lost"]), bool(want["lost"])],
                         "ess": [float(got["ess"]), float(want["ess"])]}
                pos = float(torch.linalg.vector_norm(
                    torch.as_tensor(got["position"], device=device).float() - want["position"]))
                cmp.add("pos_px", pos, **where)
                if not (bool(got["lost"]) or want["lost"] or bool(s["lost"])):
                    cmp.add("pos_locked_px", pos, **where)
                cmp.add("conf", abs(float(got["conf"]) - float(want["conf"])), **where)
                cmp.add("ess_rel", abs(float(got["ess"]) - float(want["ess"])) / float(want["ess"]), **where)
                if got_state is not None:
                    cmp.counts["transitions"] += 1
                    lw = got_state["log_weights"].float()
                    where["resampled"] = [bool(lw.max() - lw.min() < 1e-6), bool(want["resampled"])]
                    dt = got_state["template"].float() - new["template"]
                    cmp.add("template_rms", float(dt.square().mean().sqrt()), **where)
                    cmp.add("cloud_px", float(torch.linalg.vector_norm(
                        ref.weighted_mean(got_state["particles"], got_state["log_weights"])
                        - ref.weighted_mean(new["particles"], new["log_weights"]))), **where)
                    apart = (got_state["particles"][:, 0:2].float() - new["particles"][:, 0:2]).abs().amax(dim=1)
                    cmp.add("ancestors", float((apart > ANCESTOR_PX).float().mean()), **where)
                if not anchors_done:
                    t0 = ref.init_template(params, torch.from_numpy(frames(0, b)).to(device),
                                           torch.as_tensor(run.bboxes[b], device=device), rc)
                    anchor = s["anchor"].float() if stand_in is None else stand_in.init(
                        params, rc, torch.from_numpy(frames(0, b)).to(device),
                        torch.as_tensor(run.bboxes[b], device=device))
                    cmp.counts["anchors"] += 1
                    cmp.add("anchor_rms", float((anchor - t0).square().mean().sqrt()), feed=b)
            anchors_done = True
    return cmp


def _record_of(rec: dict, b: int | None) -> dict:
    if b is None:
        return {k: rec[k] for k in ("position", "conf", "ess", "lost")}
    return {"position": rec["position"][b], "conf": rec["conf"][b], "ess": rec["ess"][b], "lost": rec["lost"][b]}


class Fp8StandIn:
    """The control: the reference itself in the program's place, its
    forward's products in float8 e4m3 (the precision below the
    configuration's bfloat16)."""

    def __call__(self, params, rc, st, frame, nz):
        return ref.step(params, rc, st, frame, nz, quant=fp8_quant)

    def init(self, params, rc, frame, bbox):
        return ref.init_template(params, frame, bbox, rc, quant=fp8_quant)


def verdict(cmp: Comparison, check_spec: dict, min_steps: int) -> tuple[bool, list[tuple[str, float, float]]]:
    """(correct, [(name, value, limit), ...]): every compared number of the
    cell's `check_spec` at most its limit; steps compared, transitions and
    anchors at least theirs; no feed's state at another frame than its
    snapshot's (mismatched) and no snapshot older than the window (stale)."""
    c = cmp.counts
    values = cmp.values(check_spec["numbers"])
    at_most = [(k, values[k], float(n["limit"])) for k, n in check_spec["numbers"].items()]
    at_most += [("mismatched", float(c["mismatched"]), 0.0), ("stale", float(c["stale"]), 0.0)]
    at_least = [("steps", float(c["steps"]), float(min_steps)), ("transitions", float(c["transitions"]), 1.0),
                ("anchors", float(c["anchors"]), 1.0)]
    ok = all(v <= lim for _, v, lim in at_most) and all(v >= lim for _, v, lim in at_least)
    return ok, at_most + at_least
