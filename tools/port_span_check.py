#!/usr/bin/env python3
"""The program's span recorder on the card's host: its cost, and its clock
against the device trace's.

1. The recorder's host cost: ns a span (``SPANS.span`` as a ``with`` block,
   with and without a key, and nested one deep), a span with its ends given
   (``add``, as ``frame.hold``) and a counter (``count``), each over 200,000
   calls on a fresh recorder less the same loop without it.
2. One traced run of a benchmark cell (portbench/harness.py, as
   ``portbench/run.py --trace 1`` makes it): the cell's per-layer metrics;
   the program's spans a dispatch in the untraced window, by name, and what
   they cost at (1)'s rate beside the submitting thread's time a dispatch;
   and the share of the program's ``step.launch`` spans placed in the
   traced slice (portbench/program_spans.py) that overlap a
   ``cudaGraphLaunch`` runtime event of the trace: the spans share the
   trace's clock where it is near 1.

Prints the card's name and power limit, then one JSON line (also appended
to --out). Imports no JAX.

Usage: python3 tools/port_span_check.py --workload b16-serve16-480p --seed 4294967311 [--seconds 20]
       [--out spans.jsonl] [--device cuda] [--bench-dir portbench]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from vitparticlefiltertracker_tpu_torch.utils.profiling import SpanRecorder  # noqa: E402

CALLS = 200_000


def _ns_a_call(body, calls: int = CALLS) -> float:
    t = time.perf_counter_ns()
    body(calls)
    return (time.perf_counter_ns() - t) / calls


def recorder_cost() -> dict[str, float]:
    """Host ns a call of each recorder operation, the bare loop taken off."""
    rec = SpanRecorder()

    def bare(n):
        for _ in range(n):
            pass

    def span(n):
        for _ in range(n):
            with rec.span("x"):
                pass

    def keyed(n):
        for i in range(n):
            with rec.span("x", i):
                pass

    def nested(n):  # two spans a call, the inner one a child
        for _ in range(n // 2):
            with rec.span("x"):
                with rec.span("y"):
                    pass

    def add(n):
        for i in range(n):
            rec.add("h", i, i + 1, i)

    def count(n):
        for _ in range(n):
            rec.count("c")

    base = min(_ns_a_call(bare) for _ in range(3))
    out = {}
    for name, body in (("span", span), ("span_keyed", keyed), ("span_nested", nested), ("add", add),
                       ("count", count)):
        ns = min(_ns_a_call(body) for _ in range(3)) - base
        out[name] = ns / 2 if name == "span_nested" else ns
    return out


def launch_overlap(run) -> dict:
    """The placed step.launch spans that start inside the slice, and the
    share of them that overlap a cudaGraphLaunch runtime event."""
    from portbench.program_spans import placed

    sl = run.slice
    launches = [(s, e) for s, e in placed(run, "step.launch") or [] if sl.t0 <= s < sl.t1]
    graphs = [(s, e) for name, s, e in sl.host if name.startswith("cuda_runtime:cudaGraphLaunch")]
    hit = sum(1 for s, e in launches if any(gs < e and s < ge for gs, ge in graphs))
    return {"launch_spans": len(launches), "graph_launches": len(graphs), "overlapping": hit,
            "share": hit / len(launches) if launches else None}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--bench-dir", default=str(ROOT / "portbench"))
    args = ap.parse_args()
    if args.device == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True).stdout.strip()
        print(f"card: {card}", flush=True)
    cost = recorder_cost()
    print(f"recorder ns a call: {json.dumps(cost)}", flush=True)

    from portbench import harness

    seen = {}
    read_metrics = harness._metrics

    def keep(run, traced, bench_dir):
        seen["run"] = run
        return read_metrics(run, traced, bench_dir)

    harness._metrics = keep
    out = harness.run_cell(args.workload, args.seed, args.seconds, True, args.device, bench_dir=Path(args.bench_dir))
    run = seen["run"]
    dispatches = sum(run.stats["dispatches"].values())
    spans = run.stats.get("spans", {})
    per_dispatch = {name: v["n"] / dispatches for name, v in sorted(spans.items())}
    spans_a_dispatch = sum(per_dispatch.values())
    cost_us = spans_a_dispatch * max(cost["span_keyed"], cost["add"]) / 1e3
    submit_ms = run.stats["submit_s"] / dispatches * 1e3
    line = {"workload": args.workload, "seed": args.seed, "correct": out["correct"],
            "metrics": {k: v["value"] for k, v in out["metrics"].items()},
            "recorder_ns": cost, "spans_a_dispatch": per_dispatch, "spans_a_dispatch_total": spans_a_dispatch,
            "recorder_us_a_dispatch": cost_us, "recorder_share_of_submit": cost_us / 1e3 / submit_ms,
            "counters": {k: run.stats.get(k) for k in ("staging_waits", "drain_blocked", "graph_captures",
                                                     "noise_host_draws")},
            "launch_overlap": launch_overlap(run), "device": out["device"]}
    print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
    return 0 if out["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
