#!/usr/bin/env python3
"""The robust path's step on the card for one checkout of the port, so that
two commits can be compared in one chip call with the same method.

Imports the port and chip_smoke.py's ROBUST_CONFIG from --root (default:
this checkout) and runs the robust path (configs/robust-head.yaml with the
teleport gates, the head-only checkpoint, 48 frames of 480x640
synthetic:teleport), each step a graph replay:

  step    Tracker.step over the 47 steps: host clock a step (one wait for
          its record), median after 5 warm-up;
  clip    track_clip_device over the same 47 frames, already on the card,
          from a fresh tracker: frames/s (host clock to a synchronize) and
          the host's waits inside it (torch's sync debug mode);
  locked  after the clip (its last records are locked), the step's graph
          replayed 20 times between CUDA events on the last frame, five
          times over, with the lost flag read before and after each (a lost
          state runs the probe, where the checkout chooses it on the card).

Prints one JSON line with the card's name and power limit, and writes it to
--out when given. Needs a card; imports no JAX.

Usage: python3 tools/port_step_ab.py [--root DIR] [--label NAME] [--out FILE]
Comparing two commits: unpack the other one with `git archive` and run
parent, change, change, parent in one chip call.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch


def count_waits(fn) -> int:
    """The host's waits for the card while fn runs, as
    torch.cuda.set_sync_debug_mode("warn") reports them."""
    waits = []

    def seen(message, *args, **kwargs):
        if "synchronizing CUDA operation" in str(message):
            waits.append(message)

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return len(waits)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke
    from vitparticlefiltertracker_tpu_torch.config import Config
    from vitparticlefiltertracker_tpu_torch.io.video import open_source
    from vitparticlefiltertracker_tpu_torch.runtime.tracker import Tracker

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    d = copy.deepcopy(chip_smoke.ROBUST_CONFIG)
    d["model"]["checkpoint"] = os.path.join(root, chip_smoke.HEAD_CHECKPOINT)
    cfg = Config.from_dict(d)
    src = open_source(cfg.io.source, cfg.io.num_frames, tuple(cfg.io.frame_size), seed=cfg.filter.seed)
    prm = Tracker(cfg, device="cuda").vit_params

    tr = Tracker(cfg, vit_params=prm, device="cuda")
    tr.init(src.frames[0], src.init_bbox)
    ms = []
    for f in src.frames[1:]:
        t0 = time.perf_counter()
        tr.step(f)
        ms.append((time.perf_counter() - t0) * 1e3)

    tr = Tracker(cfg, vit_params=prm, device="cuda")
    tr.init(src.frames[0], src.init_bbox)
    clip = torch.from_numpy(np.stack(src.frames[1:])).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    waits = count_waits(lambda: tr.track_clip_device(clip))
    torch.cuda.synchronize()
    clip_fps = len(src.frames[1:]) / (time.perf_counter() - t0)

    sg = next(iter(tr._step_graphs.values()))
    graph = sg.graph if hasattr(sg, "graph") else sg.graphs[(False, False)]
    locked = []
    for _ in range(5):
        lost_before = bool(tr.state.lost)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        locked.append({"ms": start.elapsed_time(end) / 20, "lost_before": lost_before,
                       "lost_after": bool(tr.state.lost)})
    line = json.dumps({"label": args.label, "root": root, "card": smi,
                       "step_ms_median": statistics.median(ms[5:]), "clip_frames_per_s": clip_fps,
                       "clip_waits": waits, "locked_step_ms": [x["ms"] for x in locked],
                       "locked_lost": [(x["lost_before"], x["lost_after"]) for x in locked]})
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
