#!/usr/bin/env python3
"""The port's streaming pipeline against its device step, on the card.

Runs, over --frames frames of one of chip_smoke.py's paths, each with a
fresh graph Tracker:

1. track_clip_device over the clip, already on the card (the device step's
   rate, no staging and no readback);
2. stream_track as the stream command runs it (readback window
   runtime.stream_readback, pump depth runtime.prefetch_frames), --runs
   times: its stats and its frames/s after init. Its submit time a frame
   includes waiting for room in the card's launch queue: where it is near
   the device step's time, the pipeline runs at the card's pace.

--robust uses chip_smoke.py's robust path (configs/robust-head.yaml with
the teleport gates, the head checkpoint, synthetic:teleport), whose lost
frames run the probe and the scan on the card. --streams K runs the serve
command's pipeline instead: a MultiStreamTracker over K clips of the dense
path (seeds 0..K-1) stacked a frame batch, against track_clips_device.
Prints the card's name and power limit first. Imports only the port; needs
a card.

Usage: python3 tools/port_stream_times.py [--frames 300] [--robust | --streams K] [--runs 2]
"""

from __future__ import annotations

import argparse
import copy
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from vitparticlefiltertracker_tpu_torch.config import Config  # noqa: E402
from vitparticlefiltertracker_tpu_torch.io.video import open_source  # noqa: E402
from vitparticlefiltertracker_tpu_torch.models.params import resolve_vit_params  # noqa: E402
from vitparticlefiltertracker_tpu_torch.runtime.banked import MultiStreamTracker  # noqa: E402
from vitparticlefiltertracker_tpu_torch.runtime.streaming import stream_track  # noqa: E402
from vitparticlefiltertracker_tpu_torch.runtime.tracker import Tracker  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=300)
    group = ap.add_mutually_exclusive_group()
    group.add_argument("--robust", action="store_true", help="chip_smoke.py's robust path")
    group.add_argument("--streams", type=int, default=0, metavar="K", help="the serve pipeline over K streams")
    ap.add_argument("--runs", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}")
    if args.robust:
        d = copy.deepcopy(chip_smoke.ROBUST_CONFIG)
        d["model"]["checkpoint"] = str(chip_smoke.ROOT / chip_smoke.HEAD_CHECKPOINT)
    else:
        d = copy.deepcopy(chip_smoke.SMOKE_CONFIG)
        d["model"]["checkpoint"] = str(chip_smoke.ROOT / chip_smoke.CHECKPOINT)
    d["io"]["num_frames"] = args.frames + 1
    cfg = Config.from_dict(d)
    size = tuple(cfg.io.frame_size)
    prm = resolve_vit_params(cfg, None, "cuda")
    if args.streams:
        srcs = [open_source(cfg.io.source, cfg.io.num_frames, size, seed=cfg.filter.seed + i)
                for i in range(args.streams)]
        frames = list(np.stack([np.stack(x.frames) for x in srcs], axis=1))  # [T] of [K, H, W, 3]
        bbox = np.stack([x.init_bbox for x in srcs])
        label = f"serve, {args.streams} streams"

        def tracker():
            return MultiStreamTracker(cfg, args.streams, vit_params=prm, device="cuda")
    else:
        src = open_source(cfg.io.source, cfg.io.num_frames, size, seed=cfg.filter.seed)
        frames, bbox = src.frames, src.init_bbox
        label = "robust" if args.robust else "dense"

        def tracker():
            return Tracker(cfg, vit_params=prm, device="cuda")

    tr = tracker()
    tr.init(frames[0], bbox)
    clip = torch.from_numpy(np.stack(frames[1:])).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.track_clip_device(clip)
    torch.cuda.synchronize()
    clip_fps = args.frames / (time.perf_counter() - t0)
    k = args.streams or 1  # frames a step
    print(f"{label}: track_clip_device over {args.frames} steps on the card: {clip_fps:.1f} steps/s, "
          f"{k * clip_fps:.1f} frames/s")

    rt = cfg.runtime
    for _ in range(args.runs):
        tr = tracker()
        recs = []
        stats = stream_track(tr, frames, bbox, on_record=recs.append,
                             readback_window=rt.stream_readback, pump_depth=rt.prefetch_frames)
        n = stats["frames"]
        after = n / (stats["wall_s"] - stats["init_s"])
        print(f"{label}: stream_track: {len(recs)} records, "
              f"{stats['fps']:.1f} steps/s, {after:.1f} after init ({stats['init_s']} s; {k * after:.1f} frames/s); "
              f"submit "
              f"{stats['submit_s'] / n * 1e3:.3f} ms a frame, ingest wait {stats['ingest_wait_s']} s, readback "
              f"{stats['readback_s']} s, drain {stats['drain_s']} s, {stats['drain_windows']} windows, staging "
              f"waits {stats['staging_waits']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
