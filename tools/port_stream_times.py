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
--roi runs chip_smoke.py's eval5-roi-c4 path (configs/eval5-tpu-streaming-4k.yaml:
ViT-L/16, 16384 particles, 4K from the native ring, ROI 1600 as a 288-px
view, chunk 4) through stream_track with the stream command's arguments,
beside two device rates on the same clip: step_chunk_packed over the
clip's ROI views already on the card (chunks of 4 around the truth, one
glob view), and track_clip_device over its whole 4K frames; then one more
stream under cProfile (the submitting thread's host time by function,
the 15 largest by own time).
Prints the card's name and power limit first. Imports only the port; needs
a card.

Usage: python3 tools/port_stream_times.py [--frames 300] [--robust | --streams K | --roi] [--runs 2]
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
    group.add_argument("--roi", action="store_true", help="chip_smoke.py's eval5-roi-c4 path")
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
    if args.roi:
        return roi_times(args)
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


def roi_times(args) -> int:
    """eval5-roi-c4 over args.frames frames: the device rates, then the stream."""
    from vitparticlefiltertracker_tpu_torch.cli import stream_kwargs
    from vitparticlefiltertracker_tpu_torch.ops.image import FrameView, StreamFrame

    d = copy.deepcopy(chip_smoke.EVAL5_CONFIG)
    d["io"]["num_frames"] = args.frames + 1
    cfg = Config.from_dict(d)
    h, w = cfg.io.frame_size
    rt = cfg.runtime
    prm = resolve_vit_params(cfg, None, "cuda")
    src = open_source(cfg.io.source, cfg.io.num_frames, (h, w), seed=cfg.filter.seed)
    print(f"eval5-roi-c4: {type(src).__name__}, {args.frames} frames of {h}x{w}")
    # The device step's rates on this clip: ROI chunks already on the card.
    span, out, c = rt.stream_roi, rt.stream_roi_out, rt.stream_chunk
    sv = span / out
    views, origins = [], []
    for i in range(1, args.frames + 1):
        cx, cy = src.truth[i]
        ox, oy = int(np.clip(round(cx - span / 2), 0, w - span)), int(np.clip(round(cy - span / 2), 0, h - span))
        views.append(src.read_view(i, ox + 0.5 * sv, oy + 0.5 * sv, sv, out))
        origins.append([ox + 0.5 * sv, oy + 0.5 * sv])
    pixels = torch.from_numpy(np.stack(views)).cuda()
    orgs = torch.tensor(origins, dtype=torch.float32, device="cuda")
    glob = FrameView(torch.from_numpy(src.read_rect(1, 0, 0, w, h, rt.stream_glob_stride)).cuda(),
                     torch.zeros(2, device="cuda"), float(rt.stream_glob_stride))
    tr = Tracker(cfg, vit_params=prm, device="cuda")
    tr.init(src.read(0), src.init_bbox)
    chunks = [StreamFrame(FrameView(pixels[i:i + c], orgs[i:i + c], sv), glob) for i in range(0, args.frames - c + 1, c)]
    tr.step_chunk_packed(chunks[0])  # the graph's capture
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for chunk in chunks:
        tr.step_chunk_packed(chunk)
    torch.cuda.synchronize()
    chunk_fps = len(chunks) * c / (time.perf_counter() - t0)
    print(f"eval5-roi-c4: step_chunk_packed over {len(chunks)} chunks of {c} ROI views on the card: "
          f"{chunk_fps:.1f} frames/s")
    full = torch.from_numpy(np.stack([src.read(i) for i in range(1, args.frames + 1)])).cuda()
    tr = Tracker(cfg, vit_params=prm, device="cuda")
    tr.init(src.read(0), src.init_bbox)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.track_clip_device(full)
    torch.cuda.synchronize()
    clip_fps = args.frames / (time.perf_counter() - t0)
    print(f"eval5-roi-c4: track_clip_device over {args.frames} whole 4K frames on the card: {clip_fps:.1f} frames/s")
    del full, pixels
    for _ in range(args.runs):
        src = open_source(cfg.io.source, cfg.io.num_frames, (h, w), seed=cfg.filter.seed)
        recs = []
        stats = stream_track(Tracker(cfg, vit_params=prm, device="cuda"), src, src.init_bbox,
                             on_record=recs.append, **stream_kwargs(cfg))
        n = stats["frames"]
        after = n / (stats["wall_s"] - stats["init_s"])
        dispatches = sum(stats["dispatches"].values())
        recs.sort(key=lambda r: r["frame"])
        err = np.linalg.norm(np.array([r["position"] for r in recs]) - src.truth[1:n + 1], axis=1)
        print(f"eval5-roi-c4: stream_track: {len(recs)} records, {stats['fps']:.1f} frames/s, {after:.1f} after init "
              f"({stats['init_s']} s); dispatches {stats['dispatches']}; submit {stats['submit_s'] * 1e3 / dispatches:.3f} "
              f"ms a dispatch; shipped {stats['shipped_bytes_per_frame']:.0f} B a frame; ingest wait "
              f"{stats['ingest_wait_s']} s, readback and flow control {stats['readback_s']} s, drain {stats['drain_s']} s; "
              f"staging waits {stats['staging_waits']}; steer fetches {stats['steer_fetches']}; RMSE "
              f"{float(np.sqrt(np.mean(err ** 2))):.3f} px; against step_chunk_packed {chunk_fps:.1f} and "
              f"track_clip_device {clip_fps:.1f} frames/s")
        src.close()
    import cProfile
    import io
    import pstats

    src = open_source(cfg.io.source, cfg.io.num_frames, (h, w), seed=cfg.filter.seed)
    tr = Tracker(cfg, vit_params=prm, device="cuda")
    prof = cProfile.Profile()
    prof.enable()
    stats = stream_track(tr, src, src.init_bbox, on_record=lambda r: None, **stream_kwargs(cfg))
    prof.disable()
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(15)
    print(f"eval5-roi-c4 under cProfile (the submitting thread; init included): {stats['frames']} frames, "
          f"submit {stats['submit_s']} s, wall {stats['wall_s']:.3f} s, init {stats['init_s']} s")
    print(out.getvalue())
    src.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
