#!/usr/bin/env python
"""RMSE of the JAX package's tracker on one of the port's smoke-run
configurations.

chip_smoke.py drives the PyTorch/CUDA port through a config on a synthetic
clip and holds its RMSE against a bound derived from this run of the JAX
package (on the CPU, same config, clip and frames). The port draws its
particle noise from its own generator, so the run is repeated over several
filter seeds (the clip stays seed 0) to show how far the RMSE moves with the
noise alone. Prints one JSON line per seed, then a summary line.

The default run is the dense main path: config.yaml with
model.checkpoint=checkpoints/vit_b16_tracking.npz, 60 frames of
synthetic:moving-square. --config and --checkpoint pick another base, and
each --set key=value (repeatable) is passed to load_config after them. On
synthetic:teleport only the frames from the fourth after the reappearance
on are scored, as tools/eval_quality.py scores them.

--banked runs the JAX MultiTracker instead (runtime.banks filters on one
clip, each initialised on its own target of a multi-object source, as
tools/eval_quality.py's run_banked): the errors of every bank and record are
pooled into one RMSE. --streams K runs the JAX MultiStreamTracker: K clips
of the source seeded 0..K-1, stream i with filter seed (seed + i), as the
serve command opens them; one RMSE a stream. --stream runs the JAX
stream_track instead, as the stream command runs it (every runtime.stream_*
key of the config) on io.source: eval5's ROI stream, through the native
ring (the JAX package builds native/ with make, so run a copy of the repo).

Usage:
  python tools/port_rmse_reference.py [--frames 60] [--seeds 0 1 2 3]
      [--set tracker.mode=crop --set tracker.crop_impl=window-pallas]
  # the robust path (configs/robust-head.yaml with the teleport gates):
  python tools/port_rmse_reference.py --config configs/robust-head.yaml \\
      --checkpoint checkpoints/vit_b16_head.npz --frames 48 \\
      --set io.source=synthetic:teleport --set model.head_blend_auto=true \\
      --set filter.lost_conf_ratio=0.55 --set tracker.redetect_global_after=3 \\
      --set tracker.redetect_accept_ratio=0.35 --set tracker.redetect_accept_z=3.0
  # the banked path (eval4: 8 banks on 48 frames of 720x1280 multi-8):
  python tools/port_rmse_reference.py --banked \\
      --config configs/eval4-tpu-multiobject-720p.yaml --frames 48 \\
      --set io.source=synthetic:multi-8
  # the multi-stream path (4 streams of config.yaml's moving-square):
  python tools/port_rmse_reference.py --streams 4
  # eval5's ROI stream (ViT-L/16 random init, 16384 particles, 4K, ROI 1600
  # as a 288-px view, chunk 4), 60 frames:
  python tools/port_rmse_reference.py --stream --config \\
      configs/eval5-tpu-streaming-4k.yaml --checkpoint "" --frames 60 \\
      --set io.source=native-synthetic:moving-square
  # its teleport form (ROI 1600 at stride 4, 48 frames; recover_err_px):
  python tools/port_rmse_reference.py --stream --config \\
      configs/eval5-tpu-streaming-4k.yaml --checkpoint "" --frames 48 \\
      --set io.source=synthetic:teleport --set runtime.stream_roi_out=0
  # a crop-mode ROI stream (config.yaml, K2's path, ROI 320 at stride 2):
  python tools/port_rmse_reference.py --stream --frames 60 \\
      --set tracker.mode=crop --set tracker.crop_impl=window-pallas \\
      --set runtime.stream_roi=320 --set runtime.stream_roi_stride=2 \\
      --set runtime.stream_chunk=4 --set runtime.stream_glob_every=4
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from vitparticlefiltertracker_tpu.config import load_config  # noqa: E402
from vitparticlefiltertracker_tpu.io.synthetic import teleport_times  # noqa: E402
from vitparticlefiltertracker_tpu.io.video import open_source  # noqa: E402
from vitparticlefiltertracker_tpu.runtime.tracker import Tracker  # noqa: E402


def scored_errors(err: np.ndarray, source: str, frames: int) -> np.ndarray:
    """Per-record errors that count toward the RMSE (teleport: from the
    fourth record after the reappearance, as tools/eval_quality.py)."""
    if source == "synthetic:teleport":
        return err[teleport_times(frames)[1] + 3:]
    return err


def run_single(cfg, frames: int) -> tuple[np.ndarray, list[bool]]:
    """Tracker.run over the clip (seed 0) -> (scored errors, lost flags)."""
    src = open_source(cfg.io.source, cfg.io.num_frames, tuple(cfg.io.frame_size), seed=0)
    recs = list(Tracker(cfg).run(src))
    pos = np.array([r["position"] for r in recs])
    err = scored_errors(np.linalg.norm(pos - src.truth[1:], axis=1), cfg.io.source, frames)
    return err, [bool(r["lost"]) for r in recs]


def run_banked(cfg) -> tuple[np.ndarray, np.ndarray]:
    """MultiTracker over a multi-object clip (seed 0), bank k on target k ->
    (errors [T-1, K], lost flags [T-1, K])."""
    import jax.numpy as jnp

    from vitparticlefiltertracker_tpu.runtime.banked import MultiTracker

    src = open_source(cfg.io.source, cfg.io.num_frames, tuple(cfg.io.frame_size), seed=0)
    arr = np.stack(list(src))
    mt = MultiTracker(cfg)
    mt.init(arr[0], src.init_bbox)
    outs = mt.track_clip_device(jnp.asarray(arr[1:]))
    err = np.linalg.norm(np.asarray(outs.position, np.float32) - src.truth[1:], axis=-1)
    return err, np.asarray(outs.lost)


def run_streams(cfg, k: int) -> tuple[np.ndarray, np.ndarray]:
    """MultiStreamTracker over k clips seeded 0..k-1 (filter seeds seed + i)
    -> (errors [T-1, K], lost flags [T-1, K])."""
    import jax.numpy as jnp

    from vitparticlefiltertracker_tpu.runtime.banked import MultiStreamTracker

    srcs = [open_source(cfg.io.source, cfg.io.num_frames, tuple(cfg.io.frame_size), seed=i) for i in range(k)]
    clips = np.stack([np.stack(list(s)) for s in srcs], axis=1)  # [T, K, H, W, 3]
    ms = MultiStreamTracker(cfg, num_streams=k)
    ms.init(clips[0], np.stack([s.init_bbox for s in srcs]))
    outs = ms.track_clips_device(jnp.asarray(clips[1:]))
    truth = np.stack([s.truth[1:] for s in srcs], axis=1)  # [T-1, K, 2]
    err = np.linalg.norm(np.asarray(outs.position, np.float32) - truth, axis=-1)
    return err, np.asarray(outs.lost)


def run_stream(cfg) -> tuple[np.ndarray, list[bool], dict]:
    """stream_track over io.source (seed 0) with the config's runtime.stream_*
    keys, as the stream command runs it -> (scored errors, lost flags, and on
    synthetic:teleport recover_err_px: the mean error from the tenth frame
    after the reappearance on, as tools/bench_stream_e2e.py scores it)."""
    from vitparticlefiltertracker_tpu.runtime.streaming import stream_track

    src = open_source(cfg.io.source, cfg.io.num_frames, tuple(cfg.io.frame_size), seed=0)
    print(json.dumps({"source": type(src).__name__}), flush=True)
    rt = cfg.runtime
    recs = []
    stream_track(
        Tracker(cfg), src, src.init_bbox, on_record=recs.append, pump_depth=rt.prefetch_frames,
        readback_window=rt.stream_readback, roi_px=rt.stream_roi, roi_stride=rt.stream_roi_stride,
        roi_out=rt.stream_roi_out, steer_lag=rt.stream_steer_lag, glob_stride=rt.stream_glob_stride,
        glob_every=rt.stream_glob_every, chunk=rt.stream_chunk if rt.stream_roi > 0 else 1,
        steer_workers=rt.stream_steer_workers, chunk_max=rt.stream_chunk_max, fps_target=rt.stream_fps_target,
        lost_throttle=rt.stream_lost_throttle,
    )
    recs.sort(key=lambda r: r["frame"])
    truth = np.asarray(src.truth)
    pos = np.array([r["position"] for r in recs])
    err = np.linalg.norm(pos - truth[[r["frame"] for r in recs]], axis=1)
    extra = {}
    if cfg.io.source == "synthetic:teleport":
        show = teleport_times(cfg.io.num_frames)[1]
        extra["recover_err_px"] = float(np.mean([e for r, e in zip(recs, err) if r["frame"] >= show + 10]))
    return scored_errors(err, cfg.io.source, cfg.io.num_frames), [bool(r["lost"]) for r in recs], extra


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--config", default="config.yaml", help="base config, relative to the repo root")
    ap.add_argument("--checkpoint", default="checkpoints/vit_b16_tracking.npz",
                    help="model.checkpoint, relative to the repo root")
    ap.add_argument("--set", dest="overrides", action="append", default=[], metavar="KEY=VALUE",
                    help="config override passed to load_config (repeatable)")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--banked", action="store_true",
                      help="the JAX MultiTracker, runtime.banks targets of a multi-object source; errors pooled")
    mode.add_argument("--streams", type=int, default=0, metavar="K",
                      help="the JAX MultiStreamTracker over K clips; one RMSE a stream")
    mode.add_argument("--stream", action="store_true",
                      help="the JAX stream_track with the config's runtime.stream_* keys")
    args = ap.parse_args()
    root = os.path.join(os.path.dirname(__file__), "..")
    rmses, losts, stream_rmses = [], [], []
    for seed in args.seeds:
        ckpt = os.path.join(root, args.checkpoint) if args.checkpoint else ""
        cfg = load_config(
            os.path.join(root, args.config),
            [f"model.checkpoint={ckpt}",
             f"io.num_frames={args.frames}", f"filter.seed={seed}", *args.overrides],
        )
        t0 = time.perf_counter()
        extra = {}
        if args.banked or args.streams:
            err, lost = run_banked(cfg) if args.banked else run_streams(cfg, args.streams)
            per = np.sqrt(np.mean(err**2, axis=0))  # [K]
            extra = {"rmse_px_by_" + ("bank" if args.banked else "stream"): per.tolist()}
            if args.streams:
                stream_rmses.append(per)
            last5 = lost[-5:].any(axis=1).tolist()
            err, lost = err.reshape(-1), lost.reshape(-1).tolist()
        else:
            if args.stream:
                err, lost, extra = run_stream(cfg)
            else:
                err, lost = run_single(cfg, args.frames)
            last5 = lost[-5:]
        rmses.append(float(np.sqrt(np.mean(err**2))))
        losts.append(int(sum(lost)))
        print(json.dumps({
            "package": "vitparticlefiltertracker_tpu (JAX, CPU)",
            "config": args.config,
            "tracker": ("MultiTracker" if args.banked else
                        f"MultiStreamTracker x {args.streams}" if args.streams else
                        "Tracker through stream_track" if args.stream else "Tracker"),
            "frames": args.frames,
            "overrides": args.overrides,
            "filter_seed": seed,
            "scored_records": int(err.size),
            "rmse_px": rmses[-1],
            "max_err_px": float(err.max()),
            "lost_frames": losts[-1],
            "last5_lost": last5,
            **extra,
            "seconds": time.perf_counter() - t0,
        }), flush=True)
    print(json.dumps({"config": args.config, "overrides": args.overrides, "seeds": args.seeds,
                      "rmse_px_max": max(rmses), "rmse_px_mean": float(np.mean(rmses)),
                      "lost_frames_min": min(losts), "lost_frames_max": max(losts),
                      **({"rmse_px_max_by_stream": np.max(stream_rmses, axis=0).tolist()} if stream_rmses else {})}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
