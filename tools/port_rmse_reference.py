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

Usage:
  python tools/port_rmse_reference.py [--frames 60] [--seeds 0 1 2 3]
      [--set tracker.mode=crop --set tracker.crop_impl=window-pallas]
  # the robust path (configs/robust-head.yaml with the teleport gates):
  python tools/port_rmse_reference.py --config configs/robust-head.yaml \\
      --checkpoint checkpoints/vit_b16_head.npz --frames 48 \\
      --set io.source=synthetic:teleport --set model.head_blend_auto=true \\
      --set filter.lost_conf_ratio=0.55 --set tracker.redetect_global_after=3 \\
      --set tracker.redetect_accept_ratio=0.35 --set tracker.redetect_accept_z=3.0
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--config", default="config.yaml", help="base config, relative to the repo root")
    ap.add_argument("--checkpoint", default="checkpoints/vit_b16_tracking.npz",
                    help="model.checkpoint, relative to the repo root")
    ap.add_argument("--set", dest="overrides", action="append", default=[], metavar="KEY=VALUE",
                    help="config override passed to load_config (repeatable)")
    args = ap.parse_args()
    root = os.path.join(os.path.dirname(__file__), "..")
    rmses, losts = [], []
    for seed in args.seeds:
        cfg = load_config(
            os.path.join(root, args.config),
            [f"model.checkpoint={os.path.join(root, args.checkpoint)}",
             f"io.num_frames={args.frames}", f"filter.seed={seed}", *args.overrides],
        )
        src = open_source(cfg.io.source, cfg.io.num_frames, tuple(cfg.io.frame_size), seed=0)
        t0 = time.perf_counter()
        recs = list(Tracker(cfg).run(src))
        pos = np.array([r["position"] for r in recs])
        err = scored_errors(np.linalg.norm(pos - src.truth[1:], axis=1), cfg.io.source, args.frames)
        rmses.append(float(np.sqrt(np.mean(err**2))))
        losts.append(int(sum(r["lost"] for r in recs)))
        print(json.dumps({
            "package": "vitparticlefiltertracker_tpu (JAX, CPU)",
            "config": args.config,
            "frames": args.frames,
            "overrides": args.overrides,
            "filter_seed": seed,
            "scored_records": int(err.size),
            "rmse_px": rmses[-1],
            "max_err_px": float(err.max()),
            "lost_frames": losts[-1],
            "last5_lost": [bool(r["lost"]) for r in recs[-5:]],
            "seconds": time.perf_counter() - t0,
        }), flush=True)
    print(json.dumps({"config": args.config, "overrides": args.overrides, "seeds": args.seeds,
                      "rmse_px_max": max(rmses), "rmse_px_mean": float(np.mean(rmses)),
                      "lost_frames_min": min(losts), "lost_frames_max": max(losts)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
