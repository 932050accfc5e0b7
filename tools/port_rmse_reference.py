#!/usr/bin/env python
"""RMSE of the JAX package's tracker on the port's smoke-run configuration.

chip_smoke.py drives the PyTorch/CUDA port through config.yaml with
model.checkpoint set to checkpoints/vit_b16_tracking.npz, 60 frames of
synthetic:moving-square at 480x640, and holds its RMSE against a bound
derived from this run of the JAX package (on the CPU, same config, clip
and frames). The port draws its particle noise from its own generator, so
the run is repeated over several filter seeds (the clip stays seed 0) to
show how far the RMSE moves with the noise alone. Prints one JSON line per
seed, then a summary line. Each --set key=value (repeatable) is passed to
load_config after the checkpoint, so the default run is the dense one and
crop mode is one option away.

Usage: python tools/port_rmse_reference.py [--frames 60] [--seeds 0 1 2 3]
           [--set tracker.mode=crop --set tracker.crop_impl=window-pallas]
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
from vitparticlefiltertracker_tpu.io.video import open_source  # noqa: E402
from vitparticlefiltertracker_tpu.runtime.tracker import Tracker  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--set", dest="overrides", action="append", default=[], metavar="KEY=VALUE",
                    help="config override passed to load_config (repeatable)")
    args = ap.parse_args()
    root = os.path.join(os.path.dirname(__file__), "..")
    rmses = []
    for seed in args.seeds:
        cfg = load_config(
            os.path.join(root, "config.yaml"),
            [f"model.checkpoint={os.path.join(root, 'checkpoints/vit_b16_tracking.npz')}",
             f"io.num_frames={args.frames}", f"filter.seed={seed}", *args.overrides],
        )
        src = open_source(cfg.io.source, cfg.io.num_frames, tuple(cfg.io.frame_size), seed=0)
        t0 = time.perf_counter()
        recs = list(Tracker(cfg).run(src))
        pos = np.array([r["position"] for r in recs])
        err = np.linalg.norm(pos - src.truth[1:], axis=1)
        rmses.append(float(np.sqrt(np.mean(err**2))))
        print(json.dumps({
            "package": "vitparticlefiltertracker_tpu (JAX, CPU)",
            "frames": args.frames,
            "overrides": args.overrides,
            "filter_seed": seed,
            "rmse_px": rmses[-1],
            "max_err_px": float(err.max()),
            "lost_frames": int(sum(r["lost"] for r in recs)),
            "seconds": time.perf_counter() - t0,
        }), flush=True)
    print(json.dumps({"overrides": args.overrides, "seeds": args.seeds, "rmse_px_max": max(rmses), "rmse_px_mean": float(np.mean(rmses))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
