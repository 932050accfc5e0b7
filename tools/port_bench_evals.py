#!/usr/bin/env python3
"""The port's benchmark harness (runtime/benchmark.py's run_benchmark) over
the five BASELINE configs (BASELINE.json:7-11), on one card.

Each config runs as its file in configs/ says (random init where it names no
checkpoint), with the frame rotation and measured frames of
tools/bench_evals.py: eval1 (ViT-B/16, f32, specified for the CPU) runs on
the card here like the others, its MFU against the f32 peak. Its
use_flash_attention false does not keep it off K1: the port sends every
attention on the card to K1 (the flag is kept for config compatibility),
so eval1 runs K1 in f32. eval5 runs in its device-staged form (4 staged 4K frames, whole
frames through track_clip_device; its ROI stream is chip_smoke.py's
"stream, roi" phase). TF32 is off, as in every port tool, so the f32
products run outside the tensor cores. Each config's line adds K1's launches
by (B, H, T) over its run (12 or 24 a forward: init, each step, and a probe
on each step whose state was lost where the config gates it). Prints the
card's name and power limit once, then one JSON line a config, and with
--out writes the lines to that JSONL file. Imports only the port; needs a
card.

The configs are written out below as dicts (the card's machine may lack a
YAML parser); tests/test_torch_benchmark.py holds each equal to its file.

Usage: python3 tools/port_bench_evals.py [--quick] [--only N] [--out OUT.jsonl]
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402

from vitparticlefiltertracker_tpu_torch.config import Config  # noqa: E402
from vitparticlefiltertracker_tpu_torch.ops import attention  # noqa: E402
from vitparticlefiltertracker_tpu_torch.runtime import step_graph  # noqa: E402
from vitparticlefiltertracker_tpu_torch.runtime.benchmark import run_benchmark  # noqa: E402

EVAL1 = {
    "model": {"variant": "vit-b16", "image_size": 224, "dtype": "float32", "use_flash_attention": False},
    "filter": {"num_particles": 256, "motion": {"sigma_pos": 3.0, "sigma_vel": 0.8}, "likelihood_temp": 20.0,
               "seed": 0},
    "tracker": {"mode": "dense", "search_scale": 4.0},
    "io": {"source": "synthetic:moving-square", "num_frames": 30, "frame_size": [224, 224]},
}
EVAL2 = {
    "model": {"variant": "vit-b16", "image_size": 224, "dtype": "bfloat16", "use_flash_attention": True},
    "filter": {"num_particles": 1024, "motion": {"sigma_pos": 4.0, "sigma_vel": 1.0}, "likelihood_temp": 20.0,
               "lost_conf_ratio": 0.55, "seed": 0},
    "tracker": {"mode": "dense", "search_scale": 4.0, "roi_grid": 5, "template_ema": 0.02,
                "template_update_conf": 0.5},
    "io": {"source": "synthetic:occlusion", "num_frames": 120, "frame_size": [480, 640]},
}
EVAL3 = {
    "model": {"variant": "vit-l16", "image_size": 224, "dtype": "bfloat16", "use_flash_attention": True},
    "filter": {"num_particles": 4096, "motion": {"sigma_pos": 5.0, "sigma_vel": 1.5}, "likelihood_temp": 20.0,
               "seed": 0},
    "tracker": {"mode": "dense", "search_scale": 4.0, "roi_grid": 5, "appearance": "cells"},
    "io": {"source": "synthetic:needle", "num_frames": 120, "frame_size": [1080, 1920],
           "init_bbox": [640.0, 500.0, 80.0, 14.0]},
}
EVAL4 = {
    "model": {"variant": "vit-b16", "image_size": 224, "dtype": "bfloat16", "use_flash_attention": True},
    "filter": {"num_particles": 1024, "motion": {"sigma_pos": 4.0, "sigma_vel": 1.2}, "likelihood_temp": 20.0,
               "seed": 0},
    "tracker": {"mode": "dense", "search_scale": 4.0, "roi_grid": 5},
    "io": {"source": "synthetic:surveillance", "num_frames": 120, "frame_size": [720, 1280]},
    "runtime": {"banks": 8, "mesh_banks": 1, "mesh_particles": 1},
}
EVAL5 = {
    "model": {"variant": "vit-l16", "image_size": 224, "dtype": "bfloat16", "use_flash_attention": True},
    "filter": {"num_particles": 16384, "motion": {"sigma_pos": 6.0, "sigma_vel": 2.0}, "likelihood_temp": 20.0,
               "seed": 0, "lost_conf_ratio": 0.55},
    "tracker": {"mode": "dense", "search_scale": 4.0, "roi_grid": 5, "appearance": "pooled",
                "redetect_global_after": 10, "redetect_global_grid": 5, "redetect_accept_z": 3.0},
    "io": {"source": "synthetic:moving-square", "num_frames": 240, "frame_size": [2160, 3840],
           "init_bbox": [1280.0, 840.0, 120.0, 120.0]},
    "runtime": {"banks": 1, "prefetch_frames": 3, "mesh_particles": 1, "stream_roi": 1600, "stream_roi_out": 288,
                "stream_roi_stride": 4, "stream_glob_stride": 8, "stream_glob_every": 4, "stream_readback": 32,
                "stream_steer_lag": 32, "stream_chunk": 4},
}

# (config file, its dict, stage_frames, measure_frames, notes): the counts
# of tools/bench_evals.py.
EVALS = [
    ("configs/eval1-cpu-synthetic.yaml", EVAL1, 16, 64,
     "spec'd for the CPU; run on the card here (f32; K1 in f32 despite use_flash_attention false)"),
    ("configs/eval2-tpu-occlusion.yaml", EVAL2, 32, 128, ""),
    ("configs/eval3-tpu-needle-1080p.yaml", EVAL3, 8, 64, "1080p frames; staging excluded from timing"),
    ("configs/eval4-tpu-multiobject-720p.yaml", EVAL4, 16, 64, "8 banks x 1k particles, one batched step"),
    ("configs/eval5-tpu-streaming-4k.yaml", EVAL5, 4, 32, "device-staged form of the streaming config"),
]


def config(i: int) -> Config:
    """Eval i's (1-based) config."""
    return Config.from_dict(copy.deepcopy(EVALS[i - 1][1]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="half the staged and measured frames")
    ap.add_argument("--only", type=int, default=0, help="run only eval N")
    ap.add_argument("--out", default="", help="a JSONL file for the lines")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}", flush=True)
    results = []
    for i, (cfg_path, _, stage, measure, notes) in enumerate(EVALS, start=1):
        if args.only and i != args.only:
            continue
        if args.quick:
            stage, measure = stage // 2, measure // 2
        print(f"=== eval {i}: {cfg_path} ===", file=sys.stderr, flush=True)
        t0 = time.perf_counter()
        step_graph.settle_counts()
        attention.flash_attention.shapes.clear()
        r = run_benchmark(config(i), warmup=4, measure_frames=measure, latency_frames=8, stage_frames=stage)
        step_graph.settle_counts()  # the launches of the graphs' branch bodies that ran
        r.update(eval=i, config_file=cfg_path, notes=notes, card=smi, wall_s=round(time.perf_counter() - t0, 1),
                 k1_launches={str(k): v for k, v in attention.flash_attention.shapes.items()})
        results.append(r)
        print(json.dumps(r), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            for r in results:
                f.write(json.dumps(r) + "\n")
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
