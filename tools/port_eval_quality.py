#!/usr/bin/env python3
"""Tracking quality of the PyTorch port: RMSE against the synthetic ground
truth over tools/eval_quality.py's clip families, eval geometries
(flagship, eval3, eval4), seeds, weight sets and mp4 decode path, run on the
card (or, with --device cpu, on the CPU).

Each invocation appends one row a clip to docs/port_quality_runs.jsonl and
renders docs/PORT_QUALITY.md from all of that file's rows, laid out as the
JAX tool's docs/QUALITY.md (which this tool never touches). Weights: the
in-repo checkpoints/*.npz (--checkpoint, with the JAX tool's --set for a
head-only file) or the seeded random init (the JAX package's, bit for bit:
models/jax_random.py). On the card the model runs in bfloat16 (with K1);
on the CPU in float32, as the JAX tool runs off its TPU.

Imports the port only (no JAX). Usage, as tools/eval_quality.py:
  python3 tools/port_eval_quality.py                         # flagship, random init
  python3 tools/port_eval_quality.py --checkpoint checkpoints/vit_b16_tracking.npz --label trained
  python3 tools/port_eval_quality.py --checkpoint checkpoints/vit_b16_head.npz --label trained-auto \\
      --set model.head_depth=2 --set model.head_blend_auto=true
  python3 tools/port_eval_quality.py --geometry eval3        # ViT-L/16, 4096 particles, 1080p needle
  python3 tools/port_eval_quality.py --geometry eval4        # 8 banks x 1024, 720p multi-8
  python3 tools/port_eval_quality.py --mp4                   # through an mp4 encode and decode (cv2)
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402

from vitparticlefiltertracker_tpu_torch.config import Config, apply_override  # noqa: E402
from vitparticlefiltertracker_tpu_torch.io.video import open_source  # noqa: E402

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
RUNS = os.path.join(REPO, "docs", "port_quality_runs.jsonl")
MD = os.path.join(REPO, "docs", "PORT_QUALITY.md")

# tools/eval_quality.py's geometries and per-clip overrides, copied (the
# port imports nothing of the JAX package's tree).
GEOMETRIES = {
    "flagship": {
        "model": "vit-b16", "particles": 1024, "frame": (480, 640), "banks": 1,
        "clips": ["moving-square", "occlusion", "needle", "surveillance",
                  "teleport", "photometric", "rotation", "lookalikes"],
    },
    "eval3": {"model": "vit-l16", "particles": 4096, "frame": (1080, 1920), "banks": 1, "clips": ["needle"]},
    "eval4": {"model": "vit-b16", "particles": 1024, "frame": (720, 1280), "banks": 8, "clips": ["multi-8"]},
}
ROBUST = {
    "filter.lost_conf_ratio": "0.55",
    "tracker.redetect_global_after": "4",
    "tracker.redetect_accept_ratio": "0.35",
    "tracker.redetect_accept_z": "3.0",
}
CLIP_OVERRIDES = {
    "occlusion": ROBUST,
    "surveillance": {"filter.motion.sigma_pos": "4.0"},
    "lookalikes": {**ROBUST, "tracker.relock_conf_ratio": "0.9", "tracker.redetect_accept_ratio": "0.85"},
    "teleport": {**ROBUST, "tracker.redetect_global_after": "3"},
}


def build_cfg(geo: dict, clip: str, checkpoint: str, sets=(), device: str = "cuda") -> Config:
    """tools/eval_quality.py's build_cfg: bfloat16 on the card, float32 on
    the CPU; the clip's overrides, then --set."""
    on_card = device != "cpu"
    cfg = Config.from_dict({
        "model": {"variant": geo["model"], "image_size": 224, "dtype": "bfloat16" if on_card else "float32",
                  "use_flash_attention": on_card, "checkpoint": checkpoint},
        "filter": {"num_particles": geo["particles"]},
        "tracker": {"mode": "dense"},
        "runtime": {"banks": geo["banks"]},
    })
    for k, v in CLIP_OVERRIDES.get(clip, {}).items():
        apply_override(cfg, f"{k}={v}")
    for ov in sets:
        apply_override(cfg, ov)
    return cfg.resolve()


def mp4_roundtrip(frames: np.ndarray) -> np.ndarray:
    """The clip through an mp4 encode and decode (cv2; the port's video
    reader), as tools/eval_quality.py."""
    import cv2

    t, h, w, _ = frames.shape
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "clip.mp4")
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (w, h))
        for f in frames:
            vw.write(f[..., ::-1])
        vw.release()
        out = np.stack(list(open_source(path)))
    assert out.shape == frames.shape, (out.shape, frames.shape)
    return out


def _clip(clip: str, seed: int, frames: int, frame_size, mp4: bool):
    src = open_source(f"synthetic:{clip}", frames, tuple(frame_size), seed=seed)
    arr = np.stack(list(src))
    return src, (mp4_roundtrip(arr) if mp4 else arr)


def run_single(cfg: Config, clip: str, seed: int, frames: int, frame_size, mp4: bool, device: str = "cuda"):
    """One clip through Tracker.track_clip_device -> (per-frame errors px,
    lost flags, the box diagonal), as tools/eval_quality.py's run_single
    (teleport scored from the fourth frame after the reappearance)."""
    from vitparticlefiltertracker_tpu_torch.runtime.tracker import Tracker

    src, arr = _clip(clip, seed, frames, frame_size, mp4)
    tr = Tracker(cfg, device=device)
    tr.init(arr[0], src.init_bbox)
    outs = tr.track_clip_device(torch.from_numpy(arr[1:]).to(tr.device))
    pos = outs.position.cpu().numpy().astype(np.float32)
    err = np.linalg.norm(pos - src.truth[1:], axis=1)
    if clip == "teleport":
        from vitparticlefiltertracker_tpu_torch.io.synthetic import teleport_times

        _, t_show = teleport_times(frames)
        err = err[t_show + 3:]
        if err.size == 0:
            raise SystemExit(f"teleport scoring needs frames > {t_show + 4} (got {frames})")
    return err, outs.lost.cpu().numpy(), float(np.hypot(src.init_bbox[2], src.init_bbox[3]))


def run_banked(cfg: Config, clip: str, seed: int, frames: int, frame_size, mp4: bool, device: str = "cuda"):
    """The banked tracker (runtime.banks, bank k on target k) through
    MultiTracker.track_clip_device -> (errors of every bank and frame, lost
    flags, the mean box diagonal), as tools/eval_quality.py's run_banked."""
    from vitparticlefiltertracker_tpu_torch.runtime.banked import MultiTracker

    src, arr = _clip(clip, seed, frames, frame_size, mp4)
    mt = MultiTracker(cfg, device=device)
    mt.init(arr[0], src.init_bbox)
    outs = mt.track_clip_device(torch.from_numpy(arr[1:]).to(mt.device))
    pos = outs.position.cpu().numpy().astype(np.float32)  # [T-1, K, 2]
    err = np.linalg.norm(pos - src.truth[1:], axis=-1)
    diag = float(np.mean(np.hypot(src.init_bbox[:, 2], src.init_bbox[:, 3])))
    return err.reshape(-1), outs.lost.cpu().numpy().reshape(-1), diag


def card_name(device: str) -> str:
    """The card's name and power limit (nvidia-smi), or "cpu"."""
    if device == "cpu":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return smi[torch.cuda.current_device()]


def render_md(runs: str, md: str) -> None:
    """docs/PORT_QUALITY.md from every row of `runs`: the latest row a
    (geometry, clip, weights, mp4, device), in the JAX tool's columns."""
    rows = []
    if os.path.exists(runs):
        with open(runs) as f:
            rows = [json.loads(line) for line in f if line.strip()]
    latest = {(r["geometry"], r["clip"], r["weights"], r["mp4"], r["device"]): r for r in rows}
    with open(md, "w") as f:
        f.write(
            "# Tracking quality of the PyTorch port — RMSE against ground truth\n\n"
            "Errors in pixels against the procedural ground truth (io/synthetic.py), measured by "
            "`tools/port_eval_quality.py` with the port (`vitparticlefiltertracker_tpu_torch`) over the clip "
            "families, geometries, seeds and mp4 path of `tools/eval_quality.py`, whose rows for the JAX "
            "package stay in `docs/QUALITY.md`. `weights`: `random` = the seeded random init (the JAX package's, "
            "bit for bit); `trained` = `checkpoints/vit_b16_tracking.npz`; `trained-auto` = the head-only "
            "`checkpoints/vit_b16_head.npz` with the automatic head blend. `final5` = mean error over the last 5 "
            "frames; `lost%` = frames flagged lost; teleport scores the frames after the reappearance. `device`: "
            "the card (name, power limit) or cpu; on the card the model runs in bfloat16.\n\n"
            "| geometry | clip | weights | RMSE | final-5 | max | lost% | device | seeds x frames |\n"
            "|---|---|---|---|---|---|---|---|---|\n")
        for r in sorted(latest.values(), key=lambda r: (r["geometry"], r["clip"], r["weights"], r["mp4"])):
            f.write(f"| {r['geometry']} | {r['clip'] + ('+mp4' if r['mp4'] else '')} | {r['weights']} | "
                    f"{r['rmse_px']} | {r['final5_px']} | {r['max_px']} | {int(round(100 * r['lost_frac']))}% | "
                    f"{r['device']} | {len(r['seeds'])} x {r['frames']} |\n")
    print(f"wrote {md}", file=sys.stderr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--geometry", default="flagship", choices=sorted(GEOMETRIES))
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--label", default="")  # row label; default from checkpoint
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--mp4", action="store_true")
    ap.add_argument("--clips", nargs="+", default=None)
    ap.add_argument("--set", action="append", default=[], dest="sets", metavar="K=V",
                    help="config override applied to every clip (after the clip's own)")
    ap.add_argument("--frame-size", type=int, nargs=2, default=None, help="H W instead of the geometry's")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--runs", default=RUNS, help="the JSONL file rows are appended to")
    ap.add_argument("--md", default=MD, help="the table rendered from --runs")
    args = ap.parse_args(argv)
    if args.device != "cpu":
        if not torch.cuda.is_available():
            raise SystemExit("port_eval_quality: no card (torch.cuda.is_available() is False); use --device cpu")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    geo = GEOMETRIES[args.geometry]
    weights = args.label or ("trained" if args.checkpoint else "random")
    frame = tuple(args.frame_size or geo["frame"])
    device = card_name(args.device)
    new_rows = []
    for clip in args.clips or geo["clips"]:
        cfg = build_cfg(geo, clip, args.checkpoint, args.sets, args.device)
        runner = run_banked if cfg.runtime.banks > 1 else run_single
        rmses, final5, max_errs, lost_frac = [], [], [], []
        for seed in args.seeds:
            err, lost, _ = runner(cfg, clip, seed, args.frames, frame, args.mp4, args.device)
            rmses.append(float(np.sqrt(np.mean(err**2))))
            final5.append(float(err[-5:].mean()))
            max_errs.append(float(err.max()))
            lost_frac.append(float(lost.mean()))
            print(f"{args.geometry}/{clip}/{weights} seed={seed}: rmse={rmses[-1]:.2f}px final5={final5[-1]:.2f} "
                  f"max={max_errs[-1]:.2f} lost%={100 * lost_frac[-1]:.0f}", file=sys.stderr, flush=True)
        new_rows.append({
            "geometry": args.geometry, "clip": clip, "weights": weights, "mp4": bool(args.mp4), "device": device,
            "rmse_px": round(float(np.mean(rmses)), 2), "final5_px": round(float(np.mean(final5)), 2),
            "max_px": round(float(np.mean(max_errs)), 2), "lost_frac": round(float(np.mean(lost_frac)), 2),
            "rmse_px_by_seed": rmses, "seeds": args.seeds, "frames": args.frames, "frame": list(frame),
            "checkpoint": args.checkpoint, "sets": args.sets, "torch": torch.__version__,
        })
    os.makedirs(os.path.dirname(os.path.abspath(args.runs)), exist_ok=True)
    with open(args.runs, "a") as f:
        for r in new_rows:
            f.write(json.dumps(r) + "\n")
    render_md(args.runs, args.md)
    print(json.dumps(new_rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
