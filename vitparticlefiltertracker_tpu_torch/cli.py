"""Command line: ``python -m vitparticlefiltertracker_tpu_torch track --config config.yaml``.

Writes the same JSONL records as the JAX package's ``python main.py track``.
Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from vitparticlefiltertracker_tpu_torch.config import Config, apply_override, load_config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vpt-torch", description="ViT + particle-filter tracker (PyTorch / CUDA port)"
    )
    p.add_argument("command", nargs="?", default="track", choices=["track"])
    p.add_argument("--config", "-c", default="", help="path to config.yaml")
    p.add_argument(
        "--set",
        dest="overrides",
        action="append",
        default=[],
        metavar="KEY.PATH=VALUE",
        help="override config values, e.g. --set filter.num_particles=4096",
    )
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    p.add_argument("--quiet", "-q", action="store_true", help="suppress stderr summary")
    return p


def load(args, implicit_config: bool = False) -> Config:
    if args.config:
        return load_config(args.config, args.overrides)
    if implicit_config and os.path.exists("config.yaml"):
        return load_config("config.yaml", args.overrides)
    cfg = Config()
    for ov in args.overrides:
        apply_override(cfg, ov)
    return cfg.resolve()


def cmd_track(cfg: Config, device: str = "cuda", quiet: bool = False) -> int:
    """Track io.source and write one JSONL record a frame; with
    runtime.banks > 1, a MultiTracker over the source's targets (or its one
    box, tiled) writes one record a bank a frame."""
    from vitparticlefiltertracker_tpu_torch.io.sink import JsonlSink
    from vitparticlefiltertracker_tpu_torch.io.video import open_source

    if cfg.io.overlay:
        raise NotImplementedError("io.overlay is not ported yet; see ROADMAP.md")
    banks = cfg.runtime.banks
    if cfg.io.resume_state and banks > 1:
        raise ValueError("io.resume_state supports a single tracker (runtime.banks == 1)")
    source = open_source(
        cfg.io.source,
        num_frames=cfg.io.num_frames,
        frame_size=tuple(cfg.io.frame_size),
        seed=cfg.filter.seed,
    )
    sink = JsonlSink(cfg.io.output)
    t_start = time.perf_counter()
    count = 0
    frames_iter = iter(source)
    if not cfg.io.resume_state:
        frame0 = next(frames_iter)
        bbox = getattr(source, "init_bbox", None)
        if bbox is None:
            bbox = cfg.io.init_bbox
    if banks > 1:
        from vitparticlefiltertracker_tpu_torch.runtime.banked import MultiTracker, banked_bboxes

        tracker = MultiTracker(cfg, device=device)
        tracker.init(frame0, banked_bboxes(bbox, banks))
        for i, frame in enumerate(frames_iter):
            for rec in tracker.step(frame):
                rec["frame"] = i + 1
                sink.write(rec)
            count += 1
    else:
        from vitparticlefiltertracker_tpu_torch.runtime.tracker import Tracker

        tracker = Tracker(cfg, device=device)
        if cfg.io.resume_state:
            tracker.resume(cfg.io.resume_state)
            base = int(tracker.state.frame_idx)
        else:
            tracker.init(frame0, bbox)
            base = 0
        for i, frame in enumerate(frames_iter):
            rec = tracker.step(frame)
            rec["frame"] = base + i + 1
            sink.write(rec)
            count += 1
        if cfg.io.save_state:
            tracker.save(cfg.io.save_state)
            if not quiet:
                print(f"saved state to {cfg.io.save_state}", file=sys.stderr)
    wall = time.perf_counter() - t_start
    sink.close()
    if not quiet and count:
        print(f"tracked {count} frames in {wall:.2f}s ({count / wall:.1f} fps)", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = load(args, implicit_config=argv is None)
    return cmd_track(cfg, args.device, args.quiet)


if __name__ == "__main__":
    sys.exit(main())
