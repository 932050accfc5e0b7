"""Command line: ``python -m vitparticlefiltertracker_tpu_torch track --config config.yaml``.

Subcommands: track (default), bench (the benchmark harness: one JSON line),
stream (the decode -> track pipeline with trailing readback), train
(feature training, config section ``train:``) and serve (K videos batched in
one step). Each prints or writes what the JAX package's
command of that name does. Runs on the card unless ``--device cpu`` is
given.

On several cards: ``torchrun --nproc-per-node N -m
vitparticlefiltertracker_tpu_torch track --set runtime.mesh_particles=N``
(or mesh_banks with runtime.banks, mesh_model; ``train`` goes data-parallel
over the N ranks). Every rank opens the same deterministic source and runs
the same steps; rank 0 alone writes the records, state files and the bench
line. ``stream`` and ``serve`` under a mesh, and a camera or the native
ring as a mesh's source, are not supported yet (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from vitparticlefiltertracker_tpu_torch.config import Config, apply_override, load_config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vpt-torch", description="ViT + particle-filter tracker (PyTorch / CUDA port)"
    )
    p.add_argument("command", nargs="?", default="track", choices=["track", "bench", "stream", "train", "serve"])
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


def _mesh_rank(cfg: Config, device: str, command: str) -> int:
    """This process's rank when the config (runtime.mesh_*) or the launcher
    (WORLD_SIZE) spreads the command over ranks, after initialising the
    process group (which makes the rank's card current); 0 otherwise."""
    r = cfg.runtime
    meshed = r.mesh_banks * r.mesh_particles * r.mesh_model > 1
    if not meshed and int(os.environ.get("WORLD_SIZE", 1)) <= 1:
        return 0
    if meshed and command in ("stream", "serve"):
        raise NotImplementedError(f"the {command} command under a mesh (runtime.mesh_*) needs its frames read once "
                                  "and broadcast to the ranks; not supported yet (ROADMAP.md §1)")
    src = cfg.io.source
    if meshed and (src.startswith(("camera:", "native-synthetic:")) or src.endswith(".rgb24")):
        raise NotImplementedError(f"io.source {src!r} under a mesh: every rank must read the same frames, which "
                                  "a camera or the native ring does not give; not supported yet (ROADMAP.md §1)")
    from vitparticlefiltertracker_tpu_torch.parallel.mesh import init_distributed

    init_distributed(device)
    import torch.distributed as dist

    return dist.get_rank()


class _NullSink:
    """The sink of a rank other than 0: records are written once, by rank 0."""

    def write(self, rec) -> None:
        pass

    def close(self) -> None:
        pass


def cmd_track(cfg: Config, device: str = "cuda", quiet: bool = False) -> int:
    """Track io.source and write one JSONL record a frame; with
    runtime.banks > 1, a MultiTracker over the source's targets (or its one
    box, tiled) writes one record a bank a frame. io.overlay names a video
    the tracked boxes are drawn into (every bank's with banks)."""
    from vitparticlefiltertracker_tpu_torch.io.sink import JsonlSink, OverlaySink

    banks = cfg.runtime.banks
    if cfg.io.resume_state and banks > 1:
        raise ValueError("io.resume_state supports a single tracker (runtime.banks == 1)")
    rank = _mesh_rank(cfg, device, "track")
    quiet = quiet or rank != 0
    source = _open(cfg, cfg.io.source, cfg.filter.seed)
    sink = JsonlSink(cfg.io.output) if rank == 0 else _NullSink()
    overlay = OverlaySink(cfg.io.overlay) if cfg.io.overlay and rank == 0 else None
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
            recs = tracker.step(frame)
            for rec in recs:
                rec["frame"] = i + 1
                sink.write(rec)
            if overlay is not None:
                overlay.write_multi(frame, recs)
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
            if overlay is not None:
                overlay.write(frame, rec)
            count += 1
        if cfg.io.save_state:
            tracker.save(cfg.io.save_state)
            if not quiet:
                print(f"saved state to {cfg.io.save_state}", file=sys.stderr)
    wall = time.perf_counter() - t_start
    sink.close()
    if overlay is not None:
        overlay.close()
    if not quiet and count:
        print(f"tracked {count} frames in {wall:.2f}s ({count / wall:.1f} fps)", file=sys.stderr)
    return 0


def cmd_bench(cfg: Config, device: str = "cuda", quiet: bool = False) -> int:
    """The benchmark harness (runtime/benchmark.py) on the config's source:
    one JSON line on stdout; its progress on stderr unless quiet."""
    from vitparticlefiltertracker_tpu_torch.runtime.benchmark import run_benchmark

    rank = _mesh_rank(cfg, device, "bench")
    result = run_benchmark(cfg, verbose=not quiet and rank == 0, device=device)
    if rank == 0:
        print(json.dumps(result))
    return 0


def _open(cfg: Config, spec: str, seed: int):
    from vitparticlefiltertracker_tpu_torch.io.video import open_source

    return open_source(spec, num_frames=cfg.io.num_frames, frame_size=tuple(cfg.io.frame_size), seed=seed)


def stream_kwargs(cfg: Config) -> dict:
    """stream_track's arguments from the config's runtime.stream_* keys, as
    the stream command passes them (ROI streaming for one filter only)."""
    rt = cfg.runtime
    return dict(
        pump_depth=rt.prefetch_frames,
        readback_window=rt.stream_readback,
        roi_px=rt.stream_roi if rt.banks == 1 else 0,
        roi_stride=rt.stream_roi_stride,
        roi_out=rt.stream_roi_out,
        steer_lag=rt.stream_steer_lag,
        glob_stride=rt.stream_glob_stride,
        glob_every=rt.stream_glob_every,
        chunk=rt.stream_chunk if rt.banks == 1 and rt.stream_roi > 0 else 1,
        steer_workers=rt.stream_steer_workers,
        chunk_max=rt.stream_chunk_max,
        fps_target=rt.stream_fps_target,
        lost_throttle=rt.stream_lost_throttle,
    )


def cmd_stream(cfg: Config, device: str = "cuda", quiet: bool = False) -> int:
    """The decode -> track pipeline (runtime/streaming.py): a producer
    thread, pinned staging, one graph replay a frame (or a chunk of ROI
    frames) and trailing readback; ROI streaming with every runtime.stream_*
    key; a MultiTracker with one record a bank when runtime.banks > 1."""
    from vitparticlefiltertracker_tpu_torch.io.sink import JsonlSink
    from vitparticlefiltertracker_tpu_torch.runtime.streaming import stream_track

    _mesh_rank(cfg, device, "stream")
    source = _open(cfg, cfg.io.source, cfg.filter.seed)
    init_bbox = getattr(source, "init_bbox", None)
    if init_bbox is None:
        init_bbox = cfg.io.init_bbox
    rt = cfg.runtime
    if rt.banks > 1:
        from vitparticlefiltertracker_tpu_torch.runtime.banked import MultiTracker, banked_bboxes

        tracker = MultiTracker(cfg, device=device)
        init_bbox = banked_bboxes(init_bbox, rt.banks)
    else:
        from vitparticlefiltertracker_tpu_torch.runtime.tracker import Tracker

        tracker = Tracker(cfg, device=device)
    sink = JsonlSink(cfg.io.output)
    stats = stream_track(tracker, source, init_bbox, on_record=sink.write, **stream_kwargs(cfg))
    sink.close()
    if not quiet:
        print(f"streamed {stats['frames']} frames in {stats['wall_s']:.2f}s ({stats['fps']:.1f} fps)",
              file=sys.stderr)
    return 0


def cmd_serve(cfg: Config, device: str = "cuda", quiet: bool = False) -> int:
    """Multi-stream serving: K independent videos batched in one step a
    frame batch (MultiStreamTracker). Sources: io.source as a comma-separated
    list, or one spec replicated runtime.streams times with seeds
    filter.seed + i. One FramePump a source, read in lockstep into
    stream_track's pipeline; one JSONL record a stream a frame, with a
    "stream" field."""
    from vitparticlefiltertracker_tpu_torch.io.sink import JsonlSink
    from vitparticlefiltertracker_tpu_torch.runtime.banked import MultiStreamTracker
    from vitparticlefiltertracker_tpu_torch.runtime.streaming import FramePump, stream_track

    _mesh_rank(cfg, device, "serve")
    specs = [s.strip() for s in cfg.io.source.split(",") if s.strip()]
    if len(specs) == 1:
        specs = specs * cfg.runtime.streams
    k = len(specs)
    sources = [_open(cfg, spec, cfg.filter.seed + i) for i, spec in enumerate(specs)]
    pumps = [iter(FramePump(s, depth=cfg.runtime.prefetch_frames)) for s in sources]
    bboxes = np.stack([np.asarray(s.init_bbox if getattr(s, "init_bbox", None) is not None else cfg.io.init_bbox,
                                  np.float32) for s in sources])

    def lockstep():
        """The K pumps as one [K, H, W, 3] frame stream, to the shortest."""
        while True:
            frames = [next(p, None) for p in pumps]
            if any(f is None for f in frames):
                return
            shapes = {f.shape for f in frames}
            if len(shapes) > 1:
                raise ValueError(f"serve needs equal frame sizes across streams, got {shapes}")
            yield np.stack(frames)

    ms = MultiStreamTracker(cfg, num_streams=k, device=device)
    sink = JsonlSink(cfg.io.output)

    def on_record(rec):
        # One record a frame batch with K-vector fields: one a stream.
        for s in range(k):
            sink.write({"stream": s, "frame": rec["frame"], "position": rec["position"][s], "box": rec["box"][s],
                        "conf": rec["conf"][s], "ess": rec["ess"][s], "lost": rec["lost"][s]})

    stats = stream_track(ms, lockstep(), bboxes, on_record=on_record)
    sink.close()
    if not quiet and stats["frames"]:
        print(f"served {k} streams x {stats['frames']} frames in {stats['wall_s']:.2f}s "
              f"({k * stats['fps']:.1f} fps aggregate, {stats['fps']:.1f} per stream)", file=sys.stderr)
    return 0


def cmd_train(cfg: Config, device: str = "cuda", quiet: bool = False) -> int:
    """Train the ViT's appearance features (training/, config section
    ``train:``): metrics lines on stderr unless quiet, the checkpoint to
    train.checkpoint_out."""
    from vitparticlefiltertracker_tpu_torch.training.train import train_features

    rank = _mesh_rank(cfg, device, "train")
    train_features(cfg, log=(lambda s: None) if quiet or rank != 0 else None, device=device)
    return 0


COMMANDS = {"track": cmd_track, "bench": cmd_bench, "stream": cmd_stream, "train": cmd_train, "serve": cmd_serve}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = load(args, implicit_config=argv is None)
    return COMMANDS[args.command](cfg, args.device, args.quiet)


if __name__ == "__main__":
    sys.exit(main())
