#!/usr/bin/env python3
"""Where the time of the port's tracker step goes, on the card.

Runs the main path of chip_smoke.py (config.yaml, the B/16 checkpoint,
480x640 synthetic:moving-square) for --warmup frames, then profiles
--frames steps with torch.profiler and prints: the host-clock step time,
the device-busy share (summed kernel time over the window's wall time), and
the kernels with the most device time. Each step is a replay of the
tracker's captured CUDA graph, as Tracker.step runs it on the card; the
device time of one step is also timed by replaying the step's graph back
to back between CUDA events (after the warm-up frames; a lost state takes
its branches on every replay). --eager profiles the same step run
eagerly (Tracker(graphs=False)). Each --set section.key=value
(repeatable; the value read as JSON, else as a string) overrides the
config, so the crop main path is one option away. --robust starts from
chip_smoke.py's robust path instead (configs/robust-head.yaml with the
teleport gates, the head checkpoint, synthetic:teleport): its 48-frame clip
holds the lost frames, the probes and the re-detection scans, so use
--warmup 10 --frames 37 to profile all of them. --syncs then runs the same
frames again under torch.cuda.set_sync_debug_mode("warn") and prints how
many times the host waited for the card in each step (every device-to-host
read, stream or device synchronize and copy from pageable host memory;
Tracker.step's one wait for its record is one), by the branches the step
ran on the card. --banks K starts from chip_smoke.py's banked path instead
(configs/eval4-tpu-multiobject-720p.yaml's values, 720x1280
synthetic:multi-K, one MultiTracker of K banks, each on its own target);
--streams K from its multi-stream path (config.yaml's values, a
MultiStreamTracker over K moving-square clips seeded 0..K-1, step_packed and
the row read back a step). For these and --robust it also prints the host
time of a step's noise draws (K generators and 4 K draws, stacked and
copied into the graph's buffers, between synchronizes; with re-detection
configured, also the reseed draw every step makes) beside the step time. Imports only the port;
needs a card.

Usage: python3 tools/port_profile_step.py [--frames 20] [--warmup 10] [--top 15] [--eager]
           [--set tracker.mode=crop --set tracker.crop_impl=window-pallas]
       python3 tools/port_profile_step.py --robust --warmup 10 --frames 37 --syncs
       python3 tools/port_profile_step.py --banks 8
       python3 tools/port_profile_step.py --streams 4
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
from vitparticlefiltertracker_tpu_torch.config import Config  # noqa: E402
from vitparticlefiltertracker_tpu_torch.filters.particle import draw_reseed_noise, draw_step_noise  # noqa: E402
from vitparticlefiltertracker_tpu_torch.io.video import open_source  # noqa: E402
from vitparticlefiltertracker_tpu_torch.runtime.banked import MultiStreamTracker, MultiTracker  # noqa: E402
from vitparticlefiltertracker_tpu_torch.runtime.tracker import Tracker  # noqa: E402
from vitparticlefiltertracker_tpu_torch.utils.profiling import device_kernels  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--set", dest="overrides", action="append", default=[], metavar="SECTION.KEY=VALUE")
    ap.add_argument("--robust", action="store_true", help="chip_smoke.py's robust path as the base config")
    ap.add_argument("--syncs", action="store_true", help="count the host's waits for the card in each step")
    ap.add_argument("--eager", action="store_true", help="run the step eagerly instead of replaying its graph")
    group = ap.add_mutually_exclusive_group()
    group.add_argument("--banks", type=int, default=0, metavar="K",
                       help="chip_smoke.py's banked path (eval4) with K banks on synthetic:multi-K")
    group.add_argument("--streams", type=int, default=0, metavar="K",
                       help="chip_smoke.py's multi-stream path with K streams")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.robust:
        d = copy.deepcopy(chip_smoke.ROBUST_CONFIG)
        d["model"]["checkpoint"] = str(chip_smoke.ROOT / chip_smoke.HEAD_CHECKPOINT)
    elif args.banks:
        d = copy.deepcopy(chip_smoke.BANKED_CONFIG)
        d["model"]["checkpoint"] = str(chip_smoke.ROOT / chip_smoke.CHECKPOINT)
        d["runtime"]["banks"] = args.banks
        d["io"]["source"] = f"synthetic:multi-{args.banks}"
    else:
        d = copy.deepcopy(chip_smoke.SMOKE_CONFIG)
        d["model"]["checkpoint"] = str(chip_smoke.ROOT / chip_smoke.CHECKPOINT)
    n_total = 1 + args.warmup + args.frames
    d["io"]["num_frames"] = n_total
    for item in args.overrides:
        path, value = item.split("=", 1)
        section, key = path.split(".", 1)
        try:
            d.setdefault(section, {})[key] = json.loads(value)
        except json.JSONDecodeError:
            d[section][key] = value
    cfg = Config.from_dict(d)
    graphs = not args.eager
    size = tuple(cfg.io.frame_size)
    if args.streams:
        srcs = [open_source(cfg.io.source, n_total, size, seed=cfg.filter.seed + i) for i in range(args.streams)]
        clips = np.stack([np.stack(x.frames) for x in srcs], axis=1)  # [T, K, H, W, 3]
        tr = MultiStreamTracker(cfg, args.streams, device="cuda", graphs=graphs)
        tr.init(clips[0], np.stack([x.init_bbox for x in srcs]))
        frames = list(torch.from_numpy(clips).cuda())

        def step(f):
            tr.step_packed(f).cpu()  # the row read back, as the serve command reads it
    else:
        src = open_source(cfg.io.source, n_total, size, seed=cfg.filter.seed)
        tr = MultiTracker(cfg, device="cuda", graphs=graphs) if args.banks else Tracker(cfg, device="cuda",
                                                                                       graphs=graphs)
        frames = list(src)
        tr.init(frames[0], src.init_bbox)
        step = tr.step
    for f in frames[1 : 1 + args.warmup]:
        step(f)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in frames[1 + args.warmup :]:
            step(f)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_kernels(prof)  # name -> (ms, calls), device-side events only
    busy_us = sum(v.ms for v in rows.values()) * 1e3
    launches = sum(v.calls for v in rows.values())
    print(f"card: {torch.cuda.get_device_name(0)}; overrides {args.overrides}; "
          f"{'graph replay' if graphs else 'eager'} step")
    print(f"steps {args.frames}: wall {wall_us / args.frames / 1e3:.3f} ms/step (profiler on), "
          f"device busy {busy_us / args.frames / 1e3:.3f} ms/step = {100 * busy_us / wall_us:.1f}% "
          f"of wall, {launches / args.frames:.0f} kernels/step")
    # The port's own kernels by source: K1's paths (attn_small_kernel,
    # attn_tiled_*_kernel) and K2's (window_patchify_mma_kernel<tile>,
    # window_patchify_scalar_kernel<dtype>).
    for label, marks in (("K1", ("attn_small_kernel", "attn_tiled_")), ("K2", ("window_patchify_",))):
        mine = {k: v for k, v in rows.items() if any(m in k for m in marks)}
        us = sum(v.ms for v in mine.values()) * 1e3
        calls = sum(v.calls for v in mine.values())
        print(f"  {label}: {us / args.frames:9.1f} us/step  {calls / args.frames:6.1f}/step  "
              f"{100 * us / busy_us:5.1f}%  ({', '.join(sorted({k[:60] for k in mine})) or 'not launched'})")
    for k, v in sorted(rows.items(), key=lambda kv: -kv[1].ms)[: args.top]:
        print(f"  {v.ms * 1e3 / args.frames:9.1f} us/step  {v.calls / args.frames:6.1f}/step  "
              f"{100 * v.ms * 1e3 / busy_us:5.1f}%  {k[:110]}")
    if graphs:
        print(f"device time of one step, its graph replayed back to back: {replay_ms(tr):.3f} ms")
    if args.banks or args.streams or args.robust:
        t0 = time.perf_counter()
        for f in frames[1 + args.warmup :]:
            step(f)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / args.frames
        noise, reseed = noise_ms(tr), noise_ms(tr, reseed=True)
        print(f"host noise draws of {tr._k} filters: {noise:.3f} ms a step ({4 * tr._k} draws and "
              f"{tr._k} generators), against {step_ms:.3f} ms a step without the profiler: "
              f"{100 * noise / step_ms:.1f}%")
        if tr._n_after > 0:
            print(f"  with the reseed draw every step: {reseed:.3f} ms ({100 * reseed / step_ms:.1f}%; the reseed "
                  f"alone {reseed - noise:.3f} ms)")
    if args.syncs and not (args.banks or args.streams):
        count_syncs(cfg, frames, src.init_bbox, graphs)
    return 0


def replay_ms(tr: Tracker, reps: int = 20) -> float:
    """Device time of one step: the step's graph replayed `reps` times
    between CUDA events (the tracker state advances; use last)."""
    graph = next(iter(tr._step_graphs.values())).graph
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def noise_ms(tr, reps: int = 20, reseed: bool = False) -> float:
    """Host clock of one step's noise draws, as the tracker makes them
    before a replay: every bank's generator and 4 draws, stacked, and (with
    graphs) copied into the graph's noise buffers; with `reseed`, also the
    reseed normals; between synchronizes."""
    sg = next(iter(tr._step_graphs.values())) if tr.graphs else None
    seeds, idx = tr._seed.tolist(), tr._frame_idx.tolist()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        noise = draw_step_noise(seeds, idx, tr._n, tr.device)
        if sg is not None:
            for dst, src in zip(sg.noise, noise):
                dst.copy_(src)
        if reseed:
            normals = draw_reseed_noise(seeds, idx, tr._n, tr.device)
            if sg is not None:
                sg.reseed.copy_(normals)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def count_syncs(cfg: Config, frames, bbox, graphs: bool) -> None:
    """Each step of a fresh tracker over `frames` under the sync debug mode
    (chip_smoke.count_waits): the host's waits for the card a step, by the
    branches it ran (the probe where the state before it was lost, the scan
    where it triggered, both, neither), read from the states afterwards."""
    tr = Tracker(cfg, device="cuda", graphs=graphs)
    tr.init(frames[0], bbox)
    n_after = cfg.tracker.redetect_global_after
    by_kind = defaultdict(list)
    triggered = 0
    shown = 0
    for f in frames[1:]:
        probe = bool(tr.state.lost)
        stacks = []
        waits = chip_smoke.count_waits(lambda f=f: tr.step(f), stacks)
        scan = n_after > 0 and chip_smoke.scan_accepted(tr.state, n_after)[0]
        by_kind[("probe " if probe else "") + ("scan" if scan else "") or "locked"].append(waits)
        triggered += scan
        if waits > 1 and shown < 2:  # where the waits beyond the record's are
            shown += 1
            for stack in stacks:
                print(f"  a wait, at:\n{stack}")
    for kind, counts in sorted(by_kind.items()):
        print(f"  host waits a step ({'graph' if graphs else 'eager'}), {kind}: {min(counts)}-{max(counts)} over "
              f"{len(counts)} steps")
    if n_after > 0:
        print(f"  scans triggered: {triggered}")


if __name__ == "__main__":
    sys.exit(main())
