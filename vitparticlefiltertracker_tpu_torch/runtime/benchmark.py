"""Benchmark harness: frames/s, p50/p99 step latency, the device span of a
step and MFU on one card — the port's counterpart of the JAX package's
``runtime/benchmark.py``, with its phases in its order and its result keys.

The measured unit is the tracker's whole step (propagate -> features ->
likelihood -> estimate -> resample), one CUDA graph replay on the card, over
frames staged on the card in one transfer, so that the numbers isolate the
card's work; runtime/streaming.py covers the decode -> track pipeline.
Every timing ends in a read of the step's position on the host.
"""

from __future__ import annotations

import sys
import time
from typing import Any

import numpy as np
import torch

from vitparticlefiltertracker_tpu_torch.config import Config
from vitparticlefiltertracker_tpu_torch.io.video import open_source
from vitparticlefiltertracker_tpu_torch.utils.platform import resolve_device
from vitparticlefiltertracker_tpu_torch.utils.profiling import profiled_step_device_ms, trace


def _log(msg: str, verbose: bool) -> None:
    if verbose:
        print(f"[bench +{time.perf_counter() - _log.t0:7.1f}s] {msg}", file=sys.stderr, flush=True)


# Published dense peaks of one H100 SXM at its 700 W limit (NVIDIA's data
# sheet), TFLOP/s: bf16 on the tensor cores; float32 outside them, the port's
# f32 products running with TF32 off; TF32 where the caller turned it on.
_H100_PEAK_TFLOPS = {"bfloat16": 989.0, "float32": 67.0, "tf32": 495.0}


def peak_tflops(dtype: str, device: torch.device) -> tuple[float | None, str | None]:
    """(peak TFLOP/s, its basis) for the MFU of a run in `dtype` on `device`:
    the H100 table on a card whose name holds "H100", else (None, None)."""
    if device.type != "cuda" or "H100" not in torch.cuda.get_device_name(device):
        return None, None
    key = "tf32" if dtype == "float32" and torch.backends.cuda.matmul.allow_tf32 else dtype
    peak = _H100_PEAK_TFLOPS[key]
    return peak, f"H100 SXM dense {key} peak, {peak:g} TFLOP/s at 700 W"


def estimate_flops_per_frame(cfg: Config) -> float:
    """Matmul FLOPs of one tracker step (ViT forward(s) + ROI pooling), the
    JAX package's count term for term.

    Standard transformer accounting (2 FLOPs/MAC): per token per block
    8d² (qkv+out projections) + 4Td (QKᵀ and PV) + 4·d·mlp, plus the patch
    embed GEMM. Dense mode runs one window forward per frame (xK banks);
    crop mode runs N crop forwards. ROI pooling (hat-weight contractions,
    ops/image.py) is included; window extraction and the filter are <1% and
    ignored. This is the algorithmic count: dense mode's point is that it is
    small (one batch-1 window forward serves all N hypotheses).
    """
    m = cfg.model
    d, mlp, depth, p = m.dim, m.mlp_dim, m.depth, m.patch_size
    n = cfg.filter.num_particles
    banks = max(1, cfg.runtime.banks)
    if cfg.tracker.mode == "crop":
        t = (cfg.tracker.crop_size // p) ** 2
        forwards = n * banks
    else:
        t = (m.image_size // p) ** 2
        forwards = banks
    per_fwd = depth * t * (8 * d * d + 4 * t * d + 4 * d * mlp) + t * 2 * (p * p * 3) * d
    vit = forwards * per_fwd
    roi = 0.0
    if cfg.tracker.mode == "dense":
        g = m.image_size // p
        k = cfg.tracker.roi_grid
        if cfg.tracker.appearance == "cells":
            roi = banks * n * (2 * k * g * g * d + 2 * k * k * g * d)
        else:
            roi = banks * n * (2 * g * g * d + 2 * g * d)
    return float(vit + roi)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_benchmark(
    cfg: Config,
    warmup: int = 5,
    measure_frames: int = 200,
    latency_frames: int = 16,
    stage_frames: int = 8,
    verbose: bool = True,
    device="cuda",
) -> dict[str, Any]:
    """Benchmark the tracker on the config's source -> a JSON-able dict.

    Runs on the card unless device="cpu". The JAX package's keys with its
    meanings, plus config.device (the card's name, or "cpu"), peak_tflops
    and peak_basis (the MFU's basis; None off an H100), peak_memory_mib
    (torch.cuda.max_memory_allocated over the run; None on the CPU) and
    steps (the tracker steps the run took after init). Phases, in order:
    init (which captures the step's CUDA graph at the clip's frame shape, so
    no capture lands in a timing), the rotation staged in one transfer,
    warm-up, per-step latency, the device span (CUDA events around each step
    of a 24-step burst; on the CPU the JAX package's two-length
    differencing), the readback round trip, serving throughput (chunks of 10
    steps) and offline throughput (track_clip_device over the rotation,
    traced into runtime.profile_dir when set).
    """
    _log.t0 = time.perf_counter()
    cfg.resolve()
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    source = open_source(
        cfg.io.source,
        num_frames=stage_frames + 1,  # exactly the rotation + init frame
        frame_size=tuple(cfg.io.frame_size),
        seed=cfg.filter.seed,
    )
    frames = np.stack(list(source))
    init_bbox = getattr(source, "init_bbox", None)
    if init_bbox is None:
        init_bbox = np.asarray(cfg.io.init_bbox, np.float32)
    _log(f"clip ready: {frames.shape}", verbose)

    if cfg.runtime.banks > 1:
        from vitparticlefiltertracker_tpu_torch.runtime.banked import MultiTracker, banked_bboxes

        tracker = MultiTracker(cfg, device=dev)
        tracker.init(frames[0], banked_bboxes(init_bbox, cfg.runtime.banks))
    else:
        from vitparticlefiltertracker_tpu_torch.runtime.tracker import Tracker

        tracker = Tracker(cfg, device=dev)
        tracker.init(frames[0], init_bbox)
    _sync(dev)
    _log("tracker initialized (step graph captured)", verbose)

    # The frame rotation on the device in one transfer.
    dev_clip = torch.from_numpy(frames[1 : 1 + stage_frames]).to(dev)
    dev_frames = list(dev_clip)
    _sync(dev)
    n_rot = len(dev_frames)
    _log(f"{n_rot} frames staged on the device", verbose)
    steps = 0

    def step(i: int):
        nonlocal steps
        steps += 1
        return tracker.step_device(dev_frames[i % n_rot])

    # Every timing below ends in a read of a step's position on the host:
    # the tracked position is the product of a step.
    for i in range(warmup):
        step(i).position.cpu()
    _log("step warm", verbose)

    # Latency: each step's position read back (per-frame serving latency).
    lat_ms = []
    for i in range(latency_frames):
        t0 = time.perf_counter()
        step(i).position.cpu()
        lat_ms.append((time.perf_counter() - t0) * 1e3)
    _log(f"latency sampled: p50={np.percentile(lat_ms, 50):.2f}ms", verbose)

    # The device span of a step: CUDA events around each step of a burst.
    dev_ms = profiled_step_device_ms(step, dev)
    dev_src = "cuda_events"
    if dev_ms is None:
        # The CPU: two-length differencing, as the JAX package does without
        # a device plane: time a drain of N dispatched steps and of 2N; the
        # slope cancels the constant dispatch and readback cost.
        def _drain(n: int) -> float:
            t0 = time.perf_counter()
            for i in range(n):
                o = step(i)
            o.position.cpu()
            return time.perf_counter() - t0

        n_diff = max(8, latency_frames)
        _drain(2)  # touch the path once more before timing
        t_n, t_2n = _drain(n_diff), _drain(2 * n_diff)
        dev_ms = (t_2n - t_n) / n_diff * 1e3
        dev_src = "two_length_differencing"
        if dev_ms <= 0.0:
            # A negative slope: timing noise swamped the measurement. Flag
            # it invalid rather than report a clamped 0.
            dev_ms = float("nan")
            dev_src = "two_length_differencing_invalid"
    _log(f"device step span ~{dev_ms:.3f} ms ({dev_src})", verbose)

    # Host<->device round trip of one readback: a one-element add, read back.
    tiny = torch.zeros((1,), dtype=torch.float32, device=dev) + 1
    tiny.cpu()
    rtts = []
    for _ in range(5):
        t0 = time.perf_counter()
        tiny = tiny + 1
        tiny.cpu()
        rtts.append((time.perf_counter() - t0) * 1e3)
    rtt_ms = float(np.median(rtts))
    _log(f"host<->device readback RTT ~{rtt_ms:.3f} ms", verbose)

    # Serving throughput: dispatch `chunk` steps, read back the last one's
    # position; every chunk's results are materialized.
    chunk = 10
    t0 = time.perf_counter()
    done = 0
    while done < measure_frames:
        for j in range(chunk):
            out = step(done + j)
        out.position.cpu()
        done += chunk
    dt = time.perf_counter() - t0
    fps_serving = done / dt
    _log(f"serving throughput: {fps_serving:.1f} fps (chunk={chunk})", verbose)

    # Offline throughput: track_clip_device over the staged rotation (a
    # replay a frame, no host wait between frames), every position read back.
    outs = tracker.track_clip_device(dev_clip)  # warm
    outs.position.cpu()
    reps = max(1, measure_frames // n_rot)
    with trace(cfg.runtime.profile_dir):
        t0 = time.perf_counter()
        for _ in range(reps):
            outs = tracker.track_clip_device(dev_clip)
            outs.position.cpu()  # all T positions materialized
        dt = time.perf_counter() - t0
    steps += (1 + reps) * n_rot
    fps = reps * n_rot / dt
    _log(f"offline throughput: {fps:.1f} fps ({reps}x{n_rot} frames, track_clip_device)", verbose)

    lat = np.asarray(lat_ms)
    p50 = float(np.percentile(lat, 50))
    flops_frame = estimate_flops_per_frame(cfg)
    achieved_tflops = flops_frame * fps / 1e12
    peak, basis = peak_tflops(cfg.model.dtype, dev)
    return {
        "config": {
            "model": cfg.model.variant,
            "image_size": cfg.model.image_size,
            "dtype": cfg.model.dtype,
            "mode": cfg.tracker.mode,
            "num_particles": cfg.filter.num_particles,
            "banks": cfg.runtime.banks,
            "frame_size": list(cfg.io.frame_size),
            "backend": dev.type,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        },
        "fps": fps,
        "fps_serving": fps_serving,
        "p50_ms": p50,
        "p99_ms": float(np.percentile(lat, 99)),
        "mean_ms": float(lat.mean()),
        "rtt_ms": rtt_ms,
        # The device span of one step (CUDA events on the card; the CPU's
        # wall-clock slope otherwise); p50_device_source says which.
        "p50_device_ms": float(dev_ms),
        "p50_device_source": dev_src,
        "frames_measured": int(measure_frames),
        # Efficiency on the offline fps: the algorithmic FLOP count of a
        # step against the card's published peak for the run's dtype.
        "est_gflops_per_frame": round(flops_frame / 1e9, 2),
        "achieved_tflops": round(achieved_tflops, 3),
        "mfu": round(achieved_tflops / peak, 4) if peak else None,
        "peak_tflops": peak,
        "peak_basis": basis,
        "peak_memory_mib": torch.cuda.max_memory_allocated(dev) / 2**20 if dev.type == "cuda" else None,
        "steps": steps,
    }
