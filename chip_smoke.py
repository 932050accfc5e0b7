#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (vitparticlefiltertracker_tpu_torch).

Run from the root of a checkout, with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, each timed and printed:
  1. device   — card name and power limit; TF32 off for f32 matmuls.
  2. build    — nvcc builds kernels K1 (csrc/flash_attn.cu) and K2
                (csrc/window_patchify.cu), the IF-node helper of the step's
                graph (csrc/graph_if.cu), the "model" axis's peer
                all-reduce (csrc/peer_allreduce.cu), the step's noise
                kernel (csrc/step_noise.cu), DINOv2's SwiGLU gate
                (csrc/swiglu.cu) and the ViT's pre-norm junction
                (csrc/prenorm_junction.cu) into ctypes .so files, the
                compiles started together (a cached library comes with its
                saved ptxas report); prints the ptxas reports, checks that
                no K2 kernel spills and, with cuobjdump -sass, that K2's
                tensor-core kernels hold HMMA instructions, and prints both
                kernels' launch plans at the main paths' shapes.
  3. kernel   — K1 and K2 against their plain PyTorch versions on the card,
                at the dense, crop, banked (B 8) and multi-stream (B 4)
                paths' shapes and beyond; K1 both on views of a fused qkv
                activation (as the ViT passes them) and on contiguous
                tensors; K2 also over 1, 2 and 8 windows of 1024 boxes and
                2 windows of 1 box in one launch; a graph's IF node (a body
                with an f32 product and K1) against the host's branch; the
                step noise kernel (csrc/step_noise.cu) against torch's
                generator draws (filters/particle.py draw_step_noise and
                draw_reseed_noise), bit for bit, at the benchmark cells'
                banks (16 x 1024, 1 x 4096), a ROI chunk of 4 and with the
                reseed normals; the SwiGLU gate against its plain version;
                the pre-norm junction against its plain form at the
                benchmark cells' forwards, the crop path's, f32 and a small
                width, with and without the pending branch and its bias
                (x_new bitwise, y within one ulp).
  4. tracker  — tiny dense and crop configs on the card against the same
                runs on the CPU (and two with global re-detection: dense with
                the residual head and its automatic blend, crop through K2),
                then the three main paths. Two are 60 frames of 480x640
                synthetic:moving-square through Tracker.run with config.yaml's
                values (ViT-B/16, bf16, 1024 particles) and the committed B/16
                checkpoint: dense mode, and crop mode through K2
                (tracker.mode crop, crop_impl window-pallas). Each checks its
                kernels' launch counts (by shape), the lost flags and the
                RMSE. The third, "robust", is configs/robust-head.yaml with
                the teleport gates of tools/eval_quality.py and the automatic
                head blend on 48 frames of 480x640 synthetic:teleport: the
                head-only checkpoints/vit_b16_head.npz with its trunk
                regenerated on the card (timed, and leaves held to the CPU's),
                global re-detection's 49-window scan (K1 at B 49), launches by
                shape against the probes and scans the run's states show
                (each an IF node of the graph, run only where its predicate
                holds), the RMSE after the reappearance and the last
                records' lost flags. Each main
                path runs four times in turns, eagerly and with every step a
                replay of its captured CUDA graph (eager, graph, graph,
                eager): records equal, launches by shape counted per replay,
                both step medians and their ratio, the host's waits (at most
                1 a Tracker.step; none inside track_clip_device on any
                path); dense also runs its 59 steps in one track_clip_device
                call, whose records equal Tracker.run's. Banked trackers
                (runtime/banked.py): tiny banked dense (3 banks, lost gate and
                re-detection), banked crop through K2 over 2 windows and
                3-stream configs on the card against the CPU; the fourth main
                path, "banked": configs/eval4-tpu-multiobject-720p.yaml's
                values (8 banks x 1024 particles) on 48 frames of 720x1280
                synthetic:multi-8, each bank on its own target, through
                MultiTracker in turns eagerly and through the graphs (records
                equal, K1 launches by shape, no lost record, the pooled RMSE,
                step medians, host waits); reinit_bank(1, ...) leaves bank 0's
                records bitwise as they were; the fifth, "multistream":
                MultiStreamTracker over 4 clips of 480x640 moving-square with
                config.yaml's values (K1 launches, each stream's RMSE, the
                aggregate frames/s beside the dense path's); the sixth,
                "dinov2": the dinov2-g14-reg preset's block (width 1536, 24
                heads, SwiGLU 4096, patch 14, the class token and 4
                registers) cut to 2 blocks, seeded LayerScale gammas in the
                weights, on the dense path's clip in turns eagerly and
                through the graphs (records equal, K1 at [1, 24, 261, 64]
                and the SwiGLU kernel at (261, 4096) once a block a
                forward). The dense, crop, robust and dinov2 paths and
                the bench phase also hold the pre-norm junction to 2 depth
                + 1 launches a forward (2 head_depth + 1 more with the
                robust path's head) by (M, D), graph equal to eager.
  5. stream   — stream_track (runtime/streaming.py) over the dense and
                robust paths' clips with a fresh graph Tracker: records
                bitwise equal to Tracker.run's graph records, K1 launches
                equal, no host wait on the submitting thread between init
                and the final completion, the drainer's waits, frames/s and
                the stage times; then the serve command through cli.main
                (4 streams of the dense clip, seeds 0-3, a JSON config
                file): 4 x 59 records, each stream complete and ordered,
                positions equal to the multistream path's graph rows.
  6. stream, roi — ROI streaming (stream_track with the stream command's
                arguments, cli.stream_kwargs): a. eval5-roi-c4,
                configs/eval5-tpu-streaming-4k.yaml at full width (ViT-L/16
                on the port's JAX-exact random init, 16384 particles, 4K
                through the native ring's NativeSyntheticSource, ROI 1600
                shipped as a 288-px view, glob /8 every 4, chunk 4; 60
                frames): frames/s, bytes shipped a frame, submit ms a
                chunk, staging waits, the submitting thread's host waits
                (none in the loop), K1 launches by shape, the RMSE within
                the JAX package's worst plus 2 px; b. eval5-roi-teleport-c4
                (synthetic:teleport at 4K, ROI 1600 at stride 4, 48
                frames): a scan on the glob view inside a chunk graph, K1
                at [25, 16, 196, 64], an accepted re-detection and the
                recovery within the JAX package's worst plus 2 px; c. a
                chunk of 4 against 4 single steps on fixed StreamFrames,
                and adaptive sizing (chunk 2 up to 8, 480x640, ROI 256)
                switching under a forced fps_target; d. a crop-mode ROI
                stream at ViT-B/16 through K2, and K2 on a window resampled
                from a strided ROI view against its plain version.
  7. bench    — runtime/benchmark.py's run_benchmark (the bench command's
                harness) over the five BASELINE configs of
                tools/port_bench_evals.py with small counts (stage 4,
                measure 20, latency 8): one line a config; backend cuda, the
                device span from CUDA events and at most the host-clock p50,
                the MFU in (0, 1) against the H100 basis of its dtype, K1
                launches by shape (eval1 runs f32: the port sends every
                attention on the card to K1), no global scan on eval5's
                device-staged run; then eval3 (ViT-L/16, 4096 particles,
                cells, 1080p needle) through Tracker.run on 30 frames: K1
                24 a frame at [1, 16, 196, 64], the RMSE within the JAX
                package's worst plus 2 px.
  8. train    — feature training (training/). a. tests/test_training.py's
                tiny f32 config: one train step on the card against the CPU
                on the same injected scene batch and draws (loss, metrics,
                every gradient leaf), the trainer's plain attention on the
                card against the CPU, and K1's refusal of an input that
                requires grad. b. configs/train-head.yaml at full width
                (ViT-B/16 with a 2-block head, B 32, canvas 288, window 224,
                bf16 over f32 masters, every term of the objective): the
                step's ms on the card (CUDA events, median after warm-up),
                pairs/s, peak memory and host waits (none) in its own loop,
                the trunk bit-equal to its start; then train_features for 30
                steps with the probe (5 clips x 48 frames, 512 particles) at
                steps 0 and 30: no host wait inside a step, K1 launched by
                the probe only (by shape), the trunk bit-equal to the seeded
                init, a head-only file; the probe after a weight change
                against a fresh probe on the new weights; the file served
                by the robust path on the teleport clip, its trunk
                regenerated bit-equal. c. configs/train-features.yaml (the
                whole backbone) for 10 steps without the probe: the step's
                ms, the bf16 file read through config.yaml's model.checkpoint
                and 30 frames of moving-square tracked on it with K1. The
                outputs go to a temporary directory; nothing under
                checkpoints/ or docs/ changes.
  9. mesh     — the multi-GPU path (parallel/mesh.py) at world size 1: a
                one-rank NCCL group over a file store in a temporary
                directory and make_mesh(1, 1, 1), each path against its
                mesh=None twin: (a) config.yaml's dense path on 60 frames
                (records bitwise or within GRAPH_POS_TOL_PX, the host's
                waits, a replay profiled), (b) eval3 at full width
                (ViT-L/16, 4096 particles, 1080p; its RMSE bound), (c) the
                robust path, whose IF-node bodies (probe, scan) hold the
                forward's peer all-reduces, (d) eval4 banked through
                MultiTracker, (e) configs/train-head.yaml through
                build_train_step(mesh=make_data_mesh(1)) for 3 steps (loss
                and weights bitwise), (f) stream_track over (a)'s clip and
                (g) serve's pipeline over the multistream path's 4 clips,
                each through rank 0's MeshFeed (bitwise). The collectives
                are counted as the kernels are (a gather a scoring pass, 2
                peer all-reduce launches a block of every forward; one
                replay's tally of (a) and (b)) and the step medians of both
                twins printed in turns; the peer kernel at one rank timed.
 10. peer     — two processes spawned on cuda:0 in a gloo group of two
                (NCCL refuses two ranks on one card; CUDA IPC works within
                a card), make_mesh(1, 1, 2): the peer all-reduce kernel over
                f32 partials into bf16 at [1, 196, 768], [1, 196, 1024]
                and [49, 196, 768] (and into f32) against its plain version
                (bitwise), both ranks equal, timed (the two contexts take
                turns on the card), each in the form peer_form picks (it
                prints which) and the scan's shape in both, one-shot and
                two-shot; then the robust path (48 frames of
                teleport) with the ViT split over "model" 2: the graph run,
                whose probe and scan IF-node bodies hold the kernel, against
                the mesh's eager run at every step (GRAPH_POS_TOL_PX), probes
                and scans fired, the peer launches twice K1's, both ranks'
                records equal, its distance from the mesh=None twin
                reported (bf16 products over half the heads round otherwise);
                in float32 on 8 frames, the first step within
                GRAPH_POS_TOL_PX of the twin.
 11. times    — K1, its plain version and torch's scaled_dot_product_attention
                (a yardstick the port never calls) on fused-qkv views at the
                dense, crop (B 1024 and B 1), re-detection, banked (B 8),
                multi-stream (B 4) and eval5 (B 1 and B 25, 16 heads) shapes
                and at a rank's heads under "model" 2 ([1, 6 | 8, 196, 64])
                in bf16, and the dense (eval1's: the split 3xTF32 path) and
                re-detection (the tiled 3xTF32 path) shapes in f32, each
                bound on its path's peak (attention_peak); K2, its
                plain version and cuBLAS's product alone on sampled tokens
                (a yardstick the port never calls) at the crop path's N 1024
                and N 1 (tools/port_k2_times.py), at a rank's N 512 and 256
                on a particle mesh of 2 and 4 cards, and over 8 windows of
                1024 boxes; the step noise kernel at the benchmark cells'
                banks, a ROI chunk, eval4's banks with the reseed and the
                dense, robust and banked paths' shapes, against the host
                draws it replaced (their device and host ms). Device times
                are of one call inside a CUDA graph. The kernels line lists
                the shapes only a mesh of several cards gives (or that no
                path here runs) with 0 launches and the path they belong to.

Prints a JSON line of kernel numbers, then as its last line
{"ok": true, "device": {...}}. Any failed check raises and exits non-zero.
It imports no JAX and no YAML parser; without a card it exits non-zero.
"""

from __future__ import annotations

import contextlib
import copy
import importlib.util
import io
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import warnings
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from vitparticlefiltertracker_tpu_torch.config import VIT_PRESETS, Config
from vitparticlefiltertracker_tpu_torch.filters import particle as pf
from vitparticlefiltertracker_tpu_torch.io.synthetic import teleport_times
from vitparticlefiltertracker_tpu_torch.io.video import open_source
from vitparticlefiltertracker_tpu_torch.models import jax_random
from vitparticlefiltertracker_tpu_torch.models import params as vit_params
from vitparticlefiltertracker_tpu_torch.models.vit import VitSpec, vit_forward_tokens
from vitparticlefiltertracker_tpu_torch.ops import _build, attention
from vitparticlefiltertracker_tpu_torch.ops import peer_allreduce as par
from vitparticlefiltertracker_tpu_torch.ops import patchify_window as pw
from vitparticlefiltertracker_tpu_torch.ops import prenorm_junction as pj
from vitparticlefiltertracker_tpu_torch.ops import step_noise as sn
from vitparticlefiltertracker_tpu_torch.ops import swiglu as sg
from vitparticlefiltertracker_tpu_torch.ops.patchify import crop_sample_coords
from vitparticlefiltertracker_tpu_torch import cli
from vitparticlefiltertracker_tpu_torch.parallel import mesh as pmesh
from vitparticlefiltertracker_tpu_torch.runtime import banked, step_graph
from vitparticlefiltertracker_tpu_torch.runtime.benchmark import run_benchmark
from vitparticlefiltertracker_tpu_torch.runtime.streaming import stream_track
from vitparticlefiltertracker_tpu_torch.runtime.tracker import Tracker, build_tracker_fns, step_branches
from vitparticlefiltertracker_tpu_torch.training.data import make_pair_batch
from vitparticlefiltertracker_tpu_torch.training.objective import draw_loss
from vitparticlefiltertracker_tpu_torch.training.probe import make_probe
from vitparticlefiltertracker_tpu_torch.training.train import (
    _train_embed_spec,
    build_train_step,
    make_data_mesh,
    train_features,
)

ROOT = Path(__file__).resolve().parent


def _load_tool(name: str):
    """tools/<name>.py, loaded by path (tools/ is no package, and another
    installed "tools" would shadow it)."""
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# The timing helpers are shared with tools/port_k1_times.py and
# tools/port_k2_times.py.
_k1_times = _load_tool("port_k1_times")
_k2_times = _load_tool("port_k2_times")
time_eager, time_graph = _k1_times.time_eager, _k1_times.time_graph
CHECKPOINT = "checkpoints/vit_b16_tracking.npz"

# config.yaml's values with one override, model.checkpoint (a CPU test holds
# this dict equal to yaml.safe_load(open("config.yaml")) plus that override).
SMOKE_CONFIG = {
    "model": {
        "variant": "vit-b16",
        "image_size": 224,
        "dtype": "bfloat16",
        "pooling": "mean",
        "use_flash_attention": True,
        "checkpoint": CHECKPOINT,
    },
    "filter": {
        "num_particles": 1024,
        "motion": {"sigma_pos": 4.0, "sigma_vel": 1.0, "sigma_scale": 0.0, "vel_decay": 0.95},
        "likelihood_temp": 20.0,
        "ess_threshold": 0.5,
        "init_sigma_pos": 2.0,
        "init_sigma_vel": 1.0,
        "seed": 0,
    },
    "tracker": {
        "mode": "dense",
        "search_scale": 4.0,
        "roi_grid": 5,
        "template_ema": 0.02,
        "template_update_conf": 0.5,
    },
    "io": {
        "source": "synthetic:moving-square",
        "num_frames": 120,
        "frame_size": [480, 640],
        "output": "",
    },
    "runtime": {"banks": 1, "donate_state": True},
}
FRAMES = 60
# The JAX package on the CPU, same config, clip, checkpoint and 60 frames,
# filter seeds 0-3 (tools/port_rmse_reference.py): RMSE 4.162-4.248 px, no
# lost frame. The noise seed moves it by under 0.1 px; the port draws other
# noise and rounds bf16 elsewhere, so it gets 2 px of room over the worst seed.
JAX_RMSE_PX_MAX = 4.248
RMSE_BOUND_PX = JAX_RMSE_PX_MAX + 2.0

# The crop main path: the same config in crop mode with K2 (ViT-B/16 on
# 32-px crops, 4 tokens each, position embeddings on, 256-px search window).
CROP_OVERRIDES = {"mode": "crop", "crop_impl": "window-pallas"}
# tools/port_rmse_reference.py --set tracker.mode=crop --set
# tracker.crop_impl=window-pallas (the JAX package on the CPU, same clip,
# checkpoint and 60 frames): RMSE 0.714-0.729 px over filter seeds 0-3, no
# lost frame. Same 2 px of room as the dense path.
JAX_CROP_RMSE_PX_MAX = 0.729
CROP_RMSE_BOUND_PX = JAX_CROP_RMSE_PX_MAX + 2.0

# The robust main path: configs/robust-head.yaml's values (a CPU test holds
# this dict equal to load_config("configs/robust-head.yaml") plus the
# overrides) with the teleport clip's gates of tools/eval_quality.py
# (filter.lost_conf_ratio 0.55, tracker.redetect_global_after 3,
# redetect_accept_ratio 0.35, redetect_accept_z 3.0), the automatic head
# blend of docs/QUALITY.md's trained-auto rows, and io.source teleport.
HEAD_CHECKPOINT = "checkpoints/vit_b16_head.npz"
ROBUST_CONFIG = {
    "model": {"variant": "vit-b16", "image_size": 224, "dtype": "bfloat16", "use_flash_attention": True,
              "checkpoint": HEAD_CHECKPOINT, "head_depth": 2, "head_blend": 0.5, "head_blend_auto": True},
    "filter": {"num_particles": 1024, "lost_conf_ratio": 0.55},
    "tracker": {"mode": "dense", "redetect_global_after": 3, "redetect_accept_ratio": 0.35,
                "redetect_accept_z": 3.0, "relock_conf_ratio": 0.9},
    "io": {"source": "synthetic:teleport", "num_frames": 48, "frame_size": [480, 640]},
}
# tools/port_rmse_reference.py --config configs/robust-head.yaml --checkpoint
# checkpoints/vit_b16_head.npz --frames 48 --set io.source=synthetic:teleport
# --set model.head_blend_auto=true --set filter.lost_conf_ratio=0.55 --set
# tracker.redetect_global_after=3 --set tracker.redetect_accept_ratio=0.35
# --set tracker.redetect_accept_z=3.0 (the JAX package on the CPU, clip seed
# 0, the 22 records from the fourth after the reappearance on): RMSE
# 0.612-0.704 px over filter seeds 0-3, 7 of 47 records lost on every seed,
# none of the last 5. Same 2 px of room as the other paths.
ROBUST_RMSE_RANGE = (0.612, 0.704)
ROBUST_LOST_RANGE = (7, 7)
ROBUST_RMSE_BOUND_PX = ROBUST_RMSE_RANGE[1] + 2.0

# The banked main path: configs/eval4-tpu-multiobject-720p.yaml's values (a
# CPU test holds this dict equal to load_config of that file plus the
# overrides): 8 banks x 1024 particles, ViT-B/16 bf16, dense, roi_grid 5;
# the dense path's checkpoint (docs/QUALITY.md's eval4 "trained" weights) and
# 48 frames of 720x1280 synthetic:multi-8, bank k on target k
# (tools/eval_quality.py's eval4 geometry; nothing cut).
BANKED_CONFIG = {
    "model": {"variant": "vit-b16", "image_size": 224, "dtype": "bfloat16", "use_flash_attention": True,
              "checkpoint": CHECKPOINT},
    "filter": {"num_particles": 1024, "motion": {"sigma_pos": 4.0, "sigma_vel": 1.2}, "likelihood_temp": 20.0,
               "seed": 0},
    "tracker": {"mode": "dense", "search_scale": 4.0, "roi_grid": 5},
    "io": {"source": "synthetic:multi-8", "num_frames": 48, "frame_size": [720, 1280]},
    "runtime": {"banks": 8, "mesh_banks": 1, "mesh_particles": 1},
}
# tools/port_rmse_reference.py --banked --config
# configs/eval4-tpu-multiobject-720p.yaml --frames 48 --set
# io.source=synthetic:multi-8 (the JAX MultiTracker on the CPU, same clip and
# checkpoint): pooled RMSE 4.210-4.302 px over filter seeds 0-3, no lost
# record. Same 2 px of room as the other paths.
JAX_BANKED_RMSE_PX_MAX = 4.302
BANKED_RMSE_BOUND_PX = JAX_BANKED_RMSE_PX_MAX + 2.0
# The multi-stream main path: config.yaml's values (runtime.streams 4, its
# default) through MultiStreamTracker, 4 clips of 480x640 moving-square seeded
# 0-3 and filter seeds 0-3, as the serve command opens them, 60 frames.
# tools/port_rmse_reference.py --streams 4 (the JAX MultiStreamTracker on the
# CPU): each stream's worst RMSE over filter seeds 0-3 (stream i with seed
# base + i), no lost record. Each stream gets 2 px of room over its worst.
JAX_STREAM_RMSE_PX_MAX = (4.278, 3.176, 2.249, 5.205)
STREAMS = 4

# The ROI streaming paths ("stream, roi"). eval5-roi-c4:
# configs/eval5-tpu-streaming-4k.yaml with io.source native-synthetic (a CPU
# test holds this dict equal to load_config of that file plus the overrides
# io.source and io.num_frames): ViT-L/16 on random init, 16384 particles,
# pooled, 4K, ROI 1600 shipped as a 288-px view, glob /8 every 4, chunk 4,
# steer lag 32, readback 32. Reduced: 60 frames instead of 240.
EVAL5_CONFIG = {
    "model": {"variant": "vit-l16", "image_size": 224, "dtype": "bfloat16", "use_flash_attention": True},
    "filter": {"num_particles": 16384, "motion": {"sigma_pos": 6.0, "sigma_vel": 2.0}, "likelihood_temp": 20.0,
               "seed": 0, "lost_conf_ratio": 0.55},
    "tracker": {"mode": "dense", "search_scale": 4.0, "roi_grid": 5, "appearance": "pooled",
                "redetect_global_after": 10, "redetect_global_grid": 5, "redetect_accept_z": 3.0},
    "io": {"source": "native-synthetic:moving-square", "num_frames": 60, "frame_size": [2160, 3840],
           "init_bbox": [1280.0, 840.0, 120.0, 120.0]},
    "runtime": {"banks": 1, "prefetch_frames": 3, "mesh_particles": 1, "stream_roi": 1600, "stream_roi_out": 288,
                "stream_roi_stride": 4, "stream_glob_stride": 8, "stream_glob_every": 4, "stream_readback": 32,
                "stream_steer_lag": 32, "stream_chunk": 4},
}
# tools/port_rmse_reference.py --stream --config
# configs/eval5-tpu-streaming-4k.yaml --checkpoint "" --frames 60 --set
# io.source=native-synthetic:moving-square (the JAX package's stream_track
# on the CPU, same config, clip and frames; the random weights and the noise
# both follow filter.seed): RMSE over filter seeds 0-3. Seed 3 loses the
# target for 4 frames. The bound is the worst plus 2 px, as on the other paths.
JAX_EVAL5_RMSE_PX = (26.736, 27.484, 29.617, 128.907)
EVAL5_RMSE_BOUND_PX = max(JAX_EVAL5_RMSE_PX) + 2.0
# eval5-roi-teleport-c4 (tools/bench_stream_e2e.py): the same tracker on
# synthetic:teleport at 4K, ROI 1600 at stride 4 (no resampled view: a Python
# source), 48 frames (hidden from 16, back at 22; reduced from 120). The JAX
# package's mean error from the tenth frame after the reappearance on
# (tools/port_rmse_reference.py --stream ... --frames 48 --set
# io.source=synthetic:teleport --set runtime.stream_roi_out=0, recover_err_px)
# over filter seeds 0-3 (26-28 of 47 records lost); the bound is the worst
# plus 2 px.
TELEPORT_FRAMES = 48
JAX_TELEPORT_RECOVER_PX = (90.675, 151.877, 182.233, 350.120)
TELEPORT_RECOVER_BOUND_PX = max(JAX_TELEPORT_RECOVER_PX) + 2.0
EVAL5_DENSE_SHAPE, EVAL5_REDETECT_SHAPE = (1, 16, 196, 64), (25, 16, 196, 64)
# Adaptive sizing: config.yaml's dense values on 400 frames of 480x640 from
# the native ring (the rate is taken over at least 0.5 s, so the stream must
# outlast that on the card), ROI 256, chunk 2 up to 8, fps_target out of
# reach. tools/port_rmse_reference.py --stream --frames 400 --set
# io.source=native-synthetic:moving-square --set runtime.stream_roi=256 --set
# runtime.stream_chunk=2 --set runtime.stream_chunk_max=8 --set
# runtime.stream_fps_target=1000000000.0 (the JAX package on the CPU): RMSE
# over filter seeds 0-1; the bound is the worst plus 2 px.
ADAPTIVE_FRAMES = 400
JAX_ADAPTIVE_RMSE_PX = (2.864, 2.828)
ADAPTIVE_RMSE_BOUND_PX = max(JAX_ADAPTIVE_RMSE_PX) + 2.0
# The crop-mode ROI stream: the crop main path (config.yaml, crop mode
# through K2, 60 frames) shipping a 320-px ROI at stride 2, chunk 4.
# tools/port_rmse_reference.py --stream --frames 60 --set tracker.mode=crop
# --set tracker.crop_impl=window-pallas --set runtime.stream_roi=320 --set
# runtime.stream_roi_stride=2 --set runtime.stream_chunk=4 --set
# runtime.stream_glob_every=4: RMSE over filter seeds 0-3, worst plus 2 px.
CROP_ROI_RUNTIME = {"stream_roi": 320, "stream_roi_stride": 2, "stream_chunk": 4, "stream_glob_stride": 8,
                    "stream_glob_every": 4}
JAX_CROP_ROI_RMSE_PX = (0.912, 0.873, 0.844, 1.008)
CROP_ROI_RMSE_BOUND_PX = max(JAX_CROP_ROI_RMSE_PX) + 2.0

# The bench phase: runtime/benchmark.py's run_benchmark over the five
# BASELINE configs, as tools/port_bench_evals.py runs them (its dicts, each
# held equal to its file in configs/ by a CPU test), with small counts.
_bench_evals = _load_tool("port_bench_evals")
BENCH_COUNTS = dict(warmup=4, measure_frames=20, latency_frames=8, stage_frames=4)
# eval3 (configs/eval3-tpu-needle-1080p.yaml: ViT-L/16 on random init, 4096
# particles, cells, 1080p needle) tracked through Tracker.run on 30 frames.
# tools/port_rmse_reference.py --config configs/eval3-tpu-needle-1080p.yaml
# --checkpoint "" --frames 30 (the JAX package on the CPU, clip seed 0; the
# random weights and the noise both follow filter.seed): RMSE over filter
# seeds 0-3. The bound is the worst plus 2 px, as on the other paths.
EVAL3_FRAMES = 30
JAX_EVAL3_RMSE_PX = (12.853, 80.855, 106.645, 98.496)
EVAL3_RMSE_BOUND_PX = max(JAX_EVAL3_RMSE_PX) + 2.0

# The train phase (training/). (a) tests/test_training.py's tiny_train_cfg,
# one step on the card against the CPU on one injected batch and its draws:
# the loss to rtol 1e-4 (tests/test_training.py:117-119), the metrics to
# 1e-6 plus that, every gradient leaf to 2e-5 (the CPU tests' tolerance of
# the port against the JAX package), the plain attention's forward as the
# trainer runs it to TOL (f32 on the tiny ViT, bf16 at the head run's
# [32, 12, 196, 64]).
TINY_TRAIN = {
    "model": {"variant": "custom", "depth": 2, "dim": 64, "heads": 2, "mlp_dim": 128, "patch_size": 16,
              "image_size": 64, "dtype": "float32", "use_flash_attention": False},
    "train": {"steps": 8, "batch_size": 4, "canvas": 96, "window": 64, "lr": 1e-3, "warmup": 2, "log_every": 4,
              "checkpoint_out": ""},
}
TRAIN_LOSS_RTOL, TRAIN_METRIC_ATOL, TRAIN_GRAD_ATOL = 1e-4, 1e-6, 2e-5
TRAIN_ATTENTION_SHAPE = (32, 12, 196, 64)
# (b) configs/train-head.yaml and (c) configs/train-features.yaml at full
# width (a CPU test holds these dicts equal to load_config of those files
# plus the overrides). Cut: the steps (6000 -> 30, with the probe at the
# last; 8000 -> 10, no probe) and nothing else: batch 32, canvas 288,
# window 224, bf16 over f32 masters, every term of the objective, the
# probe's 5 clips x 48 frames at 512 particles. The outputs go to a
# temporary directory (checkpoint_out and metrics_out, set at run time).
TRAIN_HEAD_CONFIG = {
    "model": {"variant": "vit-b16", "head_depth": 2, "head_blend": 0.5, "image_size": 224, "dtype": "bfloat16",
              "use_flash_attention": False, "scan_unroll": 1},
    "train": {"steps": 30, "batch_size": 32, "canvas": 288, "window": 0, "lookalike_frac": 0.6, "lr": 4.0e-4,
              "warmup": 300, "tau": 0.07, "dtype": "bfloat16", "distractor_margin": 0.35,
              "distractor_weight": 4.0, "distractor_centered_weight": 2.0, "distractor_absent_weight": 2.0,
              "blur_prob": 0.5, "blur_sigma": 1.2, "eval_every": 30, "eval_frames": 48,
              "eval_clips": ["moving-square", "photometric", "rotation", "lookalikes", "lookalikes+blur"],
              "checkpoint_out": "checkpoints/vit_b16_head.npz", "checkpoint_dtype": "float32",
              "metrics_out": "docs/train_metrics_head.jsonl", "log_every": 30},
}
TRAIN_FEATURES_CONFIG = {
    "model": {"variant": "vit-b16", "image_size": 224, "dtype": "bfloat16", "use_flash_attention": False,
              "scan_unroll": 1},
    "train": {"steps": 10, "batch_size": 32, "canvas": 288, "window": 0, "lr": 3.0e-4, "warmup": 200,
              "tau": 0.07, "dtype": "bfloat16", "eval_every": 0, "checkpoint_out": "checkpoints/vit_b16_tracking.npz",
              "checkpoint_dtype": "bfloat16", "metrics_out": "docs/train_metrics_b16.jsonl", "log_every": 10},
}
TRAIN_WARMUP_STEPS = 3  # before the timed steps of a run's own loop
TRAIN_TIMED_STEPS = {"head": 8, "features": 5}
TRAIN_TRACK_FRAMES = 30  # (c)'s checkpoint through config.yaml on moving-square

CHECK_SHAPES = [(1, 12, t, 64) for t in (128, 130, 196, 197, 389, 3600)] + [(49, 12, 196, 64)]
# The banked path's forward (8 windows) and the multi-stream path's (4).
BANKED_SHAPE, STREAMS_SHAPE = (8, 12, 196, 64), (STREAMS, 12, 196, 64)
CHECK_SHAPES += [BANKED_SHAPE, STREAMS_SHAPE, EVAL5_DENSE_SHAPE, EVAL5_REDETECT_SHAPE]
# Crop mode: one crop (T = 4 tokens; the template forward), and the main
# path's 1024 crops.
CROP_CHECK_SHAPES = [(1, 12, 4, 64), (1024, 12, 4, 64)]
# Both of K1's paths and their edges (small T <= 16, tiled above) at the
# head counts of the presets, and B*H = 72,000 (over a grid.y's 65,535).
SWEEP_CHECK_SHAPES = [(2, h, t, 64) for h in (3, 12, 16) for t in (1, 4, 9, 16, 17, 64, 128, 130, 196, 197, 389)]
WIDE_CHECK_SHAPES = [(6000, 12, 4, 64)]
LAYOUTS = ("fused", "contiguous")
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}  # as tests/test_attention.py
DENSE_SHAPE, CROP_SHAPE, CROP_ONE_SHAPE, REDETECT_SHAPE = (1, 12, 196, 64), (1024, 12, 4, 64), (1, 12, 4, 64), (49, 12, 196, 64)
# K1 under "model" tensor parallelism over 2 cards: H / 2 heads a rank (ViT-B/16, ViT-L/16).
TP_SHAPES = [(1, 6, 196, 64), (1, 8, 196, 64)]
CHECK_SHAPES += TP_SHAPES
# DINOv2 ViT-g/14 with 4 registers at a 224-px window (the benchmark's
# g14reg-offline-1080p): 256 patches, the class token and the registers.
DINOV2_SHAPE = (1, 24, 261, 64)
CHECK_SHAPES += [DINOV2_SHAPE]
TIME_SHAPES = [DENSE_SHAPE, CROP_SHAPE, CROP_ONE_SHAPE, REDETECT_SHAPE, BANKED_SHAPE, STREAMS_SHAPE, EVAL5_DENSE_SHAPE,
               EVAL5_REDETECT_SHAPE, *TP_SHAPES, DINOV2_SHAPE]
# The SwiGLU gate kernel (csrc/swiglu.cu) at (M rows, h): DINOv2 ViT-g/14's
# FFN at one 224-px window (M 261, h 4096) first, then ragged and small
# cases and 16 windows.
SWIGLU_SHAPES = [(261, 4096), (16 * 261, 4096), (3, 8), (1000, 1368)]
# The pre-norm junction kernel (csrc/prenorm_junction.cu) at (M rows, D,
# dtype): the benchmark cells' forwards first (b16-serve16's 16 windows of
# ViT-B/16, l16's window of ViT-L/16, g14reg's window of DINOv2 ViT-g/14 with
# its 5 prefix tokens, the live cell's one window of ViT-B/16), then the crop
# path's 1024 particles of 4 tokens, eval1's f32 window and a small width.
JUNCTION_SHAPES = [(16 * 196, 768, torch.bfloat16), (196, 1024, torch.bfloat16), (261, 1536, torch.bfloat16),
                   (196, 768, torch.bfloat16), (1024 * 4, 768, torch.bfloat16), (196, 768, torch.float32),
                   (37, 64, torch.bfloat16)]
JUNCTION_CELLS = 4  # the first four: the cells' shapes, timed
# y's difference from the plain form in ulps of the compute dtype (an ulp is
# 2^(e - significand bits)), taken at |y| of at least the floor, and its
# bound. The two sums' order moves the f32 statistics by about 1e-7 of the
# row's unit scale: below |y| 2^-8 that outweighs a bf16 ulp, and in f32,
# where no final rounding hides it, it is a fraction of an ulp of 1.
JUNCTION_ULP = {torch.bfloat16: (8, 2.0**-8, 1.0), torch.float32: (24, 1.0, 8.0)}  # (bits, floor, bound)

# K2 checks: every combination, each once with a randn window and raw
# weights and once with a 0..255 window and normalization-folded weights.
# N reaches every edge of the launch plan's tiles: one box (4 or 9 rows in
# one 16-row tile), 3, a 64-row tile exactly (16 at crop 32), one row past
# it, 33, crop-mode re-detection's 49 tile centres, the crop path's 1024
# and eval5's 16384 particles (both on the wide tile), and a rank's share
# of 1024 on a particle mesh of 2 and 4 cards (512, 256); D 100 goes to the
# scalar kernel (D % 8 != 0); 768 fills two of the
# wide tile's 384 columns, 192 and 1024 leave the last one ragged.
K2_NS = (1, 3, 16, 17, 33, 49, 256, 512, 1024, 16384)
K2_CROPS = ((32, 16), (48, 16))  # (crop, patch)
K2_SWINS = (64, 256)
K2_DIMS = (100, 192, 768, 1024)
K2_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),  # as tests/test_patchify_pallas.py
          torch.bfloat16: dict(atol=0.15, rtol=0.05)}
# The crop main path's K2 calls: 1024 boxes (the particles) and 1 box (the
# template at the estimate), 256-px window, 32-px crops, D 768.
# The crop path's two K2 calls, and the inputs of every K2 check and timing:
# one definition, in tools/port_k2_times.py.
K2_MAIN, K2_ONE, k2_inputs = _k2_times.K2_MAIN, _k2_times.K2_ONE, _k2_times.k2_inputs
# K2 over K windows (crop-mode banks), each with its own boxes: (windows, N).
K2_WINDOW_CASES = ((1, 1024), (2, 1024), (8, 1024), (2, 1))

# H100 SXM published peaks (dense): bf16 tensor cores, f32 without them, HBM.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12
# TF32 tensor cores; K1's f32 paths above T 16 run each f32 product as three
# TF32 ones (3xTF32), so their operations term takes a third of it.
PEAK_TF32 = 495e12


def check(ok: bool, what: str) -> None:
    """A failed check raises (asserts would vanish under python -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def phase(name: str, t0: float) -> None:
    print(f"[phase] {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def attention_peak(t: int, dtype) -> tuple[float, str]:
    """The peak K1's path at this T and dtype runs its products at: the
    small path's scalar f32 FMAs (both dtypes), the bf16 tiled path's tensor
    cores, the f32 tiled and split paths' 3xTF32 (a third of TF32's)."""
    if t <= attention.SMALL_T_MAX:
        return PEAK_FLOPS[torch.float32], "f32 FFMA (small path)"
    if dtype == torch.bfloat16:
        return PEAK_FLOPS[torch.bfloat16], "bf16 tensor cores"
    return PEAK_TF32 / 3, "3xTF32 tensor cores (495e12 / 3)"


def attention_bound_ms(shape, dtype) -> tuple[float, str, str]:
    """Least time for one attention forward: q, k, v read once, o written
    once, against 4·B·H·T²·d FLOP at the peak of the path that runs it
    (attention_peak, whose basis is returned too)."""
    b, h, t, d = shape
    elem = torch.finfo(dtype).bits // 8
    peak, basis = attention_peak(t, dtype)
    byte_ms = 4 * b * h * t * d * elem / PEAK_BYTES_PER_S * 1e3
    op_ms = 4 * b * h * t * t * d / peak * 1e3
    return max(byte_ms, op_ms), ("bytes" if byte_ms >= op_ms else "operations"), basis


def qkv(shape, dtype, seed, layout="contiguous"):
    """q, k, v [B, H, T, 64] on the card: views of one fused [B, T, H*3*64]
    activation, as models/vit.py passes them ("fused"), or three contiguous
    tensors."""
    b, h, t, d = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    if layout == "fused":
        return attention.split_fused_qkv(torch.randn((b, t, h * 3 * d), generator=g, device="cuda").to(dtype), h)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype) for _ in range(3)]


def check_kernel() -> dict:
    """K1 against the plain version at every listed shape, f32 and bf16, on
    fused-qkv views and on contiguous tensors. One line a shape."""
    errs = {}
    for shape in CHECK_SHAPES + CROP_CHECK_SHAPES + SWEEP_CHECK_SHAPES + WIDE_CHECK_SHAPES:
        line = []
        for dtype, layout in itertools.product((torch.float32, torch.bfloat16), LAYOUTS):
            q, k, v = qkv(shape, dtype, seed=shape[0] + shape[2], layout=layout)
            out = attention.flash_attention(q, k, v)
            torch.cuda.synchronize()
            ref = attention.reference_attention(q, k, v)
            check(out.shape == ref.shape and out.dtype == dtype, f"K1 output {out.shape} {out.dtype}")
            check(bool(torch.isfinite(out.float()).all()), f"K1 output finite at {shape} {dtype} {layout}")
            err = float((out.float() - ref.float()).abs().max())
            ok = torch.allclose(out.float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype])
            line.append(f"{'f32' if dtype == torch.float32 else 'bf16'}/{layout} {err:.3e}{'' if ok else ' FAIL'}")
            check(ok, f"K1 agrees with its plain version at {shape} {dtype} {layout} (max err {err})")
            errs[(shape, dtype, layout)] = err
        print(f"  K1 {str(shape):19s} max_abs_err " + ", ".join(line), flush=True)
    print(f"  K1: {len(errs)} checks ok (tolerance f32 {TOL[torch.float32]:g}, bf16 {TOL[torch.bfloat16]:g})",
          flush=True)
    return errs


def swiglu_input(m, h, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn((m, 2 * h), generator=g, device="cuda") * 3.0).to(dtype)


def check_swiglu() -> dict:
    """The SwiGLU gate kernel against its plain version (silu(gate) * up in
    f32, rounded once) at SWIGLU_SHAPES, f32 and bf16: equal within one
    rounding of the output (the same formula in the same order; torch's
    exp and the kernel's may differ in the last bit). -> {(M, h, dtype):
    (max abs error, share of elements not bitwise equal)}."""
    errs = {}
    for (m, h), dtype in itertools.product(SWIGLU_SHAPES, (torch.float32, torch.bfloat16)):
        if h % (8 if dtype == torch.bfloat16 else 4):
            continue
        x = swiglu_input(m, h, dtype, seed=m + h)
        before = sg.swiglu.launches
        out = sg.swiglu(x)
        torch.cuda.synchronize()
        want = sg.swiglu_plain(x)
        check(sg.swiglu.launches == before + 1, "swiglu counts its launch")
        rtol = 2**-7 if dtype == torch.bfloat16 else 1e-6
        ok = torch.allclose(out.float(), want.float(), rtol=rtol, atol=1e-6)
        err = float((out.float() - want.float()).abs().max())
        differ = float((out != want).float().mean())
        check(ok, f"SwiGLU kernel agrees with its plain version at ({m}, {h}) {dtype} (max err {err})")
        errs[(m, h, dtype)] = (err, differ)
    print("  SwiGLU kernel (csrc/swiglu.cu) == plain: " + ", ".join(
        f"({m}, {h}) {str(dt).removeprefix('torch.')} {e:.2e} ({d:.2%} not bitwise)"
        for (m, h, dt), (e, d) in errs.items()), flush=True)
    return errs


def time_swiglu(m, h, dtype=torch.bfloat16) -> dict:
    """The SwiGLU gate kernel at [M, 2 h]: device ms of one launch in a CUDA
    graph, its plain version's and torch's silu(gate) * up on the halves in
    the working dtype (two kernels and an [M, h] intermediate), an eager
    loop's; the bound is its bytes ([M, 2 h] read, [M, h] written) at
    PEAK_BYTES_PER_S."""
    x = swiglu_input(m, h, dtype)
    gate, up = x.chunk(2, dim=-1)
    fns = {"kernel": lambda: sg.swiglu(x), "plain": lambda: sg.swiglu_plain(x),
           "library": lambda: torch.nn.functional.silu(gate) * up}
    dev = {name: time_graph(fn) for name, fn in fns.items()}
    eager = time_eager(fns["kernel"])[0]
    bound = 3 * m * h * x.element_size() / PEAK_BYTES_PER_S * 1e3
    print(f"  SwiGLU ({m}, {h}) {str(dtype).removeprefix('torch.')}: kernel {dev['kernel']:.4f} ms on the card (bound "
          f"{bound:.5f} ms, bytes), plain {dev['plain']:.4f} ms, torch silu * mul {dev['library']:.4f} ms; eager loop "
          f"{eager:.4f} ms", flush=True)
    return {"ms": dev["kernel"], "plain_ms": dev["plain"], "library_ms": dev["library"], "bound_ms": bound,
            "bound_by": "bytes", "eager_ms": eager}


def junction_inputs(m, d, dtype, branch=True, bias=True, seed=0):
    """(x, branch, bias, scale, shift) on the card: a residual stream of
    scale 2, a branch of scale 1 and its bias, the LayerNorm's scale about 1
    and shift about 0 in f32."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def draw(shape, k, c=0.0):
        return c + k * torch.randn(shape, generator=g, device="cuda")

    x = draw((m, d), 2.0).to(dtype)
    br = draw((m, d), 1.0).to(dtype) if branch else None
    bi = draw((d,), 0.5).to(dtype) if bias else None
    return x, br, bi, draw((d,), 0.2, 1.0), draw((d,), 0.2)


def junction_errors(inputs, dtype, eps=1e-6) -> dict:
    """The junction kernel on `inputs` against its plain form, one launch
    counted: whether x_new is bitwise equal; y's largest difference in ulps
    of dtype (JUNCTION_ULP), the share of y's elements not bitwise equal and
    the largest absolute difference."""
    before = pj.prenorm_junction.launches
    x_new, y = pj.prenorm_junction(*inputs, dtype, eps)
    torch.cuda.synchronize()
    want_x, want_y = pj.prenorm_junction_plain(*inputs, dtype, eps)
    check(pj.prenorm_junction.launches == before + 1, "prenorm_junction counts its launch")
    check(x_new.shape == y.shape == inputs[0].shape and y.dtype == dtype, f"junction outputs {y.shape} {y.dtype}")
    diff = (y.float() - want_y.float()).abs()
    bits, floor, _ = JUNCTION_ULP[dtype]
    _, exp = torch.frexp(want_y.float().abs().clamp_min(floor))
    ulp = torch.ldexp(torch.ones_like(diff), exp - bits)
    return {"x_new_bitwise": bool(torch.equal(x_new, want_x)), "max_ulp": float((diff / ulp).max()),
            "differ": float((y != want_y).float().mean()), "max_abs_err": float(diff.max())}


def check_prenorm_junction() -> dict:
    """The pre-norm junction kernel against its plain form (the residual
    add, then models/vit.py's LayerNorm) at JUNCTION_SHAPES, each with the
    branch and its bias, the branch alone and nothing pending: x_new
    bitwise; y within JUNCTION_ULP's bound (the same formulas, the two sums
    in another order: one bf16 ulp), under 0.1 % of it not bitwise in bf16.
    -> {(M, D, dtype, branch, bias): junction_errors}."""
    errs = {}
    cases = [(*shape, br, bi) for shape in JUNCTION_SHAPES for br, bi in ((True, True), (True, False), (False, False))]
    for m, d, dtype, br, bi in cases:
        key = (m, d, dtype, br, bi)
        e = errs[key] = junction_errors(junction_inputs(m, d, dtype, br, bi, seed=m + d), dtype)
        check(e["x_new_bitwise"], f"junction x_new bitwise at {key}")
        check(e["max_ulp"] <= JUNCTION_ULP[dtype][2], f"junction y within its ulp bound at {key} ({e['max_ulp']} ulp)")
        check(dtype == torch.float32 or e["differ"] < 1e-3,
              f"junction y under 0.1 % not bitwise at {key} ({e['differ']:.3%})")
    worst = {}
    for (m, d, dtype, *_), e in errs.items():
        u, f = worst.get((m, d, dtype), (0.0, 0.0))
        worst[(m, d, dtype)] = (max(u, e["max_ulp"]), max(f, e["differ"]))
    print(f"  pre-norm junction (csrc/prenorm_junction.cu) == plain: x_new bitwise in all {len(errs)} cases; y "
          + ", ".join(f"({m}, {d}) {str(dt).removeprefix('torch.')} {u:.2f} ulp ({f:.4%} not bitwise)"
                      for (m, d, dt), (u, f) in worst.items()), flush=True)
    return errs


def time_prenorm_junction(m, d, dtype=torch.bfloat16) -> dict:
    """The junction kernel at [M, D] with a branch and its bias: device ms of
    one launch in a CUDA graph, its plain form's (the residual adds and the
    f32 LayerNorm chain) and torch's x + (branch + bias) then
    torch.nn.functional.layer_norm with the parameters in the working dtype
    (a yardstick, timed only), an eager loop's; the bound is its bytes (x
    and branch read, x_new and y written) at PEAK_BYTES_PER_S."""
    x, br, bi, sc, sh = junction_inputs(m, d, dtype)
    sc_t, sh_t = sc.to(dtype), sh.to(dtype)
    fns = {"kernel": lambda: pj.prenorm_junction(x, br, bi, sc, sh, dtype, 1e-6),
           "plain": lambda: pj.prenorm_junction_plain(x, br, bi, sc, sh, dtype, 1e-6),
           "library": lambda: torch.nn.functional.layer_norm(x + (br + bi), (d,), sc_t, sh_t, 1e-6)}
    dev = {name: time_graph(fn) for name, fn in fns.items()}
    eager = time_eager(fns["kernel"])[0]
    bound = 4 * m * d * x.element_size() / PEAK_BYTES_PER_S * 1e3
    geo = pj.launch_geometry(m, d, dtype)
    print(f"  pre-norm junction ({m}, {d}) {str(dtype).removeprefix('torch.')}: kernel {dev['kernel']:.4f} ms on the "
          f"card (bound {bound:.5f} ms, bytes; {geo.vpl} vectors a lane, {geo.warps} rows a block, {geo.blocks} "
          f"blocks), plain {dev['plain']:.4f} ms, torch adds + layer_norm {dev['library']:.4f} ms; eager loop "
          f"{eager:.4f} ms", flush=True)
    return {"ms": dev["kernel"], "plain_ms": dev["plain"], "library_ms": dev["library"], "bound_ms": bound,
            "bound_by": "bytes", "eager_ms": eager}


def junction_expected(k1_expected: dict, cfg: Config) -> dict:
    """The pre-norm junction's launches by (M, D) from K1's by (B, H, T): a
    forward of B windows of T tokens launches K1 once a block and the
    junction 2 depth + 1 times (2 head_depth + 1 more with a head), at M =
    B T rows of the model's width."""
    m = cfg.model
    blocks = m.depth + m.head_depth
    per_forward = 2 * m.depth + 1 + (2 * m.head_depth + 1 if m.head_depth else 0)
    return {(b * t, m.dim): n // blocks * per_forward for (b, _, t), n in k1_expected.items()}


def check_window_patchify() -> dict:
    """K2 against its plain version at every listed N, crop, Swin, D, dtype,
    with randn and raw (folded-weight) inputs; counts the cases each of the
    launch plan's paths took."""
    errs = {}
    paths = Counter()
    cases = itertools.product((torch.float32, torch.bfloat16), K2_NS, K2_CROPS, K2_SWINS, K2_DIMS, (False, True))
    for dtype, n, (crop, patch), swin, d, raw in cases:
        window, centers, sizes, kernel, bias = k2_inputs(n, swin, patch, d, dtype, raw, seed=n + swin + d)
        paths[pw.launch_plan(window, centers, sizes, crop, patch, kernel, bias).path] += 1
        out = pw.gather_patchify_window(window, centers, sizes, crop, patch, kernel, bias)
        torch.cuda.synchronize()
        ref = pw.window_gather_patchify_plain(window, centers, sizes, crop, patch, kernel, bias)
        key = (n, crop, swin, d, dtype, raw)
        check(out.shape == ref.shape == (n, (crop // patch) ** 2, d) and out.dtype == dtype,
              f"K2 output {tuple(out.shape)} {out.dtype} at {key}")
        check(bool(torch.isfinite(out.float()).all()), f"K2 output finite at {key}")
        err = float((out.float() - ref.float()).abs().max())
        ok = torch.allclose(out.float(), ref.float(), **K2_TOL[dtype])
        check(ok, f"K2 agrees with its plain version at {key} (max err {err})")
        errs[key] = err
    for dtype in (torch.float32, torch.bfloat16):
        worst = max(e for k, e in errs.items() if k[4] == dtype)
        print(f"  K2 {str(dtype):15s} {len(errs) // 2} cases (N {K2_NS}, (crop, patch) {K2_CROPS}, "
              f"Swin {K2_SWINS}, D {K2_DIMS}, randn and raw windows): max_abs_err {worst:.3e} "
              f"(tol {K2_TOL[dtype]}) ok", flush=True)
    print(f"  K2 cases by launch-plan path: {dict(paths)}", flush=True)
    check(set(paths) == {"wide", "narrow", "scalar"}, f"the K2 cases reach every path ({dict(paths)})")
    return errs


def k2_window_inputs(windows: int, n: int, dtype, seed: int):
    """K2's inputs for `windows` windows of 256 px, each with its own n
    boxes (k2_inputs, raw windows with folded weights, seeded per window),
    stacked: [K, 256, 256, 3], [K, N, 2], [K, N, 2], and the first window's
    weights (D 768, crop 32, patch 16)."""
    parts = [k2_inputs(n, 256, 16, 768, dtype, True, seed=seed + i) for i in range(windows)]
    window, centers, sizes = (torch.stack([x[j] for x in parts]).contiguous() for j in range(3))
    return window, centers, sizes, parts[0][3], parts[0][4]


def check_window_patchify_windows() -> dict:
    """K2 over K windows in one launch against its plain version (the
    crop-mode banks' call), f32 and bf16, at K_WINDOW_CASES."""
    errs = {}
    for (windows, n), dtype in itertools.product(K2_WINDOW_CASES, (torch.float32, torch.bfloat16)):
        window, centers, sizes, kernel, bias = k2_window_inputs(windows, n, dtype, seed=windows + n)
        plan = pw.launch_plan(window, centers, sizes, 32, 16, kernel, bias)
        out = pw.gather_patchify_window(window, centers, sizes, 32, 16, kernel, bias)
        torch.cuda.synchronize()
        ref = pw.window_gather_patchify_plain(window, centers, sizes, 32, 16, kernel, bias)
        key = (windows, n, dtype)
        check(out.shape == ref.shape == (windows, n, 4, 768) and out.dtype == dtype, f"K2 windows output at {key}")
        check(bool(torch.isfinite(out.float()).all()), f"K2 windows output finite at {key}")
        err = float((out.float() - ref.float()).abs().max())
        check(torch.allclose(out.float(), ref.float(), **K2_TOL[dtype]),
              f"K2 over {windows} windows x {n} boxes agrees with its plain version ({dtype}, max err {err})")
        errs[key] = err
        print(f"  K2 over {windows} windows x {n} boxes {str(dtype):15s} {plan.path} tile, grid {plan.grid}: "
              f"max_abs_err {err:.3e} ok", flush=True)
    return errs


def ptxas_functions(report: str) -> dict[str, dict]:
    """nvcc -Xptxas -v's report -> {mangled function: {"registers",
    "spill_stores", "spill_loads"}}."""
    funcs, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'|Function properties for (\S+)", line)
        if m:
            name = m.group(1) or m.group(2)
            funcs.setdefault(name, {})
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            funcs[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            funcs[name]["registers"] = int(m.group(1))
    return funcs


def check_k2_build(record: dict) -> None:
    """No K2 kernel spills (ptxas: this build's report, or the one saved
    beside a cached library); the tensor-core kernels hold HMMA instructions
    (cuobjdump -sass; fails without it); the launch plans at the crop path's
    shapes, and the shared memory the plan computes equals the library's."""
    funcs = {k: v for k, v in ptxas_functions(record["ptxas"]).items() if "window_patchify" in k}
    for name, f in funcs.items():
        print(f"  K2 ptxas {name[:70]}: {f}")
    check(len(funcs) == 4 and all("spill_stores" in f for f in funcs.values()),
          f"ptxas reports the four K2 kernels ({list(funcs)}; built in this process: {record['built']})")
    check(all(f["spill_stores"] == 0 and f["spill_loads"] == 0 for f in funcs.values()),
          "no K2 kernel spills registers")
    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    check(cuobjdump.exists(), f"{cuobjdump} exists, to read K2's SASS")
    sass = subprocess.run([str(cuobjdump), "-sass", record["so"]], capture_output=True, text=True).stdout
    hmma, name = Counter(), None
    for line in sass.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            name = m.group(1)
            hmma[name] += 0
        elif name and "HMMA" in line:
            hmma[name] += 1
    mma_kernels = [k for k in hmma if "window_patchify_mma_kernel" in k]
    print(f"  K2 HMMA instructions by kernel (cuobjdump -sass): {dict(hmma)}")
    check(len(mma_kernels) == 2 and all(hmma[k] > 0 for k in mma_kernels),
          "both K2 tensor-core kernels issue HMMA")
    lib = _build.window_patchify_library()
    for path, code in pw._PATH_CODES.items():
        for crop, patch in K2_CROPS:
            check(lib.vpt_window_patchify_smem_bytes(code, patch, 3, crop) == pw.smem_bytes(path, patch, 3, crop),
                  f"K2 shared memory of path {path} at crop {crop}: library == launch_plan")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for m in (K2_MAIN, K2_ONE):
        w, c, s_, k, b = _k2_times.timing_inputs(m)
        print(f"  K2 at N {m['n']}: {pw.launch_plan(w, c, s_, m['crop'], m['patch'], k, b, sms)}")


TINY = {
    "model": {"variant": "custom", "depth": 2, "dim": 128, "heads": 2, "mlp_dim": 256,
              "image_size": 64, "dtype": "float32", "checkpoint": ""},
    "filter": {"num_particles": 256, "motion": {"sigma_pos": 3.0}},
    "io": {"source": "synthetic:moving-square", "num_frames": 8, "frame_size": [224, 224]},
}
# A CUDA cumsum may round differently from the CPU's, and one flipped
# systematic-resampling boundary forks two trajectories (tests/test_golden.py
# documents the same for f32 against f64). The device comparison therefore
# runs without resampling; resampling itself is held to the NumPy oracle by
# tests/test_torch_filter.py, and the main path's RMSE covers it on the card.
TINY_NO_RESAMPLE = copy.deepcopy(TINY)
TINY_NO_RESAMPLE["filter"]["ess_threshold"] = 0.0
TINY_CROP_NO_RESAMPLE = copy.deepcopy(TINY_NO_RESAMPLE)
TINY_CROP_NO_RESAMPLE["tracker"] = dict(CROP_OVERRIDES)
# Global re-detection at the tiny size: 12 frames of 192x192
# synthetic:teleport (hidden from frame 4, back at 8), a relative lost gate
# that fires, a 5 x 5 scan after 2 lost frames (tests/test_torch_redetect.py
# runs the same against the JAX package). Dense with the head, its automatic
# blend and the robust config's acceptance and re-lock gates; crop through K2
# (the scan's 25 crops at N 25).
REDETECT_AFTER = 2
TINY_TELEPORT = copy.deepcopy(TINY_NO_RESAMPLE)
TINY_TELEPORT["filter"]["lost_conf_ratio"] = 0.9
TINY_TELEPORT["io"] = {"source": "synthetic:teleport", "num_frames": 12, "frame_size": [192, 192]}
TINY_HEAD_REDETECT = copy.deepcopy(TINY_TELEPORT)
TINY_HEAD_REDETECT["model"].update(head_depth=2, head_blend_auto=True)
TINY_HEAD_REDETECT["tracker"] = {"redetect_global_after": REDETECT_AFTER, "redetect_global_grid": 5,
                                 "redetect_accept_ratio": 0.35, "redetect_accept_z": 2.0, "relock_conf_ratio": 0.9}
TINY_CROP_REDETECT = copy.deepcopy(TINY_TELEPORT)
TINY_CROP_REDETECT["tracker"] = {**CROP_OVERRIDES, "redetect_global_after": REDETECT_AFTER,
                                 "redetect_global_grid": 5, "redetect_accept_conf": 0.3}
# Banked at the tiny size: 3 banks on the teleport clip's one target (seeds
# 0-2) with the lost gate and re-detection (tests/test_torch_banked.py runs
# the same against the JAX package); 2 banks in crop mode through K2 (2
# windows a launch) on synthetic:multi-2; the multi-stream check runs 3
# moving-square clips (seeds 0-2) with TINY_NO_RESAMPLE.
TINY_BANKED_REDETECT = copy.deepcopy(TINY_TELEPORT)
TINY_BANKED_REDETECT["tracker"] = {"redetect_global_after": REDETECT_AFTER, "redetect_global_grid": 5,
                                   "redetect_accept_conf": 0.3}
TINY_BANKED_CROP = copy.deepcopy(TINY_CROP_NO_RESAMPLE)
TINY_BANKED_CROP["io"]["source"] = "synthetic:multi-2"


def scan_accepted(state, n_after: int) -> tuple[bool, bool]:
    """(scanned, accepted) for the step that left `state`, read from the state
    alone: an accepted match reseeds the cloud with zero velocity everywhere;
    a scan without one leaves lost_count at n_after or more."""
    accepted = bool((state.pf.particles[:, 2:4] == 0).all())
    return accepted or int(state.lost_count) >= n_after, accepted


def check_tracker_small(cfg_dict: dict = TINY_NO_RESAMPLE, label: str = "tiny tracker") -> None:
    """The tracker on the card (its kernels inside) against the same tracker
    on the CPU (plain versions), same weights and noise, f32. With global
    re-detection, both scan and accept on the same steps, at least once."""
    cfg = Config.from_dict(copy.deepcopy(cfg_dict))
    src = open_source(cfg.io.source, cfg.io.num_frames, tuple(cfg.io.frame_size))
    fns = build_tracker_fns(cfg)
    cpu = Tracker(cfg, device="cpu")
    prm = {"cpu": cpu.vit_params, "cuda": Tracker(cfg, vit_params=cpu.vit_params, device="cuda").vit_params}
    n = cfg.filter.num_particles
    n_after = cfg.tracker.redetect_global_after
    bbox = torch.as_tensor(src.init_bbox)
    # The CUDA and CPU generators give other numbers for one seed, so both
    # runs take the CPU's draws: the initial cloud, every step's noise and
    # re-detection's reseed normals.
    cloud = pf.init_state(0, bbox[:2] + bbox[2:] / 2, n, pf.PFParams()).particles
    out = {}
    for dev in ("cpu", "cuda"):
        state = fns.init(prm[dev], torch.from_numpy(src.frames[0]).to(dev), bbox.to(dev), 0,
                         cloud=cloud.to(dev))
        rows = []
        for i in range(1, len(src.frames)):
            z = pf.draw_step_noise(0, i - 1, n, torch.device("cpu"))
            noise = pf.StepNoise(*(x.to(dev) for x in z))
            reseed = pf.draw_reseed_noise(0, i - 1, n, torch.device("cpu")).to(dev)
            state, o = fns.step(prm[dev], state, torch.from_numpy(src.frames[i]).to(dev), noise=noise, reseed=reseed)
            scan = scan_accepted(state, n_after) if n_after > 0 else (False, False)
            rows.append((o.position.cpu().numpy(), float(o.conf), bool(o.resampled), bool(o.lost), scan))
        out[dev] = rows
    for i, (a, b) in enumerate(zip(out["cpu"], out["cuda"])):
        check(np.abs(a[0] - b[0]).max() < 0.5 and abs(a[1] - b[1]) < 1e-3 and a[2:] == b[2:],
              f"{label} step {i}: cpu {a} vs cuda {b}")
    scans, accepts = (sum(r[4][k] for r in out["cuda"]) for k in (0, 1))
    if n_after > 0:
        check(scans >= 1 and accepts >= 1, f"{label}: {scans} scans, {accepts} accepted (at least one each)")
    print(f"  {label}: cuda == cpu within 0.5 px over {len(out['cpu'])} steps"
          + (f", {scans} scans and {accepts} accepted matches on both" if n_after > 0 else ""), flush=True)


def bank_scans(state, n_after: int) -> tuple[np.ndarray, np.ndarray]:
    """scan_accepted a bank: ([K] scanned, [K] accepted) of the step that
    left a banked state."""
    accepted = (state.pf.particles[..., 2:4] == 0).all(-1).all(-1).cpu().numpy()
    return accepted | (state.lost_count.cpu().numpy() >= n_after), accepted


def check_banked_small(cfg_dict: dict, kind: str, k: int, label: str) -> None:
    """A banked tracker's step (build_banked_fns / build_multistream_fns)
    on the card against the same on the CPU, K filters with seeds 0..K-1,
    the CPU's draws injected into both: every bank within 0.5 px, conf
    within 1e-3, flags equal. With re-detection, the same scans and
    accepted matches a bank on both, at least one of each."""
    d = copy.deepcopy(cfg_dict)
    d["runtime"] = {"banks": k}
    cfg = Config.from_dict(d)
    size = tuple(cfg.io.frame_size)
    if kind == "banked":
        src = open_source(cfg.io.source, cfg.io.num_frames, size)
        frames, boxes = np.stack(src.frames), banked.banked_bboxes(src.init_bbox, k)
        fns = banked.build_banked_fns(cfg)
    else:
        srcs = [open_source(cfg.io.source, cfg.io.num_frames, size, seed=i) for i in range(k)]
        frames = np.stack([np.stack(x.frames) for x in srcs], axis=1)  # [T, K, H, W, 3]
        boxes = np.stack([x.init_bbox for x in srcs])
        fns = banked.build_multistream_fns(cfg, k)
    cpu = Tracker(cfg, device="cpu")
    prm = {"cpu": cpu.vit_params, "cuda": Tracker(cfg, vit_params=cpu.vit_params, device="cuda").vit_params}
    n, n_after, seeds = cfg.filter.num_particles, cfg.tracker.redetect_global_after, list(range(k))
    bbox = torch.from_numpy(boxes)
    cloud = pf.init_state(seeds, bbox[:, :2] + bbox[:, 2:] / 2, n, pf.PFParams()).particles
    out = {}
    for dev in ("cpu", "cuda"):
        state = fns.init(prm[dev], torch.from_numpy(frames[0]).to(dev), bbox.to(dev), seeds, cloud=cloud.to(dev))
        rows = []
        for i in range(1, len(frames)):
            noise = pf.StepNoise(*(x.to(dev) for x in pf.draw_step_noise(seeds, i - 1, n, torch.device("cpu"))))
            reseed = pf.draw_reseed_noise(seeds, i - 1, n, torch.device("cpu")).to(dev)
            state, o = fns.step(prm[dev], state, torch.from_numpy(frames[i]).to(dev), noise=noise, reseed=reseed)
            scans = bank_scans(state, n_after) if n_after > 0 else None
            rows.append((o.position.cpu().numpy(), o.conf.cpu().numpy(), o.resampled.cpu().numpy(),
                         o.lost.cpu().numpy(), scans))
        out[dev] = rows
    for i, (a, b) in enumerate(zip(out["cpu"], out["cuda"])):
        same_scans = a[4] is None or all(np.array_equal(x, y) for x, y in zip(a[4], b[4]))
        check(np.abs(a[0] - b[0]).max() < 0.5 and np.abs(a[1] - b[1]).max() < 1e-3 and np.array_equal(a[2], b[2])
              and np.array_equal(a[3], b[3]) and same_scans, f"{label} step {i}: cpu {a} vs cuda {b}")
    line = f"  {label}: cuda == cpu within 0.5 px, {k} banks over {len(out['cpu'])} steps"
    if n_after > 0:
        scans, accepts = (sum(int(r[4][j].sum()) for r in out["cuda"]) for j in (0, 1))
        check(scans >= 1 and accepts >= 1, f"{label}: {scans} scans, {accepts} accepted (at least one each)")
        lost = sum(int(r[3].sum()) for r in out["cuda"])
        line += f", {lost} lost records, {scans} scans and {accepts} accepted matches (all banks) on both"
    print(line, flush=True)


def reset_counts() -> None:
    """Every kernel wrapper's launch counts, and the mesh's collective
    counts, to 0 (after the launches of the graphs' branch bodies so far are
    added, so that none lands later)."""
    step_graph.settle_counts()
    attention.flash_attention.launches = 0
    attention.flash_attention.shapes = Counter()
    pw.gather_patchify_window.launches = 0
    pw.gather_patchify_window.sizes = Counter()
    for fn in (pmesh.all_gather, pmesh.all_reduce, par.peer_all_reduce, sn.step_noise, sg.swiglu,
               pj.prenorm_junction):
        fn.launches = 0
        fn.shapes = Counter()


def read_counts() -> dict:
    """The launch counts, with those of the graphs' branch bodies that ran
    (one wait, to read the graphs' counters); the collectives issued and the
    peer all-reduce kernel's launches (by (group size, *shape)); the step
    noise kernel's (by (C, K, N, reseed drawn)); the SwiGLU gate's (by (M,
    h)); the pre-norm junction's (by (M, D))."""
    step_graph.settle_counts()
    return {"launches": attention.flash_attention.launches, "k1_shapes": dict(attention.flash_attention.shapes),
            "k2_launches": pw.gather_patchify_window.launches, "k2_sizes": dict(pw.gather_patchify_window.sizes),
            "all_gathers": pmesh.all_gather.launches, "all_reduces": pmesh.all_reduce.launches,
            "peer_launches": par.peer_all_reduce.launches, "peer_shapes": dict(par.peer_all_reduce.shapes),
            "noise_launches": sn.step_noise.launches, "noise_shapes": dict(sn.step_noise.shapes),
            "swiglu_launches": sg.swiglu.launches, "swiglu_shapes": dict(sg.swiglu.shapes),
            "junction_launches": pj.prenorm_junction.launches, "junction_shapes": dict(pj.prenorm_junction.shapes)}


# Graph against eager, same weights, same draws: the same kernels on the same
# inputs in the same order, so the records are expected bitwise equal; the
# positions are held to 0.01 px in case cuBLAS picks another algorithm for a
# GEMM captured on the capture stream (its workspace is per stream), which
# can move a bf16 product by a rounding. `lost` and `resampled` must be equal.
GRAPH_POS_TOL_PX = 0.01
WAIT_STEPS = 5  # steps over which the host's waits are counted


def count_waits(fn, stacks: list | None = None, thread: int | None = None, others: list | None = None) -> int:
    """The host's waits for the card while fn runs: every device-to-host
    read, stream or device synchronize and copy from pageable memory, as
    torch.cuda.set_sync_debug_mode("warn") reports them. `stacks` gets the
    Python stack of each. With `thread` (an ident), only that thread's waits
    count; `others` gets the stacks of the other threads' waits."""
    waits = []

    def seen(message, *args, **kwargs):
        # Not the one-time note that the mode itself prints ("...does not yet
        # detect all synchronizing operations").
        if "synchronizing CUDA operation" in str(message):
            stack = "".join(f for f in traceback.format_stack()[:-1] if "warnings.py" not in f)
            if thread is None or threading.get_ident() == thread:
                waits.append(stack)
            elif others is not None:
                others.append(stack)

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    if stacks is not None:
        stacks.extend(waits)
    return len(waits)


def run_turns(cfg: Config, prm: dict, src, n_after: int = 0) -> list[dict]:
    """Tracker.run over the source on the card in turns, eager, graph, graph,
    eager (Tracker(graphs=False/True)), same weights. The launch counts are
    set to 0 just before each run and read just after it. With global
    re-detection, each step's (scanned, accepted) is read from the state it
    leaves."""
    runs = []
    for graphs in (False, True, True, False):
        tracker = Tracker(cfg, vit_params=prm, device="cuda", graphs=graphs)
        reset_counts()
        recs, steps = [], []
        for rec in tracker.run(src):
            recs.append(rec)
            if n_after > 0:
                steps.append(scan_accepted(tracker.state, n_after))
        runs.append({"graphs": graphs, "recs": recs, "steps": steps, "tracker": tracker, **read_counts()})
    return runs


def check_turns(runs: list[dict], label: str) -> dict:
    """Every graph run's records against every eager run's: `lost` and
    `resampled` equal, positions within GRAPH_POS_TOL_PX; launch counts
    equal; the step noise kernel launched once a step in each graph run (one
    shape) and never in an eager one (the host draws); both step medians and
    their ratio -> summary."""
    eager = [r for r in runs if not r["graphs"]]
    graph = [r for r in runs if r["graphs"]]
    for r in runs:
        want = len(r["recs"]) if r["graphs"] else 0
        check(r["noise_launches"] == want and len(r["noise_shapes"]) == (1 if want else 0),
              f"{label}: step noise kernel launches {r['noise_launches']} {r['noise_shapes']} == {want} "
              f"({'graph' if r['graphs'] else 'eager'} run)")
    worst, bitwise = 0.0, True
    for g in graph:
        for e in eager:
            check(len(g["recs"]) == len(e["recs"]), f"{label}: graph and eager record counts")
            for i, (a, b) in enumerate(zip(g["recs"], e["recs"])):
                check(a["lost"] == b["lost"] and a["resampled"] == b["resampled"],
                      f"{label} step {i + 1}: graph lost/resampled {a['lost']}/{a['resampled']} == eager "
                      f"{b['lost']}/{b['resampled']}")
                d = float(np.abs(np.subtract(a["position"], b["position"])).max())
                worst = max(worst, d)
                bitwise &= all(a[k] == b[k] for k in a if k not in ("step_ms", "frame"))
            check(g["k1_shapes"] == e["k1_shapes"] and g["k2_sizes"] == e["k2_sizes"]
                  and g["swiglu_shapes"] == e["swiglu_shapes"] and g["junction_shapes"] == e["junction_shapes"],
                  f"{label}: launches by shape, graph {g['k1_shapes']} {g['k2_sizes']} {g['swiglu_shapes']} "
                  f"{g['junction_shapes']} == eager {e['k1_shapes']} {e['k2_sizes']} {e['swiglu_shapes']} "
                  f"{e['junction_shapes']}")
    check(worst <= GRAPH_POS_TOL_PX, f"{label}: graph positions within {GRAPH_POS_TOL_PX} px of eager ({worst})")
    med = {r_id: statistics.median(r["recs"][i]["step_ms"] for i in range(5, len(r["recs"])))
           for r_id, r in enumerate(runs)}
    g_med = statistics.median(med[i] for i, r in enumerate(runs) if r["graphs"])
    e_med = statistics.median(med[i] for i, r in enumerate(runs) if not r["graphs"])
    print(f"  {label}: graph records == eager records ({'bitwise' if bitwise else f'max position diff {worst:.2e} px'}"
          f", lost and resampled equal); launches by shape equal; step noise kernel "
          f"{graph[0]['noise_launches']} launches {graph[0]['noise_shapes']} a graph run, 0 eager", flush=True)
    print(f"  {label} step ms, median after 5 warm-up, turns eager/graph/graph/eager: "
          f"{'/'.join(f'{med[i]:.3f}' for i in range(len(runs)))}; eager {e_med:.3f}, graph {g_med:.3f}, "
          f"eager/graph {e_med / g_med:.2f}x; graph {1e3 / g_med:.1f} frames/s, eager {1e3 / e_med:.1f} frames/s",
          flush=True)
    return {"step_ms_median": g_med, "eager_step_ms_median": e_med, "bitwise": bitwise, "max_pos_diff_px": worst,
            "turn_medians_ms": [med[i] for i in range(len(runs))], "noise_shapes": graph[0]["noise_shapes"]}


def check_waits(tracker: Tracker, frames, clip_waits_max: int, label: str) -> dict:
    """Host waits on the graph path: each of WAIT_STEPS Tracker.step calls
    (at most 1), and track_clip_device over WAIT_STEPS frames already on the
    card (at most clip_waits_max in all)."""
    stacks = []
    per_step = [count_waits(lambda f=f: tracker.step(f), stacks) for f in frames[:WAIT_STEPS]]
    clip = torch.from_numpy(np.stack(frames[:WAIT_STEPS])).cuda()
    torch.cuda.synchronize()
    in_clip = count_waits(lambda: tracker.track_clip_device(clip), stacks)
    torch.cuda.synchronize()
    print(f"  {label}: host waits a Tracker.step {per_step}; in track_clip_device over {WAIT_STEPS} frames "
          f"{in_clip}", flush=True)
    if max(per_step) > 1 or in_clip > clip_waits_max:
        for stack in stacks:
            print(f"  a wait, at:\n{stack}", flush=True)
    check(max(per_step) <= 1, f"{label}: at most 1 host wait a Tracker.step ({per_step})")
    check(in_clip <= clip_waits_max, f"{label}: {in_clip} host waits in track_clip_device (max {clip_waits_max})")
    return {"waits_per_step": max(per_step), "waits_in_clip": in_clip}


def run_main_path(tracker_overrides: dict | None = None, rmse_bound: float = RMSE_BOUND_PX) -> dict:
    """One main path, 60 frames through Tracker.run on the card, in turns
    eagerly and through the captured graphs (run_turns); the launch counts
    of each run by shape, the lost flags and the RMSE."""
    cfg_dict = copy.deepcopy(SMOKE_CONFIG)
    cfg_dict["model"]["checkpoint"] = str(ROOT / CHECKPOINT)
    cfg_dict["io"]["num_frames"] = FRAMES
    cfg_dict["tracker"].update(tracker_overrides or {})
    cfg = Config.from_dict(cfg_dict)
    crop = cfg.tracker.mode == "crop"
    src = open_source(cfg.io.source, cfg.io.num_frames, tuple(cfg.io.frame_size), seed=cfg.filter.seed)
    prm = vit_params.resolve_vit_params(cfg, None, "cuda")
    runs = run_turns(cfg, prm, src)
    depth = cfg.model.depth
    n, heads = cfg.filter.num_particles, cfg.model.heads
    for run in runs:
        recs = run["recs"]
        probes = 0
        if not crop and (cfg.filter.lost_conf_threshold > 0 or cfg.filter.lost_conf_ratio > 0):
            probes = sum(r["lost"] for r in recs[:-1])  # a step probes when the state was lost
        # init + one per step + lost-only probes (dense); crop mode adds the
        # template EMA's forward at the estimate every step and has no probe.
        template_forwards = len(recs) if crop and cfg.tracker.template_ema > 0 else 0
        forwards = 1 + len(recs) + probes + template_forwards
        t = run["tracker"].spec.seq_len
        # By shape: crop mode's particle forward is at B = N particles, its
        # init and template forwards at B = 1; dense mode's every forward at B = 1.
        if crop:
            k1_expected = {(n, heads, t): depth * len(recs), (1, heads, t): depth * (1 + template_forwards)}
            k2_sizes_expected = {n: len(recs), 1: 1 + template_forwards}
        else:
            k1_expected, k2_sizes_expected = {(1, heads, t): depth * forwards}, {}
        kind = "graph" if run["graphs"] else "eager"
        print(f"  {cfg.tracker.mode} path, {kind} run: K1 launches {run['launches']} (expected {depth} x {forwards} "
              f"forwards = {depth * forwards}), by (B, H, T) {run['k1_shapes']} (expected {k1_expected}); K2 "
              f"{run['k2_launches']} by N {run['k2_sizes']} (expected {k2_sizes_expected})", flush=True)
        check(run["launches"] == depth * forwards, f"K1 launches {run['launches']} == {depth * forwards}")
        check(run["k2_launches"] == (forwards if crop else 0), f"K2 launches {run['k2_launches']}")
        check(run["k1_shapes"] == k1_expected, f"K1 launches by shape {run['k1_shapes']} == {k1_expected}")
        check(run["k2_sizes"] == k2_sizes_expected, f"K2 launches by N {run['k2_sizes']} == {k2_sizes_expected}")
        check(run["swiglu_launches"] == 0, f"no SwiGLU launch on the GELU ViT ({run['swiglu_launches']})")
        junctions = junction_expected(k1_expected, cfg)
        check(run["junction_shapes"] == junctions,
              f"pre-norm junction launches by (M, D) {run['junction_shapes']} == {junctions} (2 x {depth} + 1 a "
              f"forward)")
        check(len(recs) == FRAMES - 1, f"{len(recs)} records for {FRAMES} frames")
        check(not any(r["lost"] for r in recs), "no record is lost")
        pos = np.array([r["position"] for r in recs])
        check(bool(np.all(np.isfinite(pos))), "positions are finite")
        err = np.linalg.norm(pos - src.truth[1:], axis=1)
        run["rmse"] = float(np.sqrt(np.mean(err**2)))
        check(run["rmse"] <= rmse_bound, f"RMSE {run['rmse']} px within {rmse_bound} px")
    rmse = runs[1]["rmse"]
    print(f"  RMSE {rmse:.3f} px on the graph runs, {runs[0]['rmse']:.3f} px on the eager ones (bound "
          f"{rmse_bound:.2f} px)", flush=True)
    summary = check_turns(runs, f"{cfg.tracker.mode} path")
    frames = list(src)
    waits = check_waits(runs[2]["tracker"], frames[1:], 0, f"{cfg.tracker.mode} path")
    g = runs[1]
    return {"launches": g["launches"], "k1_shapes": g["k1_shapes"], "k2_launches": g["k2_launches"],
            "k2_sizes": g["k2_sizes"], "junction_shapes": g["junction_shapes"], "rmse_px": rmse, **summary, **waits,
            "cfg": cfg, "prm": prm, "src": src, "recs": g["recs"]}


# The DINOv2 path: the dinov2-g14-reg preset's block and prefix at 2 of its
# 40 blocks (a 224-px window: T 261, M 261 rows into the SwiGLU gate).
DINOV2_DEPTH = 2


def run_dinov2_path() -> dict:
    """The preset's block cut to DINOV2_DEPTH blocks on the dense path's
    values and clip (config.yaml's, 60 frames of 480x640 moving-square), on
    the program's random init with LayerScale gammas drawn uniform on [0.1,
    1] a channel (as a DINOv2 checkpoint brings them; folded when the tracker
    casts the weights), in turns eagerly and through the graphs
    (run_turns): K1 at [1, 24, 261, 64] and the SwiGLU gate at (261, 4096)
    once a block a forward in every run, the records finite and equal
    between graph and eager (check_turns). The random backbone does not
    track the target, so no RMSE is held."""
    cfg_dict = copy.deepcopy(SMOKE_CONFIG)
    cfg_dict["model"] = dict(VIT_PRESETS["dinov2-g14-reg"], variant="custom", depth=DINOV2_DEPTH, image_size=224,
                             dtype="bfloat16", checkpoint="")
    cfg = Config.from_dict(cfg_dict)
    spec = VitSpec.from_config(cfg.model)
    prm = vit_params.init_vit_params(jax_random.key(24), spec, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(24)
    for name in ("ls1", "ls2"):
        prm["blocks"][name] = {"gamma": 0.1 + 0.9 * torch.rand((DINOV2_DEPTH, spec.dim), generator=g, device="cuda")}
    src = open_source(cfg.io.source, FRAMES, tuple(cfg.io.frame_size), seed=cfg.filter.seed)
    runs = run_turns(cfg, prm, src)
    t = 16 * 16 + spec.num_prefix
    gated = cfg.filter.lost_conf_threshold > 0 or cfg.filter.lost_conf_ratio > 0
    for run in runs:
        # init + one a step + a probe a step taken while lost (as run_main_path)
        forwards = 1 + len(run["recs"]) + (sum(r["lost"] for r in run["recs"][:-1]) if gated else 0)
        want = {(1, spec.heads, t): DINOV2_DEPTH * forwards}
        kind = "graph" if run["graphs"] else "eager"
        print(f"  dinov2 path, {kind} run: K1 {run['k1_shapes']}, SwiGLU {run['swiglu_shapes']} (expected "
              f"{DINOV2_DEPTH} x {forwards} forwards each), pre-norm junction {run['junction_shapes']}", flush=True)
        check(run["k1_shapes"] == want, f"dinov2 path: K1 launches by shape {run['k1_shapes']} == {want}")
        check(run["swiglu_shapes"] == {(t, spec.mlp_dim): DINOV2_DEPTH * forwards},
              f"dinov2 path: SwiGLU launches by shape {run['swiglu_shapes']}")
        check(run["junction_shapes"] == {(t, spec.dim): (2 * DINOV2_DEPTH + 1) * forwards},
              f"dinov2 path: pre-norm junction launches by shape {run['junction_shapes']} (2 x {DINOV2_DEPTH} + 1 "
              f"a forward)")
        check(bool(np.all(np.isfinite([r["position"] for r in run["recs"]]))), "dinov2 path: positions are finite")
    summary = check_turns(runs, "dinov2 path")
    g = runs[1]
    return {"k1_shapes": g["k1_shapes"], "swiglu_shapes": g["swiglu_shapes"], "junction_shapes": g["junction_shapes"],
            **summary}


def run_clip(path: dict) -> dict:
    """track_clip_device over the path's 59 frames in one call, from a fresh
    graph tracker: its records equal Tracker.run's on the graph path, and
    its frames/s (host clock from the call to the readback of all rows)."""
    cfg, src = path["cfg"], path["src"]
    tracker = Tracker(cfg, vit_params=path["prm"], device="cuda")
    tracker.init(src.frames[0], src.init_bbox)
    clip = torch.from_numpy(np.stack(src.frames[1:])).cuda()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    outs = tracker.track_clip_device(clip)
    rows = pack_rows(outs)
    seconds = time.perf_counter() - t0
    counts = read_counts()
    want = [[*r["position"], *r["box"], *r["velocity"], r["conf"], r["ess"], r["resampled"], r["lost"]]
            for r in path["recs"]]
    check(rows.shape == (len(want), 10) and np.array_equal(rows, np.array(want, np.float64)),
          f"track_clip_device's records == Tracker.run's ({rows.shape})")
    check(counts["k1_shapes"] == {k: v - cfg.model.depth for k, v in path["k1_shapes"].items()},
          f"track_clip_device launches {counts['k1_shapes']}: Tracker.run's less the init forward")
    fps = len(want) / seconds
    print(f"  track_clip_device over {len(want)} frames: {seconds * 1e3:.1f} ms, {fps:.1f} frames/s; records == "
          f"Tracker.run's (bitwise), K1 launches {counts['launches']}", flush=True)
    return {"clip_frames_per_s": fps, "clip_ms": seconds * 1e3}


def pack_rows(outs) -> np.ndarray:
    """A TrackOutput with a leading K axis -> [K, 10] float64 rows on the host."""
    cols = [outs.position, outs.box, outs.velocity, outs.conf[:, None], outs.ess[:, None],
            outs.resampled[:, None].float(), outs.lost[:, None].float()]
    return torch.cat(cols, dim=1).cpu().numpy().astype(np.float64)


def check_trunk_regeneration(tracker: Tracker, cfg: Config) -> float:
    """The head-only file's trunk, regenerated on the card from its trunk
    seed (timed), against the port's own CPU regeneration, bit for bit in
    f32: patch_embed/kernel and block 0's leaves (a depth-1 init on the CPU
    draws them as the depth-12 one does) and block 11's; then the tracker's
    cast trunk against the card's. Returns the regeneration's seconds."""
    spec = VitSpec.from_config(cfg.model)._replace(head_depth=0)
    key = vit_params.trunk_key(vit_params.load_params(str(ROOT / HEAD_CHECKPOINT))["__trunk_seed__"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = vit_params.init_vit_params(key, spec, "cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    numbers = sum(x.numel() for g in card["blocks"].values() for x in g.values()) + card["patch_embed"]["kernel"].numel()
    print(f"  trunk regenerated on the card: {seconds:.3f} s ({spec.depth} blocks, {numbers / 1e6:.1f} M numbers)",
          flush=True)
    cpu = vit_params.init_vit_params(key, spec._replace(depth=1), "cpu")
    last = spec.depth - 1
    cpu_last = vit_params.init_block_params(jax_random.split(key, 4 + spec.depth)[4 + last], spec, "cpu")
    pairs = {"patch_embed/kernel": (card["patch_embed"]["kernel"], cpu["patch_embed"]["kernel"])}
    for g, leaf in (("attn", "wqkv"), ("attn", "wo"), ("mlp", "w1"), ("mlp", "w2")):
        pairs[f"blocks/{g}/{leaf}[0]"] = (card["blocks"][g][leaf][0], cpu["blocks"][g][leaf][0])
        pairs[f"blocks/{g}/{leaf}[{last}]"] = (card["blocks"][g][leaf][last], cpu_last[g][leaf])
    for name, (a, b) in pairs.items():
        check(a.dtype == b.dtype == torch.float32 and torch.equal(a.cpu(), b), f"trunk leaf {name}: card == cpu")
    mine = tracker.vit_params
    check(torch.equal(mine["patch_embed"]["kernel"], card["patch_embed"]["kernel"]), "the tracker's patch_embed")
    for g, leaf in (("attn", "wqkv"), ("mlp", "w2")):
        check(torch.equal(mine["blocks"][g][leaf], card["blocks"][g][leaf].to(mine["blocks"][g][leaf].dtype)),
              f"the tracker's blocks/{g}/{leaf} is the regenerated trunk, cast")
    print(f"  trunk leaves equal to the CPU's, bit for bit: {', '.join(pairs)}; the tracker's trunk is this one",
          flush=True)
    return seconds


def run_robust_path() -> dict:
    """The robust main path (ROBUST_CONFIG) through Tracker.run on the card,
    in turns eagerly and through the captured graphs (run_turns): the
    launch counts of each run by shape, against its probes and scans (the
    graph's IF nodes run each branch only on the steps that need it); the
    scans and accepted matches read from the states each step leaves."""
    cfg_dict = copy.deepcopy(ROBUST_CONFIG)
    cfg_dict["model"]["checkpoint"] = str(ROOT / HEAD_CHECKPOINT)
    cfg = Config.from_dict(cfg_dict)
    frames = cfg.io.num_frames
    src = open_source(cfg.io.source, frames, tuple(cfg.io.frame_size), seed=cfg.filter.seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tracker = Tracker(cfg, device="cuda")
    torch.cuda.synchronize()
    print(f"  Tracker(cfg) on the card: {time.perf_counter() - t0:.3f} s (head file read, trunk regenerated, "
          "weights cast)", flush=True)
    regen_s = check_trunk_regeneration(tracker, cfg)
    n_after = cfg.tracker.redetect_global_after
    runs = run_turns(cfg, tracker.vit_params, src, n_after)
    depth = cfg.model.depth + cfg.model.head_depth
    heads, t = cfg.model.heads, tracker.spec.seq_len
    g2 = cfg.tracker.redetect_global_grid ** 2
    for run in runs:
        recs = run["recs"]
        scans, accepts = (sum(s[k] for s in run["steps"]) for k in range(2))
        probes = sum(r["lost"] for r in recs[:-1])  # a step probes when the state was lost
        # The scan's forward runs on the steps that trigger it, and takes
        # effect on those that accept.
        k1_expected = {(1, heads, t): depth * (1 + len(recs) + probes)}
        if scans:
            k1_expected[(g2, heads, t)] = depth * scans
        kind = "graph" if run["graphs"] else "eager"
        print(f"  robust path, {kind} run: {len(recs)} steps, {probes} probes, {scans} scans triggered, {accepts} "
              f"accepted matches; K1 launches by (B, H, T) {run['k1_shapes']} (expected {k1_expected}); K2 "
              f"{run['k2_launches']} (expected 0)", flush=True)
        check(scans >= 1 and accepts >= 1, f"at least one scan ({scans}) and one accepted match ({accepts})")
        check(run["k1_shapes"] == k1_expected, f"K1 launches by shape {run['k1_shapes']} == {k1_expected}")
        junctions = junction_expected(k1_expected, cfg)
        check(run["junction_shapes"] == junctions,
              f"pre-norm junction launches by (M, D) {run['junction_shapes']} == {junctions} (2 x "
              f"{cfg.model.depth} + 1 + 2 x {cfg.model.head_depth} + 1 a forward)")
        check(run["k2_launches"] == 0, "no K2 launch on the dense robust path")
        check(len(recs) == frames - 1, f"{len(recs)} records for {frames} frames")
        pos = np.array([r["position"] for r in recs])
        check(bool(np.all(np.isfinite(pos))), "positions are finite")
        run["lost"] = sum(r["lost"] for r in recs)
        check(ROBUST_LOST_RANGE[0] <= run["lost"] <= ROBUST_LOST_RANGE[1],
              f"{run['lost']} lost records within the JAX package's {ROBUST_LOST_RANGE}")
        check(not any(r["lost"] for r in recs[-5:]), "the last 5 records are not lost")
        # From the fourth record after the reappearance on, as tools/eval_quality.py.
        err = np.linalg.norm(pos - src.truth[1:], axis=1)[teleport_times(frames)[1] + 3:]
        run["rmse"] = float(np.sqrt(np.mean(err**2)))
        run["counts"] = (scans, accepts, probes)
        check(run["rmse"] <= ROBUST_RMSE_BOUND_PX, f"RMSE {run['rmse']} px within {ROBUST_RMSE_BOUND_PX} px")
    g = runs[1]
    scans, accepts, probes = g["counts"]
    print(f"  lost records: {g['lost']} of {len(g['recs'])} (JAX package: {ROBUST_LOST_RANGE[0]}-"
          f"{ROBUST_LOST_RANGE[1]}); last 5: {[r['lost'] for r in g['recs'][-5:]]}", flush=True)
    print(f"  RMSE after the reappearance {g['rmse']:.3f} px on the graph runs, {runs[0]['rmse']:.3f} px on the eager "
          f"ones (bound {ROBUST_RMSE_BOUND_PX:.2f} px; JAX package {ROBUST_RMSE_RANGE[0]}-{ROBUST_RMSE_RANGE[1]})",
          flush=True)
    summary = check_turns(runs, "robust path")
    waits = check_waits(runs[2]["tracker"], list(src)[1:], 0, "robust path")
    return {"launches": g["launches"], "k1_shapes": g["k1_shapes"], "k2_launches": g["k2_launches"],
            "k2_sizes": g["k2_sizes"], "junction_shapes": g["junction_shapes"], "rmse_px": g["rmse"],
            "lost": g["lost"], "scans": scans, "accepts": accepts,
            "probes": probes, "trunk_regen_s": regen_s, **summary, **waits, "cfg": cfg, "prm": tracker.vit_params,
            "src": src, "recs": g["recs"]}


def merge_banks(recs: list[dict]) -> dict:
    """A MultiTracker.step's K records as one record: each field's K values
    in bank order, the step's time once (so check_turns compares every
    bank)."""
    merged = {k: [r[k] for r in recs] for k in ("conf", "ess", "resampled", "lost")}
    for k in ("position", "box"):
        merged[k] = [x for r in recs for x in r[k]]
    merged["step_ms"] = recs[0]["step_ms"]
    return merged


def run_banked_path() -> dict:
    """The banked main path (BANKED_CONFIG) through MultiTracker.step on the
    card, in turns eagerly and through the captured graphs (eager, graph,
    graph, eager): records equal, K1 launches by shape counted per replay
    (12 a step and 12 at init, all at B 8), no lost record, the pooled RMSE
    over every bank and record, step medians, host waits."""
    cfg_dict = copy.deepcopy(BANKED_CONFIG)
    cfg_dict["model"]["checkpoint"] = str(ROOT / CHECKPOINT)
    cfg = Config.from_dict(cfg_dict)
    k, frames = cfg.runtime.banks, cfg.io.num_frames
    src = open_source(cfg.io.source, frames, tuple(cfg.io.frame_size), seed=cfg.filter.seed)
    check(src.init_bbox.shape == (k, 4), f"{cfg.io.source} gives a box for each of the {k} banks")
    prm = vit_params.resolve_vit_params(cfg, None, "cuda")
    runs = []
    for graphs in (False, True, True, False):
        tracker = banked.MultiTracker(cfg, vit_params=prm, device="cuda", graphs=graphs)
        reset_counts()
        tracker.init(src.frames[0], src.init_bbox)
        steps = [tracker.step(f) for f in src.frames[1:]]
        runs.append({"graphs": graphs, "recs": [merge_banks(r) for r in steps], "steps": steps, "tracker": tracker,
                     **read_counts()})
    depth, heads, t = cfg.model.depth, cfg.model.heads, runs[0]["tracker"].spec.seq_len
    k1_expected = {(k, heads, t): depth * frames}  # init + one forward a step, all K windows at once
    for run in runs:
        kind = "graph" if run["graphs"] else "eager"
        print(f"  banked path, {kind} run: K1 launches by (B, H, T) {run['k1_shapes']} (expected {k1_expected}); "
              f"K2 {run['k2_launches']} (expected 0)", flush=True)
        check(run["k1_shapes"] == k1_expected, f"K1 launches by shape {run['k1_shapes']} == {k1_expected}")
        check(run["k2_launches"] == 0, "no K2 launch on the dense banked path")
        check(len(run["steps"]) == frames - 1 and all(len(r) == k for r in run["steps"]),
              f"{k} records a step for {frames - 1} steps")
        check(not any(r["lost"] for step in run["steps"] for r in step), "no record is lost")
        pos = np.array([[r["position"] for r in step] for step in run["steps"]])  # [T-1, K, 2]
        check(bool(np.all(np.isfinite(pos))), "positions are finite")
        err = np.linalg.norm(pos - src.truth[1:], axis=-1)
        run["rmse"] = float(np.sqrt(np.mean(err**2)))
        run["rmse_by_bank"] = np.sqrt(np.mean(err**2, axis=0)).tolist()
        check(run["rmse"] <= BANKED_RMSE_BOUND_PX, f"pooled RMSE {run['rmse']} px within {BANKED_RMSE_BOUND_PX} px")
    g = runs[1]
    print(f"  pooled RMSE over {k} banks x {frames - 1} records {g['rmse']:.3f} px on the graph runs, "
          f"{runs[0]['rmse']:.3f} px on the eager ones (bound {BANKED_RMSE_BOUND_PX:.2f} px; JAX package "
          f"4.210-{JAX_BANKED_RMSE_PX_MAX}); by bank {[round(x, 3) for x in g['rmse_by_bank']]}", flush=True)
    summary = check_turns(runs, "banked path")
    waits = check_waits(runs[2]["tracker"], list(src)[1:], 0, "banked path")
    return {"launches": g["launches"], "k1_shapes": g["k1_shapes"], "rmse_px": g["rmse"],
            "rmse_px_by_bank": g["rmse_by_bank"], **summary, **waits, "cfg": cfg, "prm": prm, "src": src}


def check_reinit_bank(path: dict, steps: int = 12, at: int = 6) -> dict:
    """reinit_bank(1, ...) at step `at` on the card (bank 1 re-targeted onto
    target 2's box at the frame before) leaves bank 0's records bitwise as
    in a run without it, over the banked path's first `steps` steps; bank
    1's records after it change."""
    cfg, src = path["cfg"], path["src"]
    runs = []
    for reinit in (False, True):
        mt = banked.MultiTracker(cfg, vit_params=path["prm"], device="cuda")
        mt.init(src.frames[0], src.init_bbox)
        recs = []
        for i, f in enumerate(src.frames[1:steps + 1], start=1):
            if reinit and i == at:
                c, (w, h) = src.truth[i - 1, 2], src.init_bbox[2, 2:]
                mt.reinit_bank(1, src.frames[i - 1], [c[0] - w / 2, c[1] - h / 2, w, h])
            recs.append(mt.step(f))
        runs.append(recs)
    strip = [[{k: v for k, v in step[b].items() if k != "step_ms"} for step in recs] for recs in runs for b in (0, 1)]
    check(strip[0] == strip[2], "reinit_bank(1) leaves bank 0's records bitwise equal")
    check(strip[1][:at - 1] == strip[3][:at - 1] and strip[1][at:] != strip[3][at:],
          "bank 1's records equal before the reinit and differ after it")
    d2 = float(np.linalg.norm(np.subtract(runs[1][-1][1]["position"], src.truth[steps, 2])))
    print(f"  reinit_bank(1) at step {at}: bank 0's {steps} records bitwise equal to the run without it; bank 1 "
          f"{d2:.2f} px from target 2 after {steps - at + 1} more steps", flush=True)
    return {"reinit_bank1_px_from_target2": d2}


def run_multistream_path(dense: dict) -> dict:
    """The multi-stream main path: MultiStreamTracker over STREAMS clips on
    the card, step_packed a frame batch and its row read back (the serve
    command's step), eagerly and through the graphs: rows equal, K1 launches
    by shape, each stream's RMSE, and the graph step's aggregate frames/s
    beside the dense path's single-object graph step in this call."""
    cfg = dense["cfg"]
    size = tuple(cfg.io.frame_size)
    srcs = [open_source(cfg.io.source, FRAMES, size, seed=cfg.filter.seed + i) for i in range(STREAMS)]
    clips = np.stack([np.stack(x.frames) for x in srcs], axis=1)  # [T, K, H, W, 3]
    truth = np.stack([x.truth[1:] for x in srcs], axis=1)  # [T-1, K, 2]
    clips_dev = torch.from_numpy(clips).cuda()
    torch.cuda.synchronize()
    runs = []
    for graphs in (False, True, True, False):
        ms = banked.MultiStreamTracker(cfg, STREAMS, vit_params=dense["prm"], device="cuda", graphs=graphs)
        reset_counts()
        ms.init(clips[0], np.stack([x.init_bbox for x in srcs]))
        rows, times = [], []
        for t in range(1, FRAMES):
            t0 = time.perf_counter()
            rows.append(ms.step_packed(clips_dev[t]).cpu().numpy())
            times.append((time.perf_counter() - t0) * 1e3)
        runs.append({"graphs": graphs, "rows": np.stack(rows), "ms": statistics.median(times[5:]), **read_counts()})
    heads, t, depth = cfg.model.heads, VitSpec.from_config(cfg.model).seq_len, cfg.model.depth
    k1_expected = {(STREAMS, heads, t): depth * FRAMES}
    for run in runs:
        check(run["k1_shapes"] == k1_expected, f"multistream K1 launches {run['k1_shapes']} == {k1_expected}")
        check(np.array_equal(run["rows"], runs[0]["rows"]), "multistream rows: graph == eager, bitwise")
    out = runs[1]["rows"]
    pos = out[:, :2 * STREAMS].reshape(-1, STREAMS, 2)
    lost = out[:, 9 * STREAMS:10 * STREAMS]
    check(bool(np.all(np.isfinite(pos))) and not lost.any(), "multistream positions finite, no record lost")
    rmse = np.sqrt(np.mean(np.linalg.norm(pos - truth, axis=-1) ** 2, axis=0))
    for i, (r, jax_max) in enumerate(zip(rmse, JAX_STREAM_RMSE_PX_MAX)):
        check(r <= jax_max + 2.0, f"stream {i} RMSE {r} px within {jax_max + 2.0} px")
    g_ms = statistics.median(r["ms"] for r in runs if r["graphs"])
    e_ms = statistics.median(r["ms"] for r in runs if not r["graphs"])
    fps = STREAMS * 1e3 / g_ms
    dense_fps = 1e3 / dense["step_ms_median"]
    turns = "/".join(f"{r['ms']:.3f}" for r in runs)
    print(f"  multistream path, {STREAMS} streams x {FRAMES - 1} steps: K1 launches {runs[1]['k1_shapes']} (expected "
          f"{k1_expected}) on every run; rows graph == eager bitwise; RMSE by stream "
          f"{[round(float(x), 3) for x in rmse]} px (bounds {[x + 2.0 for x in JAX_STREAM_RMSE_PX_MAX]})", flush=True)
    print(f"  multistream step ms, median after 5 warm-up, turns eager/graph/graph/eager: "
          f"{turns}; graph {g_ms:.3f} ms a batch of {STREAMS} "
          f"frames = {fps:.1f} frames/s aggregate, against the dense path's single-object graph step "
          f"{dense['step_ms_median']:.3f} ms = {dense_fps:.1f} frames/s in this call ({fps / dense_fps:.2f}x); "
          f"eager {e_ms:.3f} ms", flush=True)
    return {"launches": runs[1]["launches"], "k1_shapes": runs[1]["k1_shapes"], "step_ms_median": g_ms,
            "eager_step_ms_median": e_ms, "aggregate_frames_per_s": fps, "dense_frames_per_s": dense_fps,
            "rmse_px_by_stream": rmse.tolist(), "rows": runs[1]["rows"]}


STREAM_KEYS = ("frame", "position", "box", "velocity", "conf", "ess", "lost")
STAGE_KEYS = ("fps", "wall_s", "init_s", "ingest_wait_s", "submit_s", "readback_s", "drain_s", "drain_windows",
              "staging_waits")


def run_stream(path: dict, label: str) -> dict:
    """stream_track over a main path's clip on the card (a fresh graph
    Tracker with the path's weights, readback window 4, pump depth
    runtime.prefetch_frames): its records bitwise equal to the path's
    Tracker.run graph records; K1 launches by shape equal to that run's
    (init included in both); the submitting thread's host waits, by where
    they fall (init and capture, the loop, the final completion), none in
    the loop; the drainer's; the stage times."""
    cfg, src = path["cfg"], path["src"]
    tracker = Tracker(cfg, vit_params=path["prm"], device="cuda")
    recs, stats, stacks, drainer_stacks = [], {}, [], []

    def go():
        stats.update(stream_track(tracker, src.frames, src.init_bbox, on_record=recs.append, readback_window=4,
                                  pump_depth=cfg.runtime.prefetch_frames))

    reset_counts()
    count_waits(go, stacks, thread=threading.get_ident(), others=drainer_stacks)
    counts = read_counts()
    where = Counter("init" if "tracker.init(frame0" in x else "final" if "_complete(tracker)" in x else "loop"
                    for x in stacks)
    if where["loop"]:
        for stack in stacks:
            print(f"  a wait, at:\n{stack}", flush=True)
    want = [{k: r[k] for k in STREAM_KEYS} for r in path["recs"]]
    check(len(recs) == len(want) and all({k: r[k] for k in STREAM_KEYS} == w for r, w in zip(recs, want)),
          f"{label}: stream records == Tracker.run's graph records, bitwise ({len(recs)} records)")
    check(counts["k1_shapes"] == path["k1_shapes"],
          f"{label}: K1 launches {counts['k1_shapes']} == Tracker.run's {path['k1_shapes']}")
    check(where["loop"] == 0 and where["final"] == 1,
          f"{label}: submitting thread's host waits {dict(where)} (none in the loop, one final completion)")
    print(f"  {label}: {len(recs)} records == Tracker.run's graph records (bitwise); K1 launches "
          f"{counts['k1_shapes']}; submitting thread's host waits: {where['loop']} in the loop, {where['init']} in "
          f"init and capture, {where['final']} final completion; drainer: {len(drainer_stacks)} waits over "
          f"{stats['drain_windows']} windows; staging slot waits {stats['staging_waits']}", flush=True)
    after_init = stats["frames"] / (stats["wall_s"] - stats["init_s"])
    print(f"  {label}: {stats['fps']:.1f} frames/s end to end ({stats['frames']} frames in {stats['wall_s']:.3f} s, "
          f"init and capture {stats['init_s']:.3f} s of it; {after_init:.1f} frames/s after init); ingest_wait_s "
          f"{stats['ingest_wait_s']}, submit_s {stats['submit_s']}, readback_s {stats['readback_s']}, drain_s "
          f"{stats['drain_s']}", flush=True)
    return {**{k: stats[k] for k in STAGE_KEYS}, "frames_per_s_after_init": after_init,
            "submit_thread_loop_waits": where["loop"],
            "submit_thread_init_waits": where["init"], "drainer_waits": len(drainer_stacks)}


def run_serve(dense: dict, streams: dict) -> dict:
    """The serve command through cli.main on the card: STREAMS streams of
    the dense path's clip (seeds 0-3), config.yaml's values from a JSON
    config file: STREAMS x (FRAMES - 1) records, each stream complete and in
    order, positions equal to the multi-stream path's graph rows; the
    aggregate frames/s beside the multi-stream path's step rate."""
    cfg_dict = copy.deepcopy(SMOKE_CONFIG)
    cfg_dict["model"]["checkpoint"] = str(ROOT / CHECKPOINT)
    with tempfile.TemporaryDirectory() as tmp:
        out = str(Path(tmp) / "serve.jsonl")
        cfg_dict["io"].update(num_frames=FRAMES, output=out)
        cfg_dict["runtime"]["streams"] = STREAMS
        cfg_path = Path(tmp) / "serve.json"
        cfg_path.write_text(json.dumps(cfg_dict))
        reset_counts()
        t0 = time.perf_counter()
        summary = io.StringIO()
        with contextlib.redirect_stderr(summary):
            rc = cli.main(["serve", "--config", str(cfg_path)])
        seconds = time.perf_counter() - t0
        counts = read_counts()
        recs = [json.loads(line) for line in open(out)]
    check(rc == 0, f"serve exit code {rc}")
    check(len(recs) == STREAMS * (FRAMES - 1), f"serve wrote {len(recs)} records ({STREAMS} x {FRAMES - 1})")
    rows = streams["rows"]
    for i in range(STREAMS):
        mine = [r for r in recs if r["stream"] == i]
        check([r["frame"] for r in mine] == list(range(1, FRAMES)), f"serve stream {i}: frames complete and ordered")
        pos = np.array([r["position"] for r in mine], np.float32)
        want = rows[:, :2 * STREAMS].reshape(-1, STREAMS, 2)[:, i]
        check(np.array_equal(pos, want), f"serve stream {i}: positions == the multi-stream path's graph rows")
    heads, t, depth = dense["cfg"].model.heads, VitSpec.from_config(dense["cfg"].model).seq_len, dense["cfg"].model.depth
    k1_want = {(STREAMS, heads, t): depth * FRAMES}
    check(counts["k1_shapes"] == k1_want, f"serve K1 launches {counts['k1_shapes']} == {k1_want}")
    m = re.search(r"\(([\d.]+) fps aggregate", summary.getvalue())
    check(m is not None, f"serve's summary line: {summary.getvalue()!r}")
    fps = float(m.group(1))
    print(f"  serve ({STREAMS} streams x {FRAMES - 1} frames through cli.main): {len(recs)} records, each stream "
          f"complete and ordered, positions == the multi-stream path's graph rows (bitwise); K1 launches "
          f"{counts['k1_shapes']}; its summary: {summary.getvalue().strip()!r}; {fps:.1f} frames/s aggregate "
          f"(stream_track's wall, init and capture included; the whole command {seconds:.3f} s with the weights' "
          f"load), against the multi-stream path's graph step {streams['aggregate_frames_per_s']:.1f} frames/s",
          flush=True)
    return {"frames_per_s": fps, "command_s": seconds, "records": len(recs),
            "multistream_frames_per_s": streams["aggregate_frames_per_s"]}


def roi_scans(tracker: Tracker, min_chunk: int = 1) -> int:
    """Global scans run inside the tracker's ROI graphs of at least
    `min_chunk` frames, from their IF nodes' counters on the card (one
    wait): the scan is each step's last branch."""
    probe, n_after = step_branches(tracker.cfg)
    per_step = int(probe) + int(n_after > 0)
    if n_after <= 0:
        return 0
    return sum(sum(sg.taken.tolist()[per_step - 1::per_step]) for key, sg in tracker._chunk_graphs.items()
               if key[0][0] >= min_chunk)


ROI_KEYS = (*STAGE_KEYS, "frames", "dispatches", "shipped_bytes_per_frame", "steer_fetches", "frames_per_s_after_init",
            "submit_ms_per_dispatch", "submit_thread_loop_waits", "submit_thread_init_waits", "rmse_px", "lost",
            "scans_in_graphs", "scans_in_chunk_graphs", "recover_err_px", "redetect_frames", "vit_init_s")


def stream_waits(go, label: str) -> tuple[Counter, list]:
    """Run go() counting the host's waits: the submitting thread's by where
    they fall (init, the graphs' captures and the staging slots'
    allocation; the loop; the final completion) and the other threads'."""
    stacks, others = [], []
    count_waits(go, stacks, thread=threading.get_ident(), others=others)
    init_marks = ("tracker.init(frame0", "tracker.prepare_stream(", "_reserve_staging(")
    where = Counter("init" if any(m in x for m in init_marks) else "final" if "_complete(tracker)" in x else "loop"
                    for x in stacks)
    if where["loop"]:
        for stack in stacks:
            print(f"  a wait, at:\n{stack}", flush=True)
    check(where["loop"] == 0 and where["final"] == 1,
          f"{label}: submitting thread's host waits {dict(where)} (none in the loop, one final completion)")
    return where, others


def run_roi_stream(cfg: Config, src, label: str, prm=None, **overrides) -> dict:
    """stream_track over a source with the stream command's arguments
    (cli.stream_kwargs of the config, then `overrides`) on a fresh graph
    Tracker: records complete and in order, the submitting thread's host
    waits (none in the loop), the launches by shape, the scans run inside
    chunk graphs, the stage times and rates."""
    tracker = Tracker(cfg, vit_params=prm, device="cuda")
    recs, stats = [], {}
    kwargs = {**cli.stream_kwargs(cfg), **overrides}

    def go():
        stats.update(stream_track(tracker, src, src.init_bbox, on_record=recs.append, **kwargs))

    reset_counts()
    where, others = stream_waits(go, label)
    counts = read_counts()
    recs.sort(key=lambda r: r["frame"])
    frames = len(src) if hasattr(src, "read_rect") else len(src.frames)
    check([r["frame"] for r in recs] == list(range(1, frames)), f"{label}: records complete and in order")
    pos = np.array([r["position"] for r in recs])
    check(bool(np.all(np.isfinite(pos))), f"{label}: positions are finite")
    err = np.linalg.norm(pos - np.asarray(src.truth)[1:frames], axis=1)
    dispatches = sum(stats["dispatches"].values())
    after_init = stats["frames"] / (stats["wall_s"] - stats["init_s"])
    out = {**{k: stats[k] for k in STAGE_KEYS}, "frames": stats["frames"], "dispatches": stats["dispatches"],
           "shipped_bytes_per_frame": stats["shipped_bytes_per_frame"], "steer_fetches": stats["steer_fetches"],
           "frames_per_s_after_init": after_init, "submit_ms_per_dispatch": stats["submit_s"] * 1e3 / dispatches,
           "submit_thread_loop_waits": where["loop"], "submit_thread_init_waits": where["init"],
           "other_threads_waits": len(others), "rmse_px": float(np.sqrt(np.mean(err**2))),
           "lost": int(sum(r["lost"] for r in recs)), "scans_in_graphs": roi_scans(tracker),
           "scans_in_chunk_graphs": roi_scans(tracker, 2), **counts}
    print(f"  {label}: {out['frames']} frames, dispatches by size {stats['dispatches']}; {stats['fps']:.1f} frames/s "
          f"end to end ({stats['wall_s']:.3f} s, init and captures {stats['init_s']:.3f} s of it), "
          f"{after_init:.1f} frames/s after init; shipped {out['shipped_bytes_per_frame']:.0f} B a frame; submit "
          f"{out['submit_ms_per_dispatch']:.3f} ms a dispatch; ingest_wait_s {stats['ingest_wait_s']}, readback_s "
          f"{stats['readback_s']} (the flow control's sleeps with it), drain_s {stats['drain_s']}; staging slot waits "
          f"{stats['staging_waits']}; submitting thread's host waits: {where['loop']} in the loop, {where['init']} in "
          f"init and capture, {where['final']} final completion; other threads' waits {len(others)} (steer fetches "
          f"{stats['steer_fetches']}, drain windows {stats['drain_windows']})", flush=True)
    print(f"  {label}: RMSE {out['rmse_px']:.3f} px over {len(recs)} records, {out['lost']} lost; K1 launches by "
          f"(B, H, T) {counts['k1_shapes']}, K2 by N {counts['k2_sizes']}; scans inside the chunk graphs "
          f"{out['scans_in_graphs']}", flush=True)
    return {**out, "recs": recs, "tracker": tracker, "err": err}


def expected_roi_k1(cfg: Config, recs: list[dict], scans: int, spec: VitSpec) -> dict:
    """K1 launches by (B, H, T) of a dense ROI stream: one forward at init
    and a step, one more on each step whose state was lost (the probe), and
    the scan's G*G windows in one forward on each scan."""
    depth, heads, t = cfg.model.depth + cfg.model.head_depth, cfg.model.heads, spec.seq_len
    probes = sum(r["lost"] for r in recs[:-1]) if step_branches(cfg)[0] else 0
    want = {(1, heads, t): depth * (1 + len(recs) + probes)}
    if scans:
        want[(cfg.tracker.redetect_global_grid ** 2, heads, t)] = depth * scans
    return want


def run_eval5_roi() -> dict:
    """a. eval5-roi-c4: eval5's streaming form at full width (EVAL5_CONFIG,
    ViT-L/16 on the port's JAX-exact random init, 16384 particles, 4K
    through a NativeSyntheticSource, ROI 1600 shipped as a 288-px view,
    glob /8 every 4, chunk 4), through stream_track with the stream
    command's arguments: the submitting thread waits for nothing in the
    loop, K1 launches by shape against the probes and scans, the RMSE within
    the JAX package's worst plus 2 px."""
    from vitparticlefiltertracker_tpu_torch.io.native import NativeSyntheticSource

    cfg = Config.from_dict(copy.deepcopy(EVAL5_CONFIG))
    src = open_source(cfg.io.source, cfg.io.num_frames, tuple(cfg.io.frame_size), seed=cfg.filter.seed)
    check(isinstance(src, NativeSyntheticSource), f"eval5's source is the native ring ({type(src).__name__})")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prm = vit_params.resolve_vit_params(cfg, None, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    print(f"  ViT-L/16 random init on the card (JAX's threefry, models/jax_random.py): {init_s:.3f} s", flush=True)
    run = run_roi_stream(cfg, src, "eval5-roi-c4", prm)
    want = expected_roi_k1(cfg, run["recs"], run["scans_in_graphs"], run["tracker"].spec)
    check(run["k1_shapes"] == want, f"eval5-roi-c4: K1 launches by shape {run['k1_shapes']} == {want}")
    check(run["k1_shapes"].get(EVAL5_DENSE_SHAPE[:3], 0) > 0, "eval5-roi-c4: K1 ran at [1, 16, 196, 64]")
    check(run["k2_launches"] == 0, "eval5-roi-c4: no K2 launch on the dense path")
    check(run["dispatches"].get(4, 0) == (cfg.io.num_frames - 1) // 4, f"eval5-roi-c4: chunks of 4 {run['dispatches']}")
    check(run["rmse_px"] <= EVAL5_RMSE_BOUND_PX,
          f"eval5-roi-c4: RMSE {run['rmse_px']} px within {EVAL5_RMSE_BOUND_PX} px (JAX {JAX_EVAL5_RMSE_PX})")
    print(f"  eval5-roi-c4: RMSE {run['rmse_px']:.3f} px within {EVAL5_RMSE_BOUND_PX:.3f} px (the JAX package on "
          f"the CPU, filter seeds 0-3: {JAX_EVAL5_RMSE_PX})", flush=True)
    src.close()
    return {**run, "cfg": cfg, "prm": prm, "vit_init_s": init_s}


def run_eval5_teleport(eval5: dict) -> dict:
    """b. eval5-roi-teleport-c4 (tools/bench_stream_e2e.py's cell):
    synthetic:teleport at 4K with eval5's tracker, ROI 1600 at stride 4,
    glob /8 every 4, chunk 4, on TELEPORT_FRAMES frames (the teleport and
    the recovery): at least one global scan on the glob view inside a chunk
    graph (an IF node), K1 at [25, 16, 196, 64], an accepted re-detection
    (the lost track jumps to the reappearance) and the error from the tenth
    frame after the reappearance on within the JAX package's worst plus 2 px."""
    cfg_dict = copy.deepcopy(EVAL5_CONFIG)
    cfg_dict["io"].update(source="synthetic:teleport", num_frames=TELEPORT_FRAMES)
    cfg_dict["runtime"]["stream_roi_out"] = 0
    cfg = Config.from_dict(cfg_dict)
    t0 = time.perf_counter()
    src = open_source(cfg.io.source, cfg.io.num_frames, tuple(cfg.io.frame_size), seed=0)
    print(f"  synthetic:teleport, {TELEPORT_FRAMES} frames of 2160x3840 made on the host: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    run = run_roi_stream(cfg, src, "eval5-roi-teleport-c4", eval5["prm"])
    hide, show = teleport_times(cfg.io.num_frames)
    recs, err = run["recs"], run["err"]
    jumps = [r["frame"] for a, r in zip(recs, recs[1:]) if a["lost"] and not r["lost"] and r["frame"] > show
             and np.hypot(*np.subtract(r["position"], a["position"])) > src.init_bbox[2]]
    recover = float(np.mean([e for r, e in zip(recs, err) if r["frame"] >= show + 10]))
    want = expected_roi_k1(cfg, recs, run["scans_in_graphs"], run["tracker"].spec)
    print(f"  eval5-roi-teleport-c4: hidden from frame {hide}, back at {show}; {run['lost']} lost records; "
          f"{run['scans_in_graphs']} scans inside chunk graphs; accepted re-detections (a lost record followed "
          f"by a locked one more than a box away) at frames {jumps}; mean error from frame {show + 10} on "
          f"{recover:.3f} px (bound {TELEPORT_RECOVER_BOUND_PX:.3f}: the JAX package's {JAX_TELEPORT_RECOVER_PX} "
          f"+ 2); K1 {run['k1_shapes']} (expected {want})", flush=True)
    print("  eval5-roi-teleport-c4: error (px) and lost flag from frame " + str(hide) + ": "
          + ", ".join(f"{r['frame']}:{e:.0f}{'L' if r['lost'] else ''}" for r, e in zip(recs, err) if r["frame"] >= hide),
          flush=True)
    check(run["scans_in_chunk_graphs"] >= 1, "eval5-roi-teleport-c4: a global scan ran inside a chunk graph")
    check(run["k1_shapes"].get(EVAL5_REDETECT_SHAPE[:3], 0) > 0, "eval5-roi-teleport-c4: K1 ran at [25, 16, 196, 64]")
    check(run["k1_shapes"] == want, f"eval5-roi-teleport-c4: K1 launches by shape {run['k1_shapes']} == {want}")
    check(len(jumps) >= 1, "eval5-roi-teleport-c4: an accepted re-detection")
    check(recover <= TELEPORT_RECOVER_BOUND_PX,
          f"eval5-roi-teleport-c4: the track recovers ({recover} px within {TELEPORT_RECOVER_BOUND_PX} px)")
    return {**run, "recover_err_px": recover, "redetect_frames": jumps}


def check_chunk_equals_steps(eval5: dict, c: int = 4) -> dict:
    """c. On fixed StreamFrames (eval5's native source: C resampled ROI
    views around the truth and one glob view, on the card), one
    step_chunk_packed of C equals C step_packed calls of a second tracker
    from the same init (both graph replays): expected bitwise (the same
    kernels on the same inputs); held to GRAPH_POS_TOL_PX on the positions
    and exact flags in case cuBLAS picks another GEMM algorithm for a graph
    captured on another stream."""
    from vitparticlefiltertracker_tpu_torch.io.native import NativeSyntheticSource
    from vitparticlefiltertracker_tpu_torch.ops.image import FrameView, StreamFrame

    cfg = eval5["cfg"]
    h, w = cfg.io.frame_size
    src = NativeSyntheticSource(c + 1, h, w, seed=0)
    rt = cfg.runtime
    span, out = rt.stream_roi, rt.stream_roi_out
    sv = span / out
    views, origins = [], []
    for i in range(1, c + 1):
        cx, cy = src.truth[i]
        ox, oy = int(np.clip(round(cx - span / 2), 0, w - span)), int(np.clip(round(cy - span / 2), 0, h - span))
        views.append(src.read_view(i, ox + 0.5 * sv, oy + 0.5 * sv, sv, out))
        origins.append([ox + 0.5 * sv, oy + 0.5 * sv])
    dev = torch.device("cuda")
    glob = FrameView(torch.from_numpy(src.read_rect(1, 0, 0, w, h, rt.stream_glob_stride)).to(dev),
                     torch.zeros(2, device=dev), float(rt.stream_glob_stride))
    pixels = torch.from_numpy(np.stack(views)).to(dev)
    orgs = torch.tensor(origins, dtype=torch.float32, device=dev)
    frame0 = src.read(0)
    trackers = [Tracker(cfg, vit_params=eval5["prm"], device="cuda") for _ in range(2)]
    for tr in trackers:
        tr.init(frame0, src.init_bbox)
    rows_c = trackers[0].step_chunk_packed(StreamFrame(FrameView(pixels, orgs, sv), glob))
    rows_s = torch.stack([trackers[1].step_packed(StreamFrame(FrameView(pixels[i], orgs[i], sv), glob))
                          for i in range(c)])
    a, b = rows_c.cpu().numpy(), rows_s.cpu().numpy()
    bitwise = bool(np.array_equal(a, b))
    diff = float(np.abs(a[:, :2] - b[:, :2]).max())
    check(a.shape == (c, 10) and np.array_equal(a[:, 8:], b[:, 8:]) and diff <= GRAPH_POS_TOL_PX,
          f"chunk of {c} == {c} single steps (positions within {GRAPH_POS_TOL_PX} px: {diff}; flags equal)")
    graphs = sorted(k[0][0] for k in trackers[0]._chunk_graphs) + sorted(k[0][0] for k in trackers[1]._chunk_graphs)
    print(f"  step_chunk_packed at C = {c} == {c} step_packed calls on the card ({'bitwise' if bitwise else f'max position diff {diff:.2e} px'}"
          f", flags equal), eval5's tracker on fixed StreamFrames; chunk graphs captured (C): {graphs}", flush=True)
    src.close()
    return {"bitwise": bitwise, "max_pos_diff_px": diff}


def run_adaptive_roi() -> dict:
    """c. Adaptive chunk sizing on the card: config.yaml's dense values
    (ViT-B/16 checkpoint) on ADAPTIVE_FRAMES frames of 480x640 through the
    native ring, ROI 256, chunk 2 up to chunk_max 8, fps_target forced out
    of reach: the size switches at least once, records stay complete and in
    order, the submitting thread waits for nothing in the loop."""
    cfg_dict = copy.deepcopy(SMOKE_CONFIG)
    cfg_dict["model"]["checkpoint"] = str(ROOT / CHECKPOINT)
    cfg_dict["io"].update(source="native-synthetic:moving-square", num_frames=ADAPTIVE_FRAMES)
    cfg_dict["runtime"].update(stream_roi=256, stream_chunk=2, stream_chunk_max=8, stream_fps_target=1e9,
                               stream_steer_lag=16)
    cfg = Config.from_dict(cfg_dict)
    src = open_source(cfg.io.source, cfg.io.num_frames, tuple(cfg.io.frame_size), seed=cfg.filter.seed)
    run = run_roi_stream(cfg, src, "adaptive ROI stream (chunk 2..8)")
    check(len([s for s in run["dispatches"] if s > 1]) >= 2, f"the dispatch size switched ({run['dispatches']})")
    want = expected_roi_k1(cfg, run["recs"], 0, run["tracker"].spec)
    check(run["k1_shapes"] == want, f"adaptive ROI stream: K1 launches by shape {run['k1_shapes']} == {want}")
    check(run["rmse_px"] <= ADAPTIVE_RMSE_BOUND_PX, f"adaptive ROI stream RMSE {run['rmse_px']} px within "
          f"{ADAPTIVE_RMSE_BOUND_PX} px")
    src.close()
    return run


def run_crop_roi(crop_path: dict) -> dict:
    """d. A crop-mode ROI stream at ViT-B/16 (the crop main path's config and
    clip, ROI 320 at stride 2, chunk 4): K2 runs on windows resampled from
    the strided view (launches by N: the particles and the template EMA each
    step, and init); and K2 against its plain version on such a window (the
    ROI view of frame 1, the window at the truth, boxes around it)."""
    from vitparticlefiltertracker_tpu_torch.ops.image import FrameView, frame_to_window_coords, view_extract_window_mxu
    from vitparticlefiltertracker_tpu_torch.runtime.tracker import _norm_folded_embed_weights

    cfg_dict = copy.deepcopy(SMOKE_CONFIG)
    cfg_dict["model"]["checkpoint"] = str(ROOT / CHECKPOINT)
    cfg_dict["tracker"].update(CROP_OVERRIDES)
    cfg_dict["io"]["num_frames"] = FRAMES
    cfg_dict["runtime"].update(CROP_ROI_RUNTIME)
    cfg = Config.from_dict(cfg_dict)
    src = crop_path["src"]
    run = run_roi_stream(cfg, src, "crop-roi", crop_path["prm"])
    n = cfg.filter.num_particles
    want = {n: FRAMES - 1, 1: FRAMES}  # the particles a step; the template EMA a step and init
    check(run["k2_sizes"] == want, f"crop-roi: K2 launches by N {run['k2_sizes']} == {want}")
    check(run["rmse_px"] <= CROP_ROI_RMSE_BOUND_PX,
          f"crop-roi: RMSE {run['rmse_px']} px within {CROP_ROI_RMSE_BOUND_PX} px (JAX {JAX_CROP_ROI_RMSE_PX})")
    # K2 on a window resampled from the strided ROI view, against its plain version.
    rt, t = cfg.runtime, cfg.tracker
    frame = src.frames[1]
    cx, cy = src.truth[1]
    span, s = rt.stream_roi, rt.stream_roi_stride
    ox, oy = int(round(cx - span / 2)), int(round(cy - span / 2))
    dev = torch.device("cuda")
    view = FrameView(torch.from_numpy(np.ascontiguousarray(frame[oy:oy + span:s, ox:ox + span:s])).to(dev).float(),
                     torch.tensor([ox, oy], dtype=torch.float32, device=dev), float(s))
    center = torch.tensor([cx, cy], dtype=torch.float32, device=dev)
    box = torch.tensor(src.init_bbox[2:], dtype=torch.float32, device=dev)
    side = t.search_scale * torch.sqrt(box[0] * box[1])
    window = view_extract_window_mxu(view, center, side, t.window_size)
    g = torch.Generator(device="cuda").manual_seed(3)
    boxes_xy = center + 4.0 * torch.randn((n, 2), generator=g, device=dev)
    ctr = frame_to_window_coords(boxes_xy, center, side, t.window_size)
    wh = (box * (t.window_size / side)).expand(n, 2).contiguous()
    kern, bias = _norm_folded_embed_weights(crop_path["prm"], run["tracker"].spec)
    saved = step_graph.read_counts()
    got = pw.window_gather_patchify(window, ctr, wh, t.crop_size, cfg.model.patch_size, kern, bias)  # K2, as the step
    step_graph.restore_counts(saved)
    check(pw.gather_patchify_window.launches == saved[1][0], "the comparison's K2 launch is not counted")
    ref = pw.window_gather_patchify_plain(window, ctr, wh, t.crop_size, cfg.model.patch_size, kern, bias)
    torch.cuda.synchronize()
    k2_err = float((got.float() - ref.float()).abs().max())
    check(torch.allclose(got.float(), ref.float(), **K2_TOL[kern.dtype]),
          f"K2 on a window from a stride-{s} ROI view agrees with its plain version (max err {k2_err})")
    print(f"  crop-roi: K2 launches by N {run['k2_sizes']} (expected {want}); RMSE {run['rmse_px']:.3f} px within "
          f"{CROP_ROI_RMSE_BOUND_PX:.3f} px (JAX package {JAX_CROP_ROI_RMSE_PX}); K2 on a window resampled from the "
          f"stride-{s} ROI view ({n} boxes, {kern.dtype}) against its plain version: max_abs_err {k2_err:.3e} "
          f"(tol {K2_TOL[kern.dtype]})", flush=True)
    return {**run, "k2_roi_view_max_abs_err": k2_err}


BENCH_KEYS = ("fps", "fps_serving", "p50_ms", "p99_ms", "p50_device_ms", "p50_device_source", "rtt_ms",
              "est_gflops_per_frame", "achieved_tflops", "mfu", "peak_basis", "peak_memory_mib", "steps")


def run_bench(i: int) -> dict:
    """BASELINE config i (tools/port_bench_evals.py's) through run_benchmark
    on the card with BENCH_COUNTS, the launch counts set to 0 just before
    and read just after: backend cuda, the device span from CUDA events,
    finite and at most the step's host-clock p50, the MFU in (0, 1) where
    the card has a peak; K1 launches by shape, 12 or 24 a forward: one
    forward (all banks at once) at init and a step, one more on each step
    whose state was lost where the config gates it (the probe), no global
    scan (the moving clips never stay lost for redetect_global_after
    frames, so that IF node is never taken)."""
    path = _bench_evals.EVALS[i - 1][0]
    cfg = _bench_evals.config(i)
    reset_counts()
    r = run_benchmark(cfg, verbose=False, device="cuda", **BENCH_COUNTS)
    counts = read_counts()
    name = Path(path).stem
    dev_ms = r["p50_device_ms"]
    check(r["config"]["backend"] == "cuda", f"{name}: backend {r['config']['backend']}")
    check(r["p50_device_source"] == "cuda_events", f"{name}: device span from {r['p50_device_source']}")
    check(math.isfinite(dev_ms) and 0 < dev_ms <= r["p50_ms"],
          f"{name}: device span {dev_ms} ms finite and at most p50 {r['p50_ms']} ms")
    check(all(math.isfinite(r[k]) and r[k] > 0 for k in ("fps", "fps_serving", "p50_ms", "p99_ms", "rtt_ms")),
          f"{name}: rates and times finite")
    if r["peak_tflops"] is not None:
        check(0 < r["mfu"] < 1, f"{name}: MFU {r['mfu']} in (0, 1) against {r['peak_basis']}")
    spec = VitSpec.from_config(cfg.model)
    depth, shape = cfg.model.depth, (max(1, cfg.runtime.banks), cfg.model.heads, spec.seq_len)
    launches = counts["k1_shapes"].get(shape, 0)
    least = depth * (1 + r["steps"])
    most = depth * (1 + 2 * r["steps"]) if step_branches(cfg)[0] else least
    check(set(counts["k1_shapes"]) == {shape} and least <= launches <= most and launches % depth == 0,
          f"{name}: K1 launches by (B, H, T) {counts['k1_shapes']}: {depth} a forward at {shape}, "
          f"{least} to {most}")
    check(counts["k2_launches"] == 0, f"{name}: no K2 launch")
    junctions = junction_expected({shape: launches}, cfg)
    check(counts["junction_shapes"] == junctions,
          f"{name}: pre-norm junction launches by (M, D) {counts['junction_shapes']} == {junctions}")
    probes = launches // depth - 1 - r["steps"]
    line = {k: r[k] for k in BENCH_KEYS}
    print(f"  {name}: " + json.dumps({**line, "k1_shapes": {str(k): v for k, v in counts["k1_shapes"].items()},
                                      "probes": probes}), flush=True)
    return {**line, "config": r["config"], "k1_shapes": counts["k1_shapes"],
            "junction_shapes": counts["junction_shapes"], "probes": probes}


def run_eval3_track() -> dict:
    """eval3 through Tracker.run on EVAL3_FRAMES frames of its 1080p needle
    clip on the card (ViT-L/16 on the port's JAX-exact random init, 4096
    particles, cells): K1 24 a frame at [1, 16, 196, 64], positions finite,
    the RMSE within the JAX package's worst plus 2 px."""
    cfg = _bench_evals.config(3)
    src = open_source(cfg.io.source, EVAL3_FRAMES, tuple(cfg.io.frame_size), seed=cfg.filter.seed)
    tracker = Tracker(cfg, device="cuda")
    reset_counts()
    recs = list(tracker.run(src))
    counts = read_counts()
    want = {EVAL5_DENSE_SHAPE[:3]: cfg.model.depth * EVAL3_FRAMES}
    check(counts["k1_shapes"] == want, f"eval3: K1 launches by shape {counts['k1_shapes']} == {want}")
    pos = np.array([r["position"] for r in recs])
    check(len(recs) == EVAL3_FRAMES - 1 and bool(np.all(np.isfinite(pos))), "eval3: a finite record a step")
    rmse = float(np.sqrt(np.mean(np.linalg.norm(pos - src.truth[1:], axis=1) ** 2)))
    lost = sum(r["lost"] for r in recs)
    print(f"  eval3 tracked on {EVAL3_FRAMES} frames of 1080x1920 needle: RMSE {rmse:.3f} px (bound "
          f"{EVAL3_RMSE_BOUND_PX:.3f}: the JAX package on the CPU, filter seeds 0-3, {JAX_EVAL3_RMSE_PX}, + 2), "
          f"{lost} lost; K1 {counts['k1_shapes']}; step median "
          f"{statistics.median(r['step_ms'] for r in recs[5:]):.3f} ms", flush=True)
    check(rmse <= EVAL3_RMSE_BOUND_PX, f"eval3: RMSE {rmse} px within {EVAL3_RMSE_BOUND_PX} px")
    return {"rmse_px": rmse, "lost": lost, "k1_shapes": counts["k1_shapes"]}


def _to(tup, dev):
    return type(tup)(*(x.to(dev) for x in tup))


def check_train_parity() -> dict:
    """(a) One train step of TINY_TRAIN on the card against the CPU, the
    same injected SceneBatch and LossDraws (drawn on the CPU): the loss,
    every metric and every gradient leaf; the plain attention's forward as
    the trainer runs it, on the card against the CPU; and K1's refusal of an
    input that requires grad."""
    cfg = Config.from_dict(copy.deepcopy(TINY_TRAIN))
    tr = cfg.train
    gen = pf.make_generator(tr.seed ^ 0x7A11, 0, torch.device("cpu"))
    batch = make_pair_batch(gen, tr.batch_size, tr.canvas, tr.lookalike_frac, tr.blur_prob, tr.blur_sigma)
    draws = draw_loss(gen, tr.batch_size, tr.num_random_negatives, tr.cloud_particles)
    out = {}
    for dev in ("cpu", "cuda"):
        init_fn, step_fn = build_train_step(cfg, dev)
        params, _ = init_fn()
        loss, metrics, grads = step_fn.grads(params, 0, _to(batch, dev), _to(draws, dev))
        out[dev] = (float(loss), {k: float(v) for k, v in metrics.items()}, {k: g.cpu() for k, g in grads.items()},
                    params)
    (l_cpu, m_cpu, g_cpu, p_cpu), (l_gpu, m_gpu, g_gpu, p_gpu) = out["cpu"], out["cuda"]
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    metric_err = max(abs(m_gpu[k] - v) for k, v in m_cpu.items())
    metric_ok = all(abs(m_gpu[k] - v) <= TRAIN_METRIC_ATOL + TRAIN_LOSS_RTOL * abs(v) for k, v in m_cpu.items())
    grad_err = {k: float((g_gpu[k] - g).abs().max()) for k, g in g_cpu.items()}
    worst = max(grad_err, key=grad_err.get)
    print(f"  train step, tiny f32 config (B {tr.batch_size}, canvas {tr.canvas}, window {tr.window}), card vs CPU: "
          f"loss {l_gpu:.6f} / {l_cpu:.6f} (relative {loss_rel:.2e}, tol {TRAIN_LOSS_RTOL}); metrics {metric_err:.2e} "
          f"(tol {TRAIN_METRIC_ATOL} + rtol {TRAIN_LOSS_RTOL}); {len(grad_err)} gradient leaves, "
          f"largest error {grad_err[worst]:.2e} at {worst} (tol {TRAIN_GRAD_ATOL})", flush=True)
    check(set(m_gpu) == set(m_cpu) and set(g_gpu) == set(g_cpu), "train step: the same metrics and leaves")
    check(loss_rel <= TRAIN_LOSS_RTOL, f"train step loss: card {l_gpu} vs CPU {l_cpu}")
    check(metric_ok, f"train step metrics: card {m_gpu} vs CPU {m_cpu}")
    check(grad_err[worst] <= TRAIN_GRAD_ATOL, f"train step gradient {worst}: {grad_err[worst]}")
    # The plain attention through the trainer's ViT spec (no K1), f32.
    es = _train_embed_spec(cfg)
    x = torch.randn((2, tr.window, tr.window, 3), generator=torch.Generator().manual_seed(1))
    before = attention.flash_attention.launches
    fwd = {dev: vit_forward_tokens(p, x.to(dev), es.vit).detach().cpu() for dev, p in (("cpu", p_cpu),
                                                                                       ("cuda", p_gpu))}
    vit_err = float((fwd["cuda"] - fwd["cpu"]).abs().max())
    q, k, v = qkv(TRAIN_ATTENTION_SHAPE, torch.bfloat16, seed=14, layout="fused")
    att_err = float((attention.reference_attention(q, k, v).cpu().float()
                     - attention.reference_attention(q.cpu(), k.cpu(), v.cpu()).float()).abs().max())
    check(attention.flash_attention.launches == before, "the trainer's ViT launched K1")
    print(f"  the trainer's attention (plain, differentiable): tiny ViT forward f32 card vs CPU {vit_err:.2e} "
          f"(tol {TOL[torch.float32]}); {TRAIN_ATTENTION_SHAPE} bf16 card vs CPU {att_err:.2e} "
          f"(tol {TOL[torch.bfloat16]}); no K1 launch", flush=True)
    check(vit_err <= TOL[torch.float32] and att_err <= TOL[torch.bfloat16], "the trainer's attention, card vs CPU")
    refused = []
    for fn in (attention.flash_attention, attention.multi_head_attention):
        try:
            fn(q.detach().requires_grad_(), k, v)
        except RuntimeError as e:
            refused.append("no backward" in str(e))
    check(refused == [True, True], f"K1's entry points refuse an input that requires grad ({refused})")
    print("  flash_attention and multi_head_attention refuse a CUDA input that requires grad", flush=True)
    return {"loss_rel_err": loss_rel, "grad_max_abs_err": grad_err[worst], "vit_fwd_err": vit_err,
            "attention_bf16_err": att_err}


def time_train_steps(cfg: Config, label: str, steps: int) -> dict:
    """The train step at cfg's full width on the card in its own loop:
    TRAIN_WARMUP_STEPS, then `steps` each between CUDA events (the median
    its ms), the host's waits across them (none may land: no step logs),
    the peak memory over all (above what the process held before the
    run: the earlier phases' tensors stay out), and the frozen leaves
    against their initial values, bit for bit."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    init_fn, step_fn = build_train_step(cfg, "cuda")
    params, opt = init_fn()
    frozen = {k: v.detach().clone() for k, v in vit_params._flatten(params).items() if not v.requires_grad}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_WARMUP_STEPS):
        step_fn(params, opt, i)
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(steps)]

    def run():
        for j, (a, b) in enumerate(events):
            a.record()
            step_fn(params, opt, TRAIN_WARMUP_STEPS + j)
            b.record()

    stacks = []
    t0 = time.perf_counter()
    waits = count_waits(run, stacks)
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    ms = [a.elapsed_time(b) for a, b in events]
    med = statistics.median(ms)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    tr = cfg.train
    pairs = tr.batch_size / med * 1e3
    kept = all(torch.equal(v, vit_params._flatten(params)[k]) for k, v in frozen.items())
    trained = sum(v.numel() for v in opt.leaves.values())
    print(f"  {label}: {steps} steps after {TRAIN_WARMUP_STEPS} warm-up, B {tr.batch_size}, canvas {tr.canvas}, "
          f"window {_train_embed_spec(cfg).s_img}, {tr.dtype}: {med:.2f} ms a step on the card (CUDA events, "
          f"median; {'/'.join(f'{x:.2f}' for x in ms)}), {pairs:.1f} pairs/s; host issue {host_ms:.2f} ms a step, "
          f"wall {wall_ms:.2f} ms; peak memory {peak:.1f} MiB; {waits} host waits; {trained / 1e6:.2f} M trained "
          f"numbers, {len(frozen)} frozen leaves {'bit-equal to their start' if kept else 'CHANGED'}", flush=True)
    if waits:
        for stack in stacks:
            print(f"  a wait, at:\n{stack}", flush=True)
    check(waits == 0, f"{label}: {waits} host waits across steps that neither log nor probe")
    check(kept, f"{label}: the frozen leaves are unchanged")
    check(all(math.isfinite(x) for x in ms), f"{label}: step times")
    return {"step_ms": med, "step_ms_runs": ms, "pairs_per_s": pairs, "host_issue_ms": host_ms, "wall_ms": wall_ms,
            "peak_memory_mib": peak, "waits": waits}


def _train_cfg(base: dict, tmp: str, name: str) -> Config:
    d = copy.deepcopy(base)
    d["train"]["checkpoint_out"] = str(Path(tmp) / f"{name}.npz")
    d["train"]["metrics_out"] = str(Path(tmp) / f"{name}.jsonl")
    return Config.from_dict(d)


def _run_train_features(cfg: Config, label: str) -> tuple[dict, list, list, dict, float]:
    """train_features on the card (the entry point of the train command),
    the launch counts set to 0 just before and read just after, the host's
    waits counted by stack: none inside a step (every one is the probe's,
    the metrics' readback at the log step, set-up or the checkpoint's)."""
    lines, stacks = [], []
    result = {}
    reset_counts()
    t0 = time.perf_counter()
    count_waits(lambda: result.update(params=train_features(cfg, log=lines.append, device="cuda")), stacks)
    seconds = time.perf_counter() - t0
    counts = read_counts()
    in_step = [s for s in stacks if re.search(r'training/train\.py", line \d+, in step_fn', s)]
    if in_step:
        print(f"  a wait inside a train step, at:\n{in_step[0]}", flush=True)
    check(not in_step, f"{label}: {len(in_step)} host waits inside train steps")
    rows = [json.loads(line) for line in lines if line.startswith("{")]
    print(f"  {label}: train_features {seconds:.2f} s, {len(stacks)} host waits (none inside a step); log: "
          + " | ".join(lines), flush=True)
    return result["params"], rows, lines, counts, seconds


def _tree_stats(*dirs: str) -> dict:
    return {str(p): (p.stat().st_size, p.stat().st_mtime_ns) for d in dirs for p in sorted((ROOT / d).rglob("*"))
            if p.is_file()}


def run_train_head(tmp: str) -> dict:
    """(b) configs/train-head.yaml at full width: the step's time, pairs/s,
    memory and waits in its own loop; then train_features with the probe
    at step 0 and at the last step: no wait inside a step, K1 launched by
    the probe only, the trunk bit-equal to the seeded init, a head-only
    file; the last probe, after the weight change, against a fresh probe on
    the trained weights (hazard 2);
    the file served by the robust path on the teleport clip, its trunk
    regenerated bit-equal."""
    cfg = _train_cfg(TRAIN_HEAD_CONFIG, tmp, "head")
    tr = cfg.train
    timing = time_train_steps(cfg, "head training", TRAIN_TIMED_STEPS["head"])
    params, rows, lines, counts, seconds = _run_train_features(cfg, "head training")
    clips = [f"probe_{c}" for c in tr.eval_clips]
    check([r["step"] for r in rows] == [0, tr.steps], f"head training: probes at steps 0 and {tr.steps}")
    check(all(set(clips) <= set(r) and all(math.isfinite(r[c]) for c in clips) for r in rows),
          "head training: a finite RMSE for every probe clip")
    check(math.isfinite(rows[-1]["loss"]) and rows[-1]["grad_norm"] > 0, "head training: loss and gradient")
    depth = cfg.model.depth + cfg.model.head_depth
    k1 = counts["k1_shapes"]
    check(counts["k2_launches"] == 0 and set(k1) <= {DENSE_SHAPE[:3], REDETECT_SHAPE[:3]}
          and k1.get(DENSE_SHAPE[:3], 0) >= 2 * depth * len(clips) * tr.eval_frames
          and all(n % depth == 0 for n in k1.values()),
          f"head training: K1 launches by shape {k1}, the probes' ({depth} a forward), no K2")
    print(f"  head training: K1 launches by (B, H, T) during train_features (the two probes): {k1}", flush=True)
    # The trunk: the seeded init, bit for bit; the file: head only.
    spec = _train_embed_spec(cfg).vit
    seeded = vit_params.init_vit_params(vit_params.trunk_key(cfg.filter.seed), spec, "cuda")
    flat, want = vit_params._flatten(params), vit_params._flatten(seeded)
    trunk = [k for k in want if not k.startswith("head/")]
    check(all(torch.equal(flat[k].cpu(), want[k].cpu()) for k in trunk),
          f"head training: the {len(trunk)} trunk leaves bit-equal to the seeded init")
    check(any(not torch.equal(flat[k].cpu(), want[k].cpu()) for k in want if k.startswith("head/")),
          "head training: the head moved")
    with np.load(tr.checkpoint_out) as z:
        files = list(z.files)
        seed = int(z["__vpt_trunk_seed__"]) if "__vpt_trunk_seed__" in files else None
    check(seed == cfg.filter.seed and all(k.startswith(("head/", "__vpt")) for k in files),
          f"head training: a head-only file with __vpt_trunk_seed__ {seed}")
    print(f"  head training: the {len(trunk)} trunk leaves bit-equal to the seeded init; "
          f"{Path(tr.checkpoint_out).name}: {len([k for k in files if k.startswith('head/')])} head leaves, "
          f"__vpt_trunk_seed__ {seed}, {Path(tr.checkpoint_out).stat().st_size / 2**20:.1f} MiB", flush=True)
    # Hazard 2: train_features' probe captured its trackers' graphs on the
    # start weights (step 0); its last probe, after the weights changed, must
    # score what a probe built fresh on the trained weights scores (rebinding
    # would have replayed the step-0 weights: the step-0 numbers again).
    fresh = make_probe(cfg, clips=tuple(tr.eval_clips), frames=tr.eval_frames, num_particles=tr.eval_particles,
                       device="cuda")
    first = fresh(params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = fresh(params)
    probe_s = time.perf_counter() - t0
    print(f"  probe ({len(clips)} clips x {tr.eval_frames} frames, {tr.eval_particles} particles): {probe_s:.3f} s "
          f"with its graphs captured; a fresh probe on the trained weights {json.dumps(first)}; train_features' "
          f"probes (RMSE px, 2 decimals) at step 0 {json.dumps({k: rows[0][k] for k in clips})}, at step "
          f"{tr.steps} {json.dumps({k: rows[-1][k] for k in clips})}", flush=True)
    check(again == first, "the probe repeats itself on the same weights")
    logged = max(abs(round(first[k], 2) - rows[-1][k]) for k in clips)
    check(logged <= 0.01 + 1e-9, f"train_features' last probe == a fresh probe on its weights ({logged} px)")
    check(any(rows[0][k] != rows[-1][k] for k in clips), "train_features' last probe saw the trained weights")
    # The head file served by the robust path.
    rcfg = copy.deepcopy(ROBUST_CONFIG)
    rcfg["model"]["checkpoint"] = tr.checkpoint_out
    rcfg = Config.from_dict(rcfg)
    tracker = Tracker(rcfg, device="cuda")
    served = vit_params._flatten(tracker.vit_params)
    check(all(torch.equal(served[k], flat[k].to(served[k].device, served[k].dtype)) for k in flat),
          "the robust path's weights == the trained tree (the trunk regenerated from the file's seed), cast")
    src = open_source(rcfg.io.source, rcfg.io.num_frames, tuple(rcfg.io.frame_size), seed=rcfg.filter.seed)
    reset_counts()
    recs = list(tracker.run(src))
    rc = read_counts()
    pos = np.array([r["position"] for r in recs])
    check(len(recs) == rcfg.io.num_frames - 1 and bool(np.all(np.isfinite(pos))), "robust path on the new head: "
          "a finite record a step")
    check(rc["k1_shapes"].get(DENSE_SHAPE[:3], 0) >= depth * len(recs) and rc["k2_launches"] == 0,
          f"robust path on the new head: K1 {rc['k1_shapes']}")
    err = np.linalg.norm(pos - src.truth[1:], axis=1)[teleport_times(rcfg.io.num_frames)[1] + 3:]
    rmse = float(np.sqrt(np.mean(err**2)))
    lost = sum(r["lost"] for r in recs)
    print(f"  the new head file through the robust path (configs/robust-head.yaml, teleport, {len(recs)} steps): "
          f"trunk regenerated bit-equal, K1 {rc['k1_shapes']}, {lost} lost, RMSE after the reappearance {rmse:.3f} px "
          f"(the committed head: {ROBUST_RMSE_RANGE[0]}-{ROBUST_RMSE_RANGE[1]} in JAX)", flush=True)
    return {**timing, "train_features_s": seconds, "probe_s": probe_s, "probe_rmse_px": first,
            "probe_rmse_step0_px": {k: rows[0][k] for k in clips}, "k1_shapes": k1, "robust_k1_shapes": rc["k1_shapes"],
            "robust_rmse_px": rmse, "robust_lost": lost, "last_log": rows[-1]}


def run_train_features_path(tmp: str) -> dict:
    """(c) configs/train-features.yaml at full width, no probe: the step's
    time in its own loop, train_features for its steps, the bf16 file read
    through config.yaml's model.checkpoint, and 30 frames of moving-square
    tracked on it with K1."""
    cfg = _train_cfg(TRAIN_FEATURES_CONFIG, tmp, "features")
    tr = cfg.train
    timing = time_train_steps(cfg, "full-backbone training", TRAIN_TIMED_STEPS["features"])
    params, rows, lines, counts, seconds = _run_train_features(cfg, "full-backbone training")
    check([r["step"] for r in rows] == [tr.steps] and math.isfinite(rows[-1]["loss"]),
          "full-backbone training: one finite log line at the last step")
    check(counts["launches"] == 0 and counts["k2_launches"] == 0, "full-backbone training: no kernel launch (no probe)")
    loaded = vit_params.load_params(tr.checkpoint_out)
    leaves = vit_params._flatten(loaded)
    check(all(v.dtype == torch.bfloat16 for v in leaves.values()) and "__trunk_seed__" not in loaded,
          "full-backbone training: a full bf16 file")
    flat = vit_params._flatten(params)
    check(all(torch.equal(leaves[k], flat[k].to(torch.bfloat16).cpu()) for k in flat),
          "full-backbone training: the file holds the trained tree, cast")
    d = copy.deepcopy(SMOKE_CONFIG)
    d["model"]["checkpoint"] = tr.checkpoint_out
    d["io"]["num_frames"] = TRAIN_TRACK_FRAMES
    tcfg = Config.from_dict(d)
    src = open_source(tcfg.io.source, TRAIN_TRACK_FRAMES, tuple(tcfg.io.frame_size), seed=tcfg.filter.seed)
    tracker = Tracker(tcfg, device="cuda")
    reset_counts()
    recs = list(tracker.run(src))
    rc = read_counts()
    pos = np.array([r["position"] for r in recs])
    probes = sum(r["lost"] for r in recs[:-1]) if step_branches(tcfg)[0] else 0
    want = {DENSE_SHAPE[:3]: tcfg.model.depth * (1 + len(recs) + probes)}
    check(len(recs) == TRAIN_TRACK_FRAMES - 1 and bool(np.all(np.isfinite(pos))), "the trained backbone tracks: "
          "a finite record a step")
    check(rc["k1_shapes"] == want, f"the trained backbone tracks: K1 {rc['k1_shapes']} == {want}")
    rmse = float(np.sqrt(np.mean(np.linalg.norm(pos - src.truth[1:], axis=1) ** 2)))
    print(f"  the bf16 full-backbone file through config.yaml: {len(recs)} steps of moving-square, K1 "
          f"{rc['k1_shapes']}, RMSE {rmse:.3f} px, {sum(r['lost'] for r in recs)} lost", flush=True)
    return {**timing, "train_features_s": seconds, "k1_shapes": rc["k1_shapes"], "track_rmse_px": rmse,
            "last_log": rows[-1]}


def run_train_phase() -> dict:
    """(a), (b) and (c), the outputs under a temporary directory; nothing
    under checkpoints/ or docs/ changes."""
    before = _tree_stats("checkpoints", "docs")
    with tempfile.TemporaryDirectory(prefix="vpt-train-") as tmp:
        t0 = time.perf_counter()
        parity = check_train_parity()
        t1 = time.perf_counter()
        head = run_train_head(tmp)
        t2 = time.perf_counter()
        features = run_train_features_path(tmp)
        print(f"  train phase: (a) {t1 - t0:.2f} s, (b) {t2 - t1:.2f} s, (c) {time.perf_counter() - t2:.2f} s",
              flush=True)
    check(_tree_stats("checkpoints", "docs") == before, "nothing under checkpoints/ or docs/ changed")
    print("  nothing under checkpoints/ or docs/ changed", flush=True)
    return {"parity": parity, "head": head, "features": features}


def check_if_node() -> dict:
    """The IF-node helper (csrc/graph_if.cu, step_graph.capture_if) against
    its plain version, the host's branch (step_graph.run_if_host): a
    captured graph with one IF node on a predicate computed in the graph,
    whose body runs an f32 product and K1 at the re-detection scan's shape
    into buffers that hold the not-taken values before it, replayed with
    the predicate false, true, false, true; after each replay its outputs
    equal the plain version's on the same inputs (K1's bit for bit, the
    product within 1e-6)."""
    dev = torch.device("cuda")
    g = torch.Generator(device="cuda").manual_seed(5)
    a = torch.randn((64, 64), generator=g, device=dev)
    q, k, v = qkv(REDETECT_SHAPE, torch.bfloat16, seed=11, layout="fused")
    flag = torch.zeros((), dtype=torch.bool, device=dev)

    def step(run_if):
        prod = torch.zeros_like(a)
        att = torch.zeros(REDETECT_SHAPE, dtype=torch.bfloat16, device=dev)

        def body():
            prod.copy_(a @ a + 1.0)
            att.copy_(attention.flash_attention(q, k, v))

        run_if(flag & (a.abs().sum() >= 0), body)
        return prod, att

    saved = step_graph.read_counts()
    body_stream, body_pool, stream = torch.cuda.Stream(dev), torch.cuda.graph_pool_handle(), torch.cuda.Stream(dev)
    with torch.cuda.stream(body_stream):  # warm-up, on the bodies' stream
        step(step_graph.run_if_always)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = step(lambda p, b: step_graph.capture_if(p, b, body_stream, body_pool))
    taken = []
    for value in (False, True, False, True):
        flag.fill_(value)
        graph.replay()
        want = step(step_graph.run_if_host)
        torch.cuda.synchronize()
        check(torch.allclose(out[0], want[0], rtol=1e-6, atol=1e-6) and torch.equal(out[1], want[1]),
              f"IF node with predicate {value}: outputs == the host branch's")
        taken.append(bool(out[1].abs().sum() > 0))
    check(taken == [False, True, False, True], f"the IF node's body ran where the predicate held ({taken})")
    del graph, out
    torch._C._cuda_releasePool(torch.cuda.current_device(), body_pool)
    step_graph.restore_counts(saved)
    print("  IF node (csrc/graph_if.cu): a captured graph's body ran on replays 2 and 4 of 4, where its predicate "
          "held; its outputs == the host branch's after every replay", flush=True)
    return {"taken": taken}


# The step noise kernel's shapes (C, None for one step; K; N; reseed drawn):
# the benchmark cells' banks (b16-serve16-480p: 16 feeds x 1024 particles;
# l16-offline-1080p: one filter of 4096), a ROI chunk of 4 at 4096, and K 8
# with the re-detection reseed normals (eval4's banks). Checked bitwise at
# N 1000 too (a ragged last block).
NOISE_SHAPES = ((None, 16, 1024, False), (None, 1, 4096, False), (4, 1, 4096, False), (None, 8, 1024, True))
NOISE_EAGER_REPS = 20


def noise_buffers(c, k, n, reseed, fill=0.0):
    """A step graph's noise buffers ([C, K, ...] or [K, ...]) and reseed."""
    per = (k,) if c is None else (c, k)
    full = lambda shape: torch.full(shape, fill, device="cuda")  # noqa: E731
    noise = pf.StepNoise(full((*per, n, 2)), full((*per, n, 2)), full((*per, n)), full(per))
    return noise, (full((*per, n, 2)) if reseed else None)


def noise_keys(c, k):
    """[K, 2] keys (a negative seed among them, a frame index near 2**31)
    and, a bank and step in the buffers' order, the seeds and frame indices
    they stand for."""
    seeds = [-(2**33) + 7919 * i for i in range(k)]
    frames = [2**31 - 3 + i % 2 for i in range(k)]
    keys = torch.tensor(list(zip(seeds, frames)), dtype=torch.int64, device="cuda")
    steps = range(c or 1)
    return keys, [s for _ in steps for s in seeds], [f + j for j in steps for f in frames]


def noise_host_step(noise, reseed, seeds, idx, n) -> None:
    """One step's noise as the host drew it before the kernel: a generator
    and four draws a bank (and the reseed's), stacked, copied into the
    graph's buffers."""
    dev = torch.device("cuda")
    for dst, src in zip(noise, pf.draw_step_noise(seeds, idx, n, dev)):
        dst.copy_(src.reshape(dst.shape))
    if reseed is not None:
        reseed.copy_(pf.draw_reseed_noise(seeds, idx, n, dev).reshape(reseed.shape))


def check_step_noise() -> dict:
    """The step noise kernel (ops/step_noise.py) against its plain version,
    torch's generator draws (draw_step_noise, draw_reseed_noise), at
    NOISE_SHAPES and at N 1000, into NaN-filled buffers: every element
    bitwise equal (-> shapes checked)."""
    checked = []
    for c, k, n, reseed in NOISE_SHAPES + ((None, 16, 1000, True),):
        noise, rs = noise_buffers(c, k, n, reseed, float("nan"))
        keys, seeds, idx = noise_keys(c, k)
        sn.step_noise(keys, noise, rs)
        want, want_rs = noise_buffers(c, k, n, reseed)
        noise_host_step(want, want_rs, seeds, idx, n)
        bits = lambda x: x.view(torch.int32)  # noqa: E731
        same = all(torch.equal(bits(a), bits(b)) for a, b in zip(noise, want))
        check(same and (rs is None or torch.equal(bits(rs), bits(want_rs))),
              f"step noise kernel at C {c}, K {k}, N {n}, reseed {reseed}: bitwise torch's draws")
        checked.append((c, k, n, reseed))
    print(f"  step noise kernel (csrc/step_noise.cu) == torch's generator draws, bitwise, at (C, K, N, reseed) "
          f"{checked}; {torch.cuda.get_device_properties(0).max_threads_per_multi_processor} threads a SM, "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs", flush=True)
    return {"shapes": checked}


def time_step_noise(c, k, n, reseed) -> dict:
    """The step noise kernel at (C or None, K, N, reseed): device ms of one
    launch (time_graph), its bound (the bytes it writes at PEAK_BYTES_PER_S;
    it reads 16 bytes a bank), an eager loop's ms a launch; and the host
    draws it took off the graph path (noise_host_step): their host ms a step
    between synchronizes, and torch.profiler's device ms and operation count
    a step. -> {(C or 1, K, N, reseed): row}."""
    from torch.profiler import ProfilerActivity, profile

    from vitparticlefiltertracker_tpu_torch.utils.profiling import device_kernels

    noise, rs = noise_buffers(c, k, n, reseed)
    keys, seeds, idx = noise_keys(c, k)
    ms = time_graph(lambda: sn.step_noise(keys, noise, rs))
    eager_ms = time_eager(lambda: sn.step_noise(keys, noise, rs))[0]
    bound = 4 * (c or 1) * k * (5 * n + 1 + (2 * n if reseed else 0)) / PEAK_BYTES_PER_S * 1e3
    for _ in range(3):
        noise_host_step(noise, rs, seeds, idx, n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(NOISE_EAGER_REPS):
        noise_host_step(noise, rs, seeds, idx, n)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / NOISE_EAGER_REPS
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(NOISE_EAGER_REPS):
            noise_host_step(noise, rs, seeds, idx, n)
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    plain_ms = sum(v.ms for v in kernels.values()) / NOISE_EAGER_REPS
    ops = sum(v.calls for v in kernels.values()) / NOISE_EAGER_REPS
    print(f"  step noise at C {c}, K {k}, N {n}, reseed {reseed}: kernel {ms:.4f} ms on the card (bound "
          f"{bound:.5f} ms, bytes), eager loop {eager_ms:.4f} ms; the host draws {host_ms:.3f} ms of host, "
          f"{plain_ms:.4f} ms of device in {ops:.0f} operations a step", flush=True)
    return {(c or 1, k, n, reseed): {"ms": ms, "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound,
                                     "bound_by": "bytes", "eager_ms": eager_ms, "plain_host_ms": host_ms,
                                     "plain_device_ops": ops}}


def time_kernels(shapes=TIME_SHAPES, dtype=torch.bfloat16) -> dict:
    """K1, its plain version and sdpa on the fused-qkv views the main path
    passes, in `dtype`. Each is timed on the card (CUDA graph replay, the numbers
    kept) and as an eager loop of launches (which the host's launch rate can
    bound at small shapes); interleaved plain, kernel, library, kernel,
    plain in each."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for shape in shapes:
        q, k, v = qkv(shape, dtype, seed=7, layout="fused")
        fns = {"plain": lambda: attention.reference_attention(q, k, v),
               "k1": lambda: attention.flash_attention(q, k, v), "sdpa": lambda: sdpa(q, k, v)}
        order = ("plain", "k1", "sdpa", "k1", "plain")
        dev = {name: [] for name in fns}
        eager = {name: [] for name in fns}
        for name in order:
            dev[name].append(time_graph(fns[name]))
        for name in order:
            eager[name].append(time_eager(fns[name])[0])
        bound, by, basis = attention_bound_ms(shape, dtype)
        rows[shape] = {"ms": min(dev["k1"]), "plain_ms": min(dev["plain"]), "library_ms": dev["sdpa"][0],
                       "bound_ms": bound, "bound_by": by, "peak_basis": basis, "eager_ms": min(eager["k1"]),
                       "eager_plain_ms": min(eager["plain"]), "eager_library_ms": eager["sdpa"][0]}
        fmt = lambda xs: "/".join(f"{x:.4f}" for x in xs)  # noqa: E731
        print(f"  {str(shape):18s} {str(dtype).removeprefix('torch.')} fused views, device (graph): K1 {fmt(dev['k1'])} ms, plain "
              f"{fmt(dev['plain'])} ms, sdpa {fmt(dev['sdpa'])} ms; eager loop: K1 {fmt(eager['k1'])}, plain "
              f"{fmt(eager['plain'])}, sdpa {fmt(eager['sdpa'])} ms; bound {bound:.5f} ms ({by}; {basis})", flush=True)
    return rows


def window_taps_read(window, centers, sizes, crop) -> int:
    """Window pixels the function reads for these boxes: the union over
    boxes of the rows and columns of their bilinear taps (floor and floor + 1
    of each clamped sample coordinate, as ops/image.py bilinear_sample)."""
    swin = window.shape[0]
    ys, xs = crop_sample_coords(centers, sizes, crop)
    ys, xs = ys[:, :, 0].clamp(0, swin - 1).floor().long(), xs[:, 0, :].clamp(0, swin - 1).floor().long()
    rows = torch.cat([ys, (ys + 1).clamp(max=swin - 1)], 1)
    cols = torch.cat([xs, (xs + 1).clamp(max=swin - 1)], 1)
    read = torch.zeros((swin, swin), dtype=torch.bool, device=window.device)
    read[rows[:, :, None], cols[:, None, :]] = True
    return int(read.sum())


def window_patchify_bound_ms(window, centers, sizes, crop, patch, kernel) -> tuple[float, str]:
    """Least time for one K2 call on these inputs: the window pixels its
    boxes' taps read (window_taps_read), the boxes, weight and bias read once
    and the tokens written once, against the embed product's
    2·N·g²·(p²·C)·D FLOP at the weight dtype's peak (the sampling's few
    FLOP per value are left out). K windows [K, Swin, Swin, C] with boxes
    [K, N, 2]: each window's taps, all K·N boxes."""
    c, (k, d) = window.shape[-1], kernel.shape
    wins = window.reshape(-1, *window.shape[-3:])
    cs, ss = centers.reshape(wins.shape[0], -1, 2), sizes.reshape(wins.shape[0], -1, 2)
    n = cs.shape[0] * cs.shape[1]
    elem, g2 = kernel.element_size(), (crop // patch) ** 2
    taps = sum(window_taps_read(w, c_, s_, crop) for w, c_, s_ in zip(wins, cs, ss))
    nbytes = taps * c * window.element_size() + 2 * n * 2 * 4 + (k * d + d) * elem + n * g2 * d * elem
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    op_ms = 2 * n * g2 * k * d / PEAK_FLOPS[kernel.dtype] * 1e3
    return max(byte_ms, op_ms), ("bytes" if byte_ms >= op_ms else "operations")


def time_window_patchify(m: dict = K2_MAIN) -> dict:
    """K2 at one of the crop path's shapes, bf16, through
    tools/port_k2_times.py: device time of one call inside a CUDA graph (the
    `ms`), its plain version the same way, cuBLAS's product alone on sampled
    tokens (`product_ms`, a yardstick the port never calls), the eager loop
    and the host's issue time of one call. No single PyTorch call computes
    this function, so there is no library time."""
    t = _k2_times.time_k2(pw, m)
    w, c, s_, k, _ = _k2_times.timing_inputs(m)
    bound, by = window_patchify_bound_ms(w, c, s_, m["crop"], m["patch"], k)
    print(f"  K2 N {m['n']} Swin {m['swin']} crop {m['crop']} D {m['d']} bf16, device (graph): K2 "
          f"{'/'.join(f'{x:.4f}' for x in t['kernel_device_runs_ms'])} ms, plain {t['plain_device_ms']:.4f} ms, "
          f"product alone {t['product_device_ms']:.4f} ms; eager loop {t['kernel_eager_ms']:.4f} ms, host "
          f"{t['kernel_host_us']:.1f} us a call; bound {bound:.5f} ms ({by})", flush=True)
    return {"ms": t["kernel_device_ms"], "plain_ms": t["plain_device_ms"], "library_ms": None, "bound_ms": bound,
            "bound_by": by, "eager_ms": t["kernel_eager_ms"], "host_us": t["kernel_host_us"],
            "product_ms": t["product_device_ms"]}


def time_window_patchify_windows(windows: int = 8, n: int = 1024) -> dict:
    """K2 over `windows` windows of n boxes in one launch (crop-mode banks),
    bf16: device time of one call inside a CUDA graph, the plain version's
    the same way, interleaved (plain, K2, K2, plain), and the bound."""
    window, centers, sizes, kernel, bias = k2_window_inputs(windows, n, torch.bfloat16, seed=windows + n)
    fns = {"k2": lambda: pw.gather_patchify_window(window, centers, sizes, 32, 16, kernel, bias),
           "plain": lambda: pw.window_gather_patchify_plain(window, centers, sizes, 32, 16, kernel, bias)}
    dev = {name: [] for name in fns}
    for name in ("plain", "k2", "k2", "plain"):
        dev[name].append(time_graph(fns[name]))
    bound, by = window_patchify_bound_ms(window, centers, sizes, 32, 16, kernel)
    print(f"  K2 over {windows} windows x {n} boxes, Swin 256, crop 32, D 768 bf16, device (graph): K2 "
          f"{'/'.join(f'{x:.4f}' for x in dev['k2'])} ms, plain {'/'.join(f'{x:.4f}' for x in dev['plain'])} ms; "
          f"bound {bound:.5f} ms ({by})", flush=True)
    return {"ms": min(dev["k2"]), "plain_ms": min(dev["plain"]), "library_ms": None, "bound_ms": bound,
            "bound_by": by}


# -- the mesh phase: the port's multi-GPU path at world size 1 ------------------------

MESH_TRAIN_STEPS = 3  # (e)'s steps, at step indices 0..2 (the rate ramps from 0 at index 0)


def replay_tally(tracker) -> dict:
    """What one replay of the tracker's (first) step graph adds to the
    counts outside its branches, as StepGraphs.counts holds them: K1
    launches, the all-gathers and the peer all-reduce kernel's launches the
    capture recorded (and each branch body's peer launches)."""
    sg = next(iter(tracker._step_graphs.values()))
    at = {f: i for i, (f, _) in enumerate(step_graph._COUNTED)}
    return {"k1": sg.counts[at[attention.flash_attention]][0], "all_gathers": sg.counts[at[pmesh.all_gather]][0],
            "peer_launches": sg.counts[at[par.peer_all_reduce]][0],
            "branch_peer_launches": [b[at[par.peer_all_reduce]][0] for b in sg.branch_counts]}


def profile_replay(tracker, frame) -> dict:
    """torch.profiler over one step_packed (one replay) of the tracker: its
    device events by kind. At world size 1 NCCL moves no data between
    ranks: an all-gather into another buffer is a device copy and an
    in-place all-reduce enqueues nothing, so the collectives are held by
    the tally (replay_tally); the profile says what reached the card."""
    from torch.profiler import ProfilerActivity, profile

    from vitparticlefiltertracker_tpu_torch.utils.profiling import device_kernels

    tracker.step_packed(frame)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tracker.step_packed(frame)
        torch.cuda.synchronize()
    rows = device_kernels(prof)
    nccl = sum(v.calls for k, v in rows.items() if "nccl" in k.lower())
    copies = sum(v.calls for k, v in rows.items() if "memcpy" in k.lower())
    return {"device_events": sum(v.calls for v in rows.values()), "nccl_kernels": nccl, "copies": copies,
            "device_ms": sum(v.ms for v in rows.values())}


def compare_records(got: list[dict], want: list[dict], label: str) -> dict:
    """A mesh run's records against its mesh=None twin's: bitwise, or within
    GRAPH_POS_TOL_PX with `lost` and `resampled` equal (and the reason
    printed)."""
    check(len(got) == len(want), f"{label}: record counts {len(got)} == {len(want)}")
    worst, bitwise = 0.0, True
    for i, (a, b) in enumerate(zip(got, want)):
        check(a["lost"] == b["lost"] and a["resampled"] == b["resampled"], f"{label} step {i + 1}: flags")
        worst = max(worst, float(np.abs(np.subtract(a["position"], b["position"])).max()))
        bitwise &= all(a[k] == b[k] for k in a if k not in ("step_ms", "frame"))
    check(worst <= GRAPH_POS_TOL_PX, f"{label}: mesh positions within {GRAPH_POS_TOL_PX} px of mesh=None ({worst})")
    if not bitwise:
        print(f"  {label}: not bitwise (max position diff {worst:.2e} px): a GEMM captured in another graph may "
              "take another cuBLAS algorithm (its workspace is per stream), as between graph and eager", flush=True)
    return {"bitwise": bitwise, "max_pos_diff_px": worst}


def mesh_twin_runs(label: str, make, src, turns=("plain", "mesh", "mesh", "plain"), n_after: int = 0) -> list[dict]:
    """Tracker.run over `src` for each turn, make(mesh?) building the
    tracker; the counts set to 0 just before each run and read just after."""
    runs = []
    for kind in turns:
        tracker = make(kind == "mesh")
        reset_counts()
        recs, steps = [], []
        for rec in tracker.run(src):
            recs.append(rec)
            if n_after > 0:
                steps.append(scan_accepted(tracker.state, n_after))
        runs.append({"kind": kind, "recs": recs, "steps": steps, "tracker": tracker, **read_counts()})
    return runs


def check_mesh_twins(label: str, runs: list[dict], depth: int, gathers_a_step: int = 1) -> dict:
    """The mesh runs against the plain ones: records, K1 launches by shape
    equal; the collectives the design implies (a gather a scoring pass, 2
    all-reduces a block of every forward: twice K1's launches); the step
    medians of both in turns."""
    plain = [r for r in runs if r["kind"] == "plain"]
    mesh = [r for r in runs if r["kind"] == "mesh"]
    out = compare_records(mesh[0]["recs"], plain[0]["recs"], label)
    for m in mesh:
        steps = len(m["recs"])
        check(m["k1_shapes"] == plain[0]["k1_shapes"] and m["k2_sizes"] == plain[0]["k2_sizes"],
              f"{label}: launches by shape on the mesh {m['k1_shapes']} == without {plain[0]['k1_shapes']}")
        check(m["all_gathers"] == gathers_a_step * steps,
              f"{label}: {m['all_gathers']} all-gathers == {gathers_a_step} a step x {steps}")
        check(m["peer_launches"] == 2 * m["launches"] > 0,
              f"{label}: {m['peer_launches']} peer all-reduce launches == 2 a block of every forward "
              f"(K1 {m['launches']})")
    for p in plain:
        check(p["all_gathers"] == p["peer_launches"] == 0, f"{label}: no collective without a mesh")
    med = [statistics.median(r["recs"][i]["step_ms"] for i in range(5, len(r["recs"]))) for r in runs]
    p_med = statistics.median(m for m, r in zip(med, runs) if r["kind"] == "plain")
    m_med = statistics.median(m for m, r in zip(med, runs) if r["kind"] == "mesh")
    tally = replay_tally(mesh[0]["tracker"])
    print(f"  {label}: records on make_mesh(1, 1, 1) == mesh=None ({'bitwise' if out['bitwise'] else 'within tol'}); "
          f"collectives {mesh[0]['all_gathers']} all-gathers, {mesh[0]['peer_launches']} peer all-reduces; one "
          f"replay: "
          f"{tally}; step ms, median after 5, turns {'/'.join(r['kind'] for r in runs)}: "
          f"{'/'.join(f'{m:.3f}' for m in med)}; mesh {m_med:.3f}, mesh=None {p_med:.3f}", flush=True)
    return {**out, "step_ms_median": m_med, "plain_step_ms_median": p_med, "turn_medians_ms": med,
            "all_gathers": mesh[0]["all_gathers"], "peer_launches": mesh[0]["peer_launches"], "replay": tally,
            "k1_shapes": mesh[0]["k1_shapes"], "launches": mesh[0]["launches"], "peer_shapes": mesh[0]["peer_shapes"]}


def run_mesh_dense(main_path: dict, mesh) -> dict:
    """(a) config.yaml's dense path (ViT-B/16, 1024 particles) on 60 frames:
    mesh and mesh=None in turns; host waits on the mesh tracker; a replay
    profiled."""
    cfg, prm, src = main_path["cfg"], main_path["prm"], main_path["src"]
    runs = mesh_twin_runs("mesh (a) dense", lambda m: Tracker(cfg, vit_params=prm, device="cuda",
                                                               mesh=mesh if m else None), src)
    out = check_mesh_twins("mesh (a) dense", runs, cfg.model.depth)
    check(out["replay"]["all_gathers"] == 1 and out["replay"]["peer_launches"] == 2 * cfg.model.depth,
          f"mesh (a): one replay holds 1 all-gather and {2 * cfg.model.depth} peer all-reduces "
          f"({out['replay']})")
    tracker = runs[1]["tracker"]
    out.update(check_waits(tracker, list(src)[1:], 0, "mesh (a) dense"))
    out["profile"] = profile_replay(tracker, torch.from_numpy(src.frames[1]).cuda())
    print(f"  mesh (a): one replay profiled: {out['profile']}", flush=True)
    return out


def run_mesh_eval3(mesh) -> dict:
    """(b) eval3 at full width (ViT-L/16, 4096 particles, cells, 1080p
    needle): Tracker(cfg, mesh=make_mesh(1, 1, 1)) and mesh=None on
    EVAL3_FRAMES frames in turns, the RMSE held as run_eval3_track holds it."""
    cfg = _bench_evals.config(3)
    src = open_source(cfg.io.source, EVAL3_FRAMES, tuple(cfg.io.frame_size), seed=cfg.filter.seed)
    prm = vit_params.resolve_vit_params(cfg, None, "cuda")
    runs = mesh_twin_runs("mesh (b) eval3", lambda m: Tracker(cfg, vit_params=prm, device="cuda",
                                                               mesh=mesh if m else None), src)
    out = check_mesh_twins("mesh (b) eval3", runs, cfg.model.depth)
    check(out["replay"]["all_gathers"] == 1 and out["replay"]["peer_launches"] == 2 * cfg.model.depth,
          f"mesh (b): one replay holds 1 all-gather and {2 * cfg.model.depth} peer all-reduces "
          f"({out['replay']})")
    for r in runs:
        pos = np.array([x["position"] for x in r["recs"]])
        r["rmse"] = float(np.sqrt(np.mean(np.linalg.norm(pos - src.truth[1:], axis=1) ** 2)))
        check(r["rmse"] <= EVAL3_RMSE_BOUND_PX, f"mesh (b) {r['kind']}: RMSE {r['rmse']} px within "
              f"{EVAL3_RMSE_BOUND_PX} px")
    out["rmse_px"] = runs[1]["rmse"]
    out["profile"] = profile_replay(runs[1]["tracker"], torch.from_numpy(src.frames[1]).cuda())
    print(f"  mesh (b): RMSE {out['rmse_px']:.3f} px (bound {EVAL3_RMSE_BOUND_PX:.3f}); one replay profiled: "
          f"{out['profile']}", flush=True)
    return out


def run_mesh_robust(robust_path: dict, mesh) -> dict:
    """(c) the robust path (configs/robust-head.yaml, teleport gates, 48
    frames): its probe and scan bodies, IF nodes of the graph, hold the
    forward's peer all-reduces; the mesh run equals mesh=None and takes the
    branches on the same steps."""
    cfg, prm, src = robust_path["cfg"], robust_path["prm"], robust_path["src"]
    n_after = cfg.tracker.redetect_global_after
    runs = mesh_twin_runs("mesh (c) robust", lambda m: Tracker(cfg, vit_params=prm, device="cuda",
                                                                mesh=mesh if m else None),
                          src, turns=("plain", "mesh"), n_after=n_after)
    out = check_mesh_twins("mesh (c) robust", runs, cfg.model.depth + cfg.model.head_depth)
    check(runs[1]["steps"] == runs[0]["steps"] and any(s[0] for s in runs[1]["steps"]),
          "mesh (c): the scans and accepted matches on the same steps as mesh=None, at least one scan")
    branches = out["replay"]["branch_peer_launches"]
    check(len(branches) == 2 and all(b > 0 for b in branches),
          f"mesh (c): both IF-node bodies (probe, scan) hold peer all-reduces ({branches})")
    out.update(check_waits(runs[1]["tracker"], list(src)[1:], 0, "mesh (c) robust"))
    return out


def run_mesh_banked(banked_path: dict, mesh) -> dict:
    """(d) eval4 banked (8 banks x 1024 particles, 720p) through
    MultiTracker on make_mesh(1, 1, 1): each step's rows also all-gathered
    over "bank" after the replay."""
    cfg, prm, src = banked_path["cfg"], banked_path["prm"], banked_path["src"]
    runs = []
    for kind in ("plain", "mesh"):
        tracker = banked.MultiTracker(cfg, vit_params=prm, device="cuda", mesh=mesh if kind == "mesh" else None)
        reset_counts()
        tracker.init(src.frames[0], src.init_bbox)
        steps = [tracker.step(f) for f in src.frames[1:]]
        runs.append({"kind": kind, "recs": [merge_banks(r) for r in steps], "tracker": tracker, **read_counts()})
    out = check_mesh_twins("mesh (d) banked", runs, cfg.model.depth, gathers_a_step=2)
    out.update(check_waits(runs[1]["tracker"], list(src)[1:], 0, "mesh (d) banked"))
    return out


def run_mesh_train() -> dict:
    """(e) configs/train-head.yaml at full width through build_train_step
    with mesh=make_data_mesh(1) and without, MESH_TRAIN_STEPS steps each
    from the same init: loss and weights bitwise equal at each step index;
    one all-reduce a step."""
    with tempfile.TemporaryDirectory() as tmp:
        cfg = _train_cfg(TRAIN_HEAD_CONFIG, tmp, "mesh")
    out = {}
    for kind in ("plain", "mesh"):
        init_fn, step_fn = build_train_step(cfg, "cuda", mesh=make_data_mesh(1) if kind == "mesh" else None)
        params, opt = init_fn()
        reset_counts()
        losses = [float(step_fn(params, opt, i)[2]["loss"]) for i in range(MESH_TRAIN_STEPS)]
        out[kind] = (losses, {k: v.detach().clone() for k, v in vit_params._flatten(params).items()}, read_counts())
        del params, opt
    (lp, wp, _), (lm, wm, cm) = out["plain"], out["mesh"]
    same = lm == lp and all(torch.equal(wm[k], wp[k]) for k in wp)
    check(same, f"mesh (e): losses {lm} == {lp} and every weight bitwise equal")
    check(cm["all_reduces"] == MESH_TRAIN_STEPS, f"mesh (e): one all-reduce a step ({cm['all_reduces']})")
    print(f"  mesh (e) train-head on make_data_mesh(1): {MESH_TRAIN_STEPS} steps, losses {[round(x, 5) for x in lm]} "
          f"== mesh=None, weights bitwise equal; {cm['all_reduces']} all-reduces", flush=True)
    return {"losses": lm, "bitwise": same, "all_reduces": cm["all_reduces"]}


def run_mesh_stream(main_path: dict, mesh) -> dict:
    """(f) stream_track over the dense path's clip with a graph Tracker on
    make_mesh(1, 1, 1): rank 0's MeshFeed copies each staged frame into its
    device buffer and broadcasts it (to itself), then steps; the records
    bitwise equal to the dense path's Tracker.run graph records (which
    run_stream holds the mesh=None stream to); K1 and peer launches."""
    cfg, src = main_path["cfg"], main_path["src"]
    tracker = Tracker(cfg, vit_params=main_path["prm"], device="cuda", mesh=mesh)
    recs = []
    reset_counts()
    stats = stream_track(tracker, src.frames, src.init_bbox, on_record=recs.append, readback_window=4)
    counts = read_counts()
    want = [{k: r[k] for k in STREAM_KEYS} for r in main_path["recs"]]
    check(len(recs) == len(want) and all({k: r[k] for k in STREAM_KEYS} == w for r, w in zip(recs, want)),
          f"mesh (f) stream: records == mesh=None Tracker.run's graph records, bitwise ({len(recs)})")
    check(counts["k1_shapes"] == main_path["k1_shapes"] and counts["peer_launches"] == 2 * counts["launches"],
          f"mesh (f) stream: K1 {counts['k1_shapes']} as without the mesh, peer launches {counts['peer_launches']}")
    print(f"  mesh (f) stream on make_mesh(1, 1, 1): {len(recs)} records == the mesh=None graph records (bitwise); "
          f"{stats['fps']:.1f} frames/s from the first read (wall {stats['wall_s']:.3f} s: init {stats['init_s']} s, "
          f"submit {stats['submit_s']} s, drain {stats['drain_s']} s); K1 {counts['launches']}, peer all-reduces "
          f"{counts['peer_launches']}", flush=True)
    return {"bitwise": True, "frames_per_s": stats["fps"], "peer_launches": counts["peer_launches"]}


def run_mesh_serve(main_path: dict, streams_path: dict, mesh) -> dict:
    """(g) serve's pipeline on make_mesh(1, 1, 1): stream_track over a
    MultiStreamTracker of STREAMS clips (seeds 0-3, as the multistream path
    and the serve command) in lockstep; each stream's positions bitwise
    equal to the multistream path's mesh=None graph rows."""
    cfg = main_path["cfg"]
    size = tuple(cfg.io.frame_size)
    srcs = [open_source(cfg.io.source, FRAMES, size, seed=cfg.filter.seed + i) for i in range(STREAMS)]
    clips = np.stack([np.stack(x.frames) for x in srcs], axis=1)
    ms = banked.MultiStreamTracker(cfg, STREAMS, vit_params=main_path["prm"], device="cuda", mesh=mesh)
    recs = []
    reset_counts()
    stats = stream_track(ms, iter(clips), np.stack([x.init_bbox for x in srcs]), on_record=recs.append)
    counts = read_counts()
    pos = np.array([r["position"] for r in recs], np.float32)
    want = streams_path["rows"][:, :2 * STREAMS].reshape(-1, STREAMS, 2)
    check(pos.shape == want.shape and np.array_equal(pos, want),
          f"mesh (g) serve: every stream's positions == the multistream path's mesh=None graph rows, bitwise")
    check(counts["peer_launches"] == 2 * counts["launches"] > 0, f"mesh (g) serve: peer launches {counts}")
    print(f"  mesh (g) serve's pipeline on make_mesh(1, 1, 1): {STREAMS} streams x {len(recs)} frames == the "
          f"mesh=None multistream rows (bitwise); wall {stats['wall_s']:.3f} s (init {stats['init_s']} s, submit "
          f"{stats['submit_s']} s, drain {stats['drain_s']} s); K1 {counts['k1_shapes']}, peer all-reduces "
          f"{counts['peer_launches']}", flush=True)
    return {"bitwise": True, "peer_launches": counts["peer_launches"]}


def run_mesh_phase(main_path: dict, robust_path: dict, banked_path: dict, streams_path: dict) -> dict:
    """The mesh phase: a one-rank NCCL group over a file store in a
    temporary directory, make_mesh(1, 1, 1), paths (a)-(g) each against its
    mesh=None twin; the peer kernel at one rank timed; the group destroyed
    at the end."""
    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as tmp:
        pmesh.init_distributed("cuda", store=f"{tmp}/store")
        try:
            mesh = pmesh.make_mesh(1, 1, 1)
            print(f"  {mesh}; NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}", flush=True)
            out = {"dense": run_mesh_dense(main_path, mesh), "eval3": run_mesh_eval3(mesh),
                   "robust": run_mesh_robust(robust_path, mesh), "banked": run_mesh_banked(banked_path, mesh),
                   "train": run_mesh_train(), "stream": run_mesh_stream(main_path, mesh),
                   "serve": run_mesh_serve(main_path, streams_path, mesh)}
            out["peer_times"] = {shape: time_peer_one_rank(mesh.peers, shape) for shape in PEER_SHAPES}
        finally:
            dist.destroy_process_group()
    return out


# -- the peer phase: the peer all-reduce kernel across two processes on one card ------

# The kernel's shapes: a B/16 forward's row-parallel output at B 1, the
# L/16 forward's (eval3's), and the re-detection scan's at B 49.
PEER_SHAPES = [(1, 196, 768), (1, 196, 1024), (49, 196, 768)]
PEER_TOL = 0.0  # kernel against its plain version: the same f32 adds in the same order, one rounding
PEER_TIMEOUT_S = 420  # the phase's two processes, at most


def peer_bound_ms(shape, m: int, dtype_in, dtype_out) -> tuple[float, str]:
    """Least time for one call: the m partials read once, the bias read,
    the output written once, over the card's memory rate (one card: a
    peer's partial crosses its memory, not NVLink); no arithmetic to speak
    of (m adds an element)."""
    n = math.prod(shape)
    nbytes = m * n * torch.finfo(dtype_in).bits // 8 + (n + shape[-1]) * torch.finfo(dtype_out).bits // 8
    return nbytes / PEAK_BYTES_PER_S * 1e3, "bytes"


def peer_inputs(shape, m: int, seed: int):
    """m f32 partials of `shape` and a bf16 bias, from numpy's generator."""
    rng = np.random.default_rng(seed)
    parts = torch.from_numpy(rng.normal(size=(m, *shape)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=shape[-1:]).astype(np.float32)).bfloat16()
    return parts, bias


def time_peer_one_rank(group, shape) -> dict:
    """The peer kernel on a one-rank group (what the world-1 mesh phase
    runs: the bf16 product in, the bias, one rounding), its plain version
    and the library call that computes the same function (torch.add of
    the bf16 product and the bf16 bias: an f32 add rounded once), each as
    a CUDA graph of calls; its error against the plain version."""
    parts, bias = peer_inputs(shape, 1, seed=3)
    x, b = parts[0].bfloat16().cuda(), bias.cuda()
    out = par.peer_all_reduce(x, b, group)
    want = par.peer_all_reduce_plain(x[None], b)
    err = float((out.float() - want.float()).abs().max())
    check(err <= PEER_TOL, f"peer kernel, one rank, {shape}: max_abs_err {err} <= {PEER_TOL}")
    lib_err = float((torch.add(x, b).float() - out.float()).abs().max())
    saved = step_graph.read_counts()
    ms = time_graph(lambda: par.peer_all_reduce(x, b, group))
    plain_ms = time_graph(lambda: par.peer_all_reduce_plain(x[None], b))
    library_ms = time_graph(lambda: torch.add(x, b))
    step_graph.restore_counts(saved)
    bound, by = peer_bound_ms(shape, 1, torch.bfloat16, torch.bfloat16)
    print(f"  peer kernel, one rank, {shape} bf16: {ms:.4f} ms (plain {plain_ms:.4f} ms, torch.add {library_ms:.4f} "
          f"ms, bound {bound:.5f} ms); max_abs_err {err}, torch.add off the kernel by {lib_err}", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound, "bound_by": by,
            "max_abs_err": err}


def _peer_rank(rank: int, store: str, results) -> None:
    """A process of the peer phase (spawned): its result or its traceback."""
    try:
        results.put((rank, True, _peer_rank_run(rank, store)))
    except Exception:  # noqa: BLE001 - handed to the parent, which fails the phase
        results.put((rank, False, traceback.format_exc()))


def _peer_rank_run(rank: int, store: str) -> dict:
    import torch.distributed as dist
    from datetime import timedelta

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=2,
                            timeout=timedelta(seconds=PEER_TIMEOUT_S))
    try:
        mesh = pmesh.make_mesh(1, 1, 2, device="cuda")
        return {"kernel": peer_kernel_checks(mesh), "tp_forward": peer_tp_forward(mesh),
                "robust": peer_robust_run(mesh)}
    finally:
        dist.destroy_process_group()


def peer_kernel_checks(mesh) -> dict:
    """On both ranks: the kernel over f32 partials (rank r's is partial r of
    peer_inputs) at each of PEER_SHAPES into bf16 with the bias, in the form
    par.peer_form picks there, and at the scan's shape in both forms (the
    first shape and the scan's also into f32 with an f32 bias), against the
    plain version on the same inputs on the card; both ranks' outputs
    equal; each form timed as a CUDA graph of calls replayed by both
    processes together (the two contexts take turns on the card, so the
    time is the turns', not NVLink's). Keys: (shape, output dtype, form)."""
    import torch.distributed as dist

    group, rank = mesh.peers, mesh.coords["model"]
    out = {}
    for i, shape in enumerate(PEER_SHAPES):
        parts, bias = peer_inputs(shape, 2, seed=10 + i)
        x, b, all_parts = parts[rank].cuda(), bias.cuda(), parts.cuda()
        picked = par.peer_form(math.prod(shape), 2, torch.float32)
        forms = (par.ONE_SHOT, par.TWO_SHOT) if shape == PEER_SHAPES[2] else (picked,)
        for form in forms:
            f32_too = i == 0 or shape == PEER_SHAPES[2]
            for dtype, bias_dev in ((torch.bfloat16, b), *(((torch.float32, b.float()),) if f32_too else ())):
                got = par.peer_all_reduce(x, bias_dev, group, form=form)
                want = par.peer_all_reduce_plain(all_parts, bias_dev)
                err = float((got.float() - want.float()).abs().max())
                sums = [None, None]
                dist.all_gather_object(sums, got.float().cpu().numpy().tobytes())
                check(err <= PEER_TOL and sums[0] == sums[1],
                      f"peer kernel, 2 ranks, {shape} -> {dtype}, {form}: max_abs_err {err} <= {PEER_TOL}, ranks "
                      "equal")
                out[(shape, str(dtype), form)] = {"max_abs_err": err, "form": form, "picked": form == picked}
            saved = step_graph.read_counts()
            ms = time_graph(lambda: par.peer_all_reduce(x, b, group, form=form), iters=20, reps=3)
            plain_ms = time_graph(lambda: par.peer_all_reduce_plain(all_parts, b), iters=20, reps=3)
            step_graph.restore_counts(saved)
            bound, by = peer_bound_ms(shape, 2, torch.float32, torch.bfloat16)
            out[(shape, str(torch.bfloat16), form)].update(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
    return out


PEER_F32_FRAMES = 8  # the float32 split's frames: its first step is what is held

# The bf16 "model" split held against its mesh=None twin at the forward: the
# split's tokens (relative RMS distance) within TP_BF16_RATIO times the
# mesh=None bf16 forward's own distance from the f32 forward, both taken in
# this run. Readings on two CPU ranks (tests/test_torch_mesh.py
# test_bf16_split_within_the_smokes_rounding_limit): 0.79 sound, 24.6 with
# the bias added twice, 85.4 with rank 1's partial dropped; the card's is
# printed by the peer phase. TP_BIAS_STD: every block's biases
# are drawn at this scale for the check, since the random trunk's are 0 and
# the trained head's about 0.003, where a bias added twice would not show.
TP_BF16_RATIO = 1.5
TP_BIAS_STD = 0.1


def with_drawn_biases(prm: dict, seed: int, std: float = TP_BIAS_STD) -> dict:
    """A copy of a ViT parameter tree whose attention and MLP biases (bqkv,
    bo, b1, b2; trunk and head blocks) are drawn N(0, std) from numpy's
    generator for `seed`, on each leaf's device."""
    rng = np.random.default_rng(seed)

    def draw(blocks: dict) -> dict:
        return {g: {k: torch.from_numpy(rng.normal(0.0, std, tuple(v.shape)).astype(np.float32)).to(v.device)
                    if g in ("attn", "mlp") and k.startswith("b") else v for k, v in leaves.items()}
                for g, leaves in blocks.items()}

    out = dict(prm, blocks=draw(prm["blocks"]))
    if "head" in prm:
        out["head"] = dict(prm["head"], blocks=draw(prm["head"]["blocks"]))
    return out


def rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| in f32."""
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def tp_split_ratio(split: torch.Tensor, twin: torch.Tensor, f32: torch.Tensor) -> tuple[float, float, float]:
    """The split's distance from its bf16 twin, the twin's from the f32
    forward, and their ratio (held to TP_BF16_RATIO)."""
    d, base = rel_rms(split, twin), rel_rms(twin, f32)
    return d, base, d / base


def peer_tp_forward(mesh) -> dict:
    """On both ranks: ROBUST_CONFIG's ViT (B/16 and its head, bf16) with
    biases drawn by with_drawn_biases, split over "model" 2 (torch.mm's
    f32 partials and the peer kernel: what a bf16 tensor-parallel
    deployment runs) on one seeded 224-px image, against the mesh=None bf16
    and f32 forwards on the card: the distance within TP_BF16_RATIO of the
    bf16 forward's own rounding; both ranks' tokens equal."""
    import hashlib

    import torch.distributed as dist

    cfg_dict = copy.deepcopy(ROBUST_CONFIG)
    cfg_dict["model"]["checkpoint"] = str(ROOT / HEAD_CHECKPOINT)
    cfg = Config.from_dict(cfg_dict)
    spec = VitSpec.from_config(cfg.model)
    prm = with_drawn_biases(vit_params.load_or_init(cfg.model.checkpoint, spec, cfg.filter.seed, device="cuda"), 11)
    image = np.random.default_rng(12).normal(size=(1, spec.image_size, spec.image_size, 3)).astype(np.float32)
    images = torch.from_numpy(image).cuda()
    twin = vit_forward_tokens(prm, images, spec)
    f32 = vit_forward_tokens(prm, images, spec._replace(dtype=torch.float32))
    split = vit_forward_tokens(pmesh.vit_param_shard(mesh, prm), images, spec._replace(mesh=mesh))
    d, base, ratio = tp_split_ratio(split, twin, f32)
    digests = [None, None]
    dist.all_gather_object(digests, hashlib.sha256(split.float().cpu().numpy().tobytes()).hexdigest())
    check(ratio <= TP_BF16_RATIO and digests[0] == digests[1],
          f"peer tp forward, bf16 on \"model\" 2: {d:.5f} off the mesh=None bf16 tokens, {ratio:.3f} x the bf16 "
          f"forward's own {base:.5f} from f32 (<= {TP_BF16_RATIO}); both ranks equal")
    return {"split_vs_twin": d, "twin_vs_f32": base, "ratio": ratio,
            "max_abs": float((split.float() - twin.float()).abs().max())}


def _robust_runs(mesh, kinds, dtype: str, frames: int) -> dict:
    """ROBUST_CONFIG (model.dtype `dtype`, `frames` frames of teleport)
    through Tracker.run for each kind: "twin" (mesh=None, graphs),
    "eager" (the mesh, graphs=False: branches on the host), "graph" (the
    mesh, its IF bodies holding the peer kernel) -> records, the steps'
    (scanned, accepted), counts, and the graph's replay tally."""
    cfg_dict = copy.deepcopy(ROBUST_CONFIG)
    cfg_dict["model"].update(checkpoint=str(ROOT / HEAD_CHECKPOINT), dtype=dtype)
    cfg_dict["io"]["num_frames"] = frames
    cfg = Config.from_dict(cfg_dict)
    src = open_source(cfg.io.source, cfg.io.num_frames, tuple(cfg.io.frame_size), seed=cfg.filter.seed)
    prm = Tracker(cfg, device="cuda").vit_params
    runs = {}
    for kind in kinds:
        tracker = Tracker(cfg, vit_params=prm, device="cuda", mesh=None if kind == "twin" else mesh,
                          graphs=kind != "eager")
        reset_counts()
        recs, steps = [], []
        for rec in tracker.run(src):
            recs.append(rec)
            steps.append(scan_accepted(tracker.state, cfg.tracker.redetect_global_after))
        runs[kind] = {"recs": recs, "steps": steps, **read_counts(),
                      "tally": replay_tally(tracker) if kind == "graph" else None}
    return runs


def _off_twin(run: dict, twin: dict) -> tuple[list, float]:
    """Each step's largest position difference from the twin, and the first
    step's confidence difference."""
    by_step = [float(np.abs(np.subtract(a["position"], b["position"])).max()) for a, b in zip(run["recs"], twin["recs"])]
    return by_step, abs(run["recs"][0]["conf"] - twin["recs"][0]["conf"])


def peer_robust_run(mesh) -> dict:
    """The robust path (ROBUST_CONFIG) with the ViT split over "model" 2
    across the two processes. bf16, 48 frames of teleport: the mesh=None
    twin, the mesh eagerly and through the captured graph, whose probe and
    scan IF-node bodies hold the peer kernel; held: the graph run against
    the eager run at every step (the smoke's graph-against-eager rule:
    flags equal, positions within GRAPH_POS_TOL_PX), probes and scans
    fired, the peer launches twice K1's with both IF bodies holding some,
    both ranks' records equal; reported: the distance from the twin, where
    each rank's bf16 products over H / 2 heads and mlp_dim / 2 columns
    round otherwise than the whole block's (a few ulps at the first step,
    grown by resampling). float32, PEER_F32_FRAMES frames: the twin and the
    graph run, the first step held within GRAPH_POS_TOL_PX and 1e-2 in
    confidence of the twin (a wrong split, a head slice or a bias added
    twice, shows there)."""
    import torch.distributed as dist

    runs = _robust_runs(mesh, ("twin", "eager", "graph"), "bfloat16", ROBUST_CONFIG["io"]["num_frames"])
    g, e, t = runs["graph"], runs["eager"], runs["twin"]
    worst = 0.0
    for i, (a, b) in enumerate(zip(g["recs"], e["recs"])):
        check(a["lost"] == b["lost"] and a["resampled"] == b["resampled"], f"peer robust step {i + 1}: flags")
        worst = max(worst, float(np.abs(np.subtract(a["position"], b["position"])).max()))
    check(len(g["recs"]) == len(e["recs"]) == len(t["recs"]) and worst <= GRAPH_POS_TOL_PX,
          f"peer robust: mesh graph within {GRAPH_POS_TOL_PX} px of mesh eager at every step ({worst})")
    probes = sum(r["lost"] for r in g["recs"][:-1])
    scans = sum(s[0] for s in g["steps"])
    check(probes >= 1 and scans >= 1, f"peer robust: {probes} probes and {scans} scans (at least one each)")
    check(g["peer_launches"] == 2 * g["launches"] > 0 and g["k1_shapes"] == e["k1_shapes"],
          f"peer robust: {g['peer_launches']} peer launches == 2 x K1 {g['launches']}; K1 as eager")
    branches = g["tally"]["branch_peer_launches"]
    check(len(branches) == 2 and all(x > 0 for x in branches), f"peer robust: IF bodies' peer launches {branches}")
    everyone = [None, None]
    dist.all_gather_object(everyone, [r["position"] for r in g["recs"]])
    check(everyone[0] == everyone[1], "peer robust: both ranks' records equal")
    by_step, conf = _off_twin(g, t)
    moved = [i + 1 for i, d in enumerate(by_step) if d > 0]
    f32 = _robust_runs(mesh, ("twin", "graph"), "float32", PEER_F32_FRAMES)
    f32_steps, f32_conf = _off_twin(f32["graph"], f32["twin"])
    check(f32_steps[0] <= GRAPH_POS_TOL_PX and f32_conf <= 1e-2,
          f"peer robust, float32: first step {f32_steps[0]} px, conf {f32_conf} off the mesh=None twin")
    return {"graph_vs_eager_max_px": worst, "first_step_px": by_step[0], "first_step_conf": conf,
            "max_px_off_twin": max(by_step), "first_step_off_twin": moved[0] if moved else None,
            "f32_first_step_px": f32_steps[0], "f32_first_step_conf": f32_conf, "f32_max_px_off_twin": max(f32_steps),
            "probes": probes, "scans": scans, "launches": g["launches"], "peer_launches": g["peer_launches"],
            "peer_shapes": g["peer_shapes"], "k1_shapes": g["k1_shapes"], "branch_peer_launches": branches}


def run_peer_phase() -> dict:
    """Two processes spawned on cuda:0 in a gloo group of two over a file
    store (NCCL refuses two ranks on one card; only the peer kernel moves
    data on the card): the kernel against its plain version
    (peer_kernel_checks), then the robust path on make_mesh(1, 1, 2)
    captured with the kernel in its IF bodies (peer_robust_run). Every
    process is joined (or killed) before this returns."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_peer_rank, args=(r, f"{tmp}/store", results)) for r in range(2)]
        for p in procs:
            p.start()
        got = {}
        try:
            for _ in procs:
                rank, ok, value = results.get(timeout=PEER_TIMEOUT_S)
                check(ok, f"peer phase, rank {rank}:\n{value}")
                got[rank] = value
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
    r0, r1 = got[0], got[1]
    for (shape, dtype, form), row in r0["kernel"].items():
        took = "the form peer_form picks" if row["picked"] else "forced"
        timing = (f"{row['ms']:.4f} ms a call (the contexts' turns), plain {row['plain_ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.5f} ms; " if "ms" in row else "")
        print(f"  peer kernel, 2 processes on one card, {shape} f32 -> {dtype.removeprefix('torch.')}, {form} ({took}): "
              f"{timing}max_abs_err {row['max_abs_err']}", flush=True)
    tp = r0["tp_forward"]
    print(f"  peer tp forward, ViT-B/16 + head in bf16 on \"model\" 2 (biases drawn at {TP_BIAS_STD}): tokens "
          f"{tp['split_vs_twin']:.5f} (relative RMS; max abs {tp['max_abs']:.4f}) off the mesh=None bf16 forward, "
          f"which is {tp['twin_vs_f32']:.5f} off the f32 forward: ratio {tp['ratio']:.3f} <= {TP_BF16_RATIO}",
          flush=True)
    rb = r0["robust"]
    check(rb["peer_shapes"] == r1["robust"]["peer_shapes"], "peer phase: both ranks launched alike")
    print(f"  peer robust on make_mesh(1, 1, 2), 2 processes, bf16: graph == eager within "
          f"{rb['graph_vs_eager_max_px']:.2e} px at every step; {rb['probes']} probes, {rb['scans']} scans; K1 "
          f"{rb['launches']}, peer {rb['peer_launches']} {rb['peer_shapes']}; IF bodies' peer launches a replay "
          f"{rb['branch_peer_launches']}; off the mesh=None twin (reported): first step {rb['first_step_px']:.2e} px "
          f"/ conf {rb['first_step_conf']:.2e}, then up to {rb['max_px_off_twin']:.3f} px (first off at step "
          f"{rb['first_step_off_twin']}); float32, {PEER_F32_FRAMES} frames: first step {rb['f32_first_step_px']:.2e} "
          f"px / conf {rb['f32_first_step_conf']:.2e} off the twin (held to {GRAPH_POS_TOL_PX} px), then up to "
          f"{rb['f32_max_px_off_twin']:.2e} px", flush=True)
    return r0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs the card",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase("device", t0)

    t0 = time.perf_counter()
    built = _build.build_libraries(["flash_attn.cu", "window_patchify.cu", "graph_if.cu", "peer_allreduce.cu",
                                    "step_noise.cu", "swiglu.cu", "prenorm_junction.cu"])
    for source, (_, rec) in built.items():
        print(f"  nvcc build of {source}: {rec['seconds']:.2f} s (built={rec['built']}) -> {rec['so']}")
        for line in rec["ptxas"].splitlines():
            print(f"  ptxas: {line.strip()}")
    lib = _build.flash_attn_library()
    for shape, dtype in [(x, torch.bfloat16) for x in TIME_SHAPES] + [(DENSE_SHAPE, torch.float32),
                                                                       (REDETECT_SHAPE, torch.float32)]:
        x = torch.empty(shape, dtype=dtype, device="cuda")
        plan = attention.launch_plan(x, x, x, x, torch.cuda.get_device_properties(0).multi_processor_count)
        smem = lib.vpt_flash_attn_smem_bytes(attention._PATH_CODES[plan.path], attention._DTYPE_CODES[dtype],
                                             plan.t, plan.warps)
        print(f"  K1 at {shape} {str(dtype).removeprefix('torch.')}: {plan.path} path, {plan.warps} warps a block, "
              f"grid {plan.grid}, {smem} B of dynamic shared memory a block")
    check_k2_build(built["window_patchify.cu"][1])
    phase("build", t0)

    t0 = time.perf_counter()
    errs = check_kernel()
    k2_errs = check_window_patchify()
    k2_window_errs = check_window_patchify_windows()
    check_if_node()
    check_step_noise()
    swiglu_errs = check_swiglu()
    junction_errs = check_prenorm_junction()
    phase("kernel", t0)

    t0 = time.perf_counter()
    check_tracker_small()
    check_tracker_small(TINY_CROP_NO_RESAMPLE, "tiny crop tracker (window-pallas)")
    check_tracker_small(TINY_HEAD_REDETECT, "tiny dense tracker (head, auto blend, re-detection)")
    check_tracker_small(TINY_CROP_REDETECT, "tiny crop tracker (window-pallas, re-detection)")
    check_banked_small(TINY_BANKED_REDETECT, "banked", 3, "tiny banked dense tracker (lost gate, re-detection)")
    check_banked_small(TINY_BANKED_CROP, "banked", 2, "tiny banked crop tracker (K2 over 2 windows)")
    check_banked_small(TINY_NO_RESAMPLE, "streams", 3, "tiny multi-stream tracker")
    main_path = run_main_path()
    main_path.update(run_clip(main_path))
    crop_path = run_main_path(CROP_OVERRIDES, CROP_RMSE_BOUND_PX)
    robust_path = run_robust_path()
    banked_path = run_banked_path()
    banked_path.update(check_reinit_bank(banked_path))
    streams_path = run_multistream_path(main_path)
    dinov2_path = run_dinov2_path()
    phase("tracker", t0)

    t0 = time.perf_counter()
    stream_dense = run_stream(main_path, "stream, dense")
    stream_dense["track_clip_device_frames_per_s"] = main_path["clip_frames_per_s"]
    print(f"  stream, dense: {stream_dense['frames_per_s_after_init']:.1f} frames/s after init, against this call's "
          f"dense track_clip_device {main_path['clip_frames_per_s']:.1f} frames/s", flush=True)
    stream_robust = run_stream(robust_path, "stream, robust")
    serve = run_serve(main_path, streams_path)
    phase("stream", t0)

    t0 = time.perf_counter()
    eval5 = run_eval5_roi()
    teleport = run_eval5_teleport(eval5)
    chunk_eq = check_chunk_equals_steps(eval5)
    adaptive = run_adaptive_roi()
    crop_roi = run_crop_roi(crop_path)
    phase("stream, roi", t0)

    t0 = time.perf_counter()
    bench = {Path(path).stem: run_bench(i) for i, (path, *_) in enumerate(_bench_evals.EVALS, start=1)}
    eval3 = run_eval3_track()
    phase("bench", t0)

    t0 = time.perf_counter()
    train = run_train_phase()
    phase("train", t0)

    t0 = time.perf_counter()
    mesh = run_mesh_phase(main_path, robust_path, banked_path, streams_path)
    phase("mesh", t0)

    t0 = time.perf_counter()
    peer = run_peer_phase()
    phase("peer", t0)

    t0 = time.perf_counter()
    times = time_kernels()
    times_f32 = time_kernels([DENSE_SHAPE, REDETECT_SHAPE], torch.float32)
    k2_times = time_window_patchify(K2_MAIN)
    k2_one_times = time_window_patchify(K2_ONE)
    k2_window_times = time_window_patchify_windows()
    k2_mesh_times = [(p, m, time_window_patchify(m)) for p, m in ((2, dict(K2_MAIN, n=512)), (4, dict(K2_MAIN, n=256)))]
    noise_times = {}
    for shape in NOISE_SHAPES:
        noise_times.update(time_step_noise(*shape))
    swiglu_times = {shape: time_swiglu(*shape) for shape in SWIGLU_SHAPES[:2]}
    junction_times = {shape: time_prenorm_junction(*shape) for shape in JUNCTION_SHAPES[:JUNCTION_CELLS + 2]}
    phase("times", t0)

    # One entry per kernel, main path and shape: K1 at the dense path's
    # shape, at the crop path's two (the particles at B = 1024, the init
    # and template forwards at B = 1) and at the robust path's scan (49 tile
    # windows); K2 at N = 1024 and N = 1. Each with
    # the launches at that shape in that path's run, its bf16 error on the
    # fused views and its times.
    k1_common = dict(name="flash_attention", route="cuda",
                     source="vitparticlefiltertracker_tpu_torch/csrc/flash_attn.cu",
                     replaces="vitparticlefiltertracker_tpu/ops/attention.py:59")
    k1_rows = [dict(**k1_common, path=path, shape=list(shape), launches=run["k1_shapes"].get(shape[:3], 0),
                    max_abs_err=errs[(shape, torch.bfloat16, "fused")], **times[shape])
               for path, shape, run in (("dense", DENSE_SHAPE, main_path), ("crop", CROP_SHAPE, crop_path),
                                        ("crop", CROP_ONE_SHAPE, crop_path), ("robust", REDETECT_SHAPE, robust_path),
                                        ("banked", BANKED_SHAPE, banked_path),
                                        ("multistream", STREAMS_SHAPE, streams_path),
                                        ("eval5-roi-c4", EVAL5_DENSE_SHAPE, eval5),
                                        ("eval5-roi-teleport-c4", EVAL5_REDETECT_SHAPE, teleport),
                                        ("bench eval2", DENSE_SHAPE, bench["eval2-tpu-occlusion"]),
                                        ("bench eval3", EVAL5_DENSE_SHAPE, bench["eval3-tpu-needle-1080p"]),
                                        ("bench eval4", BANKED_SHAPE, bench["eval4-tpu-multiobject-720p"]),
                                        ("bench eval5", EVAL5_DENSE_SHAPE, bench["eval5-tpu-streaming-4k"]))]
    # The train phase: K1 in the head run's probes (the trainer's own step
    # runs the plain attention), and the trained files served by the robust
    # path and by config.yaml's dense tracker.
    head, features = train["head"], train["features"]
    for path, shape, shapes in (("train probe (head)", DENSE_SHAPE, head["k1_shapes"]),
                                ("train probe (head), lookalikes scan", REDETECT_SHAPE, head["k1_shapes"]),
                                ("robust, trained head file", DENSE_SHAPE, head["robust_k1_shapes"]),
                                ("robust, trained head file, scan", REDETECT_SHAPE, head["robust_k1_shapes"]),
                                ("dense, trained backbone file", DENSE_SHAPE, features["k1_shapes"])):
        if shape is DENSE_SHAPE or shapes.get(shape[:3], 0):
            k1_rows.append(dict(**k1_common, path=path, shape=list(shape), launches=shapes.get(shape[:3], 0),
                                max_abs_err=errs[(shape, torch.bfloat16, "fused")], **times[shape]))
    # eval1 runs f32: K1 at the dense shape in f32, timed in f32.
    k1_rows.append(dict(**k1_common, path="bench eval1", shape=list(DENSE_SHAPE), dtype="float32",
                        launches=bench["eval1-cpu-synthetic"]["k1_shapes"].get(DENSE_SHAPE[:3], 0),
                        max_abs_err=errs[(DENSE_SHAPE, torch.float32, "fused")], **times_f32[DENSE_SHAPE]))
    # The mesh phase's paths at world size 1: K1 in every forward of (a) and
    # (b) (and in the IF bodies of (c)).
    for path, shape, run in (("mesh (a) dense, make_mesh(1, 1, 1)", DENSE_SHAPE, mesh["dense"]),
                             ("mesh (b) eval3, make_mesh(1, 1, 1)", EVAL5_DENSE_SHAPE, mesh["eval3"]),
                             ("mesh (c) robust, make_mesh(1, 1, 1)", DENSE_SHAPE, mesh["robust"]),
                             ("mesh (c) robust, make_mesh(1, 1, 1), scan", REDETECT_SHAPE, mesh["robust"])):
        k1_rows.append(dict(**k1_common, path=path, shape=list(shape), launches=run["k1_shapes"].get(shape[:3], 0),
                            max_abs_err=errs[(shape, torch.bfloat16, "fused")], **times[shape]))
    # K1 with H / 2 heads under "model" 2: ViT-B/16's in the peer phase's
    # robust run (two processes on this card); ViT-L/16's only on a mesh of
    # 2 cards or more, as K2 on a rank's N / P boxes.
    b16_tp, l16_tp = TP_SHAPES
    k1_rows.append(dict(**k1_common, path="peer phase: robust on make_mesh(1, 1, 2), 2 processes on one card",
                        shape=list(b16_tp), launches=peer["robust"]["k1_shapes"].get(b16_tp[:3], 0),
                        max_abs_err=errs[(b16_tp, torch.bfloat16, "fused")], **times[b16_tp]))
    multi_card = [dict(**k1_common, path="mesh (1, 1, 2) on 2 cards, ViT-L/16: not run on one card",
                       shape=list(l16_tp), launches=0, max_abs_err=errs[(l16_tp, torch.bfloat16, "fused")],
                       **times[l16_tp])]
    # K1 in f32 at the scan's shape (the tiled 3xTF32 path; eval1's dense
    # shape takes the split path): timed beside eval1's, run by no path here
    # (the f32 configs have no re-detection).
    multi_card.append(dict(**k1_common, path="f32 at the scan's shape: timed only, no path here scans in float32",
                           shape=list(REDETECT_SHAPE), dtype="float32", launches=0,
                           max_abs_err=errs[(REDETECT_SHAPE, torch.float32, "fused")], **times_f32[REDETECT_SHAPE]))
    k2_rows = [dict(name="gather_patchify_window", route="cuda",
                    source="vitparticlefiltertracker_tpu_torch/csrc/window_patchify.cu",
                    replaces="vitparticlefiltertracker_tpu/ops/patchify_pallas.py:59",
                    path="crop", shape=[m["n"], m["swin"], m["crop"], m["d"]],
                    launches=crop_path["k2_sizes"].get(m["n"], 0),
                    max_abs_err=k2_errs[(m["n"], m["crop"], m["swin"], m["d"], torch.bfloat16, True)], **kt)
               for m, kt in ((K2_MAIN, k2_times), (K2_ONE, k2_one_times))]
    multi_card += [{**k2_rows[0], "path": f"crop on a particle mesh of {p} cards: not run on one card",
                    "shape": [m["n"], m["swin"], m["crop"], m["d"]], "launches": 0,
                    "max_abs_err": k2_errs[(m["n"], m["crop"], m["swin"], m["d"], torch.bfloat16, True)], **kt}
                   for p, m, kt in k2_mesh_times]
    # K2 on the crop-mode ROI stream: the main crop shape (its time above),
    # its error on a window resampled from the strided ROI view.
    k2_rows.append({**k2_rows[0], "path": "crop-roi", "launches": crop_roi["k2_sizes"].get(K2_MAIN["n"], 0),
                    "max_abs_err": crop_roi["k2_roi_view_max_abs_err"]})
    # The peer all-reduce kernel: in the peer phase's robust run (two
    # processes, "model" 2: f32 partials into bf16) at B 1 and in the scan
    # at B 49, and on the world-1 mesh phase's paths (one rank: the bf16
    # product in); L/16 under "model" 2 only on several cards.
    # library_ms: on one rank torch.add (the bf16 product plus the bias,
    # rounded once), timed by time_peer_one_rank; across ranks the library
    # call is NCCL's dist.all_reduce, which refuses two ranks on one card,
    # so the two-process rows carry None and say where NCCL's times are.
    peer_common = dict(name="peer_all_reduce", route="cuda",
                       source="vitparticlefiltertracker_tpu_torch/csrc/peer_allreduce.cu",
                       replaces="none: XLA's partitioner sums the row-parallel products in the JAX package "
                                "(vitparticlefiltertracker_tpu/parallel/mesh.py:70 vit_param_sharding)")
    no_nccl = dict(library_ms=None, library_note="NCCL's dist.all_reduce refuses two ranks on one card; its times "
                                                 "at these shapes on 4 cards: PERF.md section 6 "
                                                 "(tools/port_mesh_check.py)")
    two = peer["robust"]["peer_shapes"]
    picked = {shape: par.peer_form(math.prod(shape), 2, torch.float32) for shape in PEER_SHAPES}
    peer_rows = [dict(**peer_common, path=f"peer phase: robust on make_mesh(1, 1, 2), 2 processes on one card{tag}",
                      shape=list(shape), dtype="float32 -> bfloat16", launches=two.get((2, *shape), 0),
                      **peer["kernel"][(shape, str(torch.bfloat16), picked[shape])], **no_nccl)
                 for shape, tag in ((PEER_SHAPES[0], ""), (PEER_SHAPES[2], ", scan"))]
    for path, shape, run in (("mesh (a) dense, make_mesh(1, 1, 1)", PEER_SHAPES[0], mesh["dense"]),
                             ("mesh (b) eval3, make_mesh(1, 1, 1)", PEER_SHAPES[1], mesh["eval3"]),
                             ("mesh (c) robust, make_mesh(1, 1, 1), scan", PEER_SHAPES[2], mesh["robust"])):
        peer_rows.append(dict(**peer_common, path=path, shape=list(shape), dtype="bfloat16 -> bfloat16",
                              launches=run["peer_shapes"].get((1, *shape), 0), form=par.ONE_SHOT,
                              **mesh["peer_times"][shape]))
    multi_card.append(dict(**peer_common, path="eval3 (ViT-L/16) on \"model\" 2: several cards, not run on one card",
                           shape=list(PEER_SHAPES[1]), dtype="float32 -> bfloat16", launches=0,
                           **peer["kernel"][(PEER_SHAPES[1], str(torch.bfloat16), picked[PEER_SHAPES[1]])], **no_nccl))
    # The scan's shape in the form peer_form does not pick there: timed and
    # checked bitwise, run by no path.
    other = par.ONE_SHOT if picked[PEER_SHAPES[2]] == par.TWO_SHOT else par.TWO_SHOT
    multi_card.append(dict(**peer_common, path=f"peer phase: the scan's shape in the {other} form (forced; no path "
                                               "takes it at this shape)",
                           shape=list(PEER_SHAPES[2]), dtype="float32 -> bfloat16", launches=0,
                           **peer["kernel"][(PEER_SHAPES[2], str(torch.bfloat16), other)], **no_nccl))
    # The step noise kernel: once a step in the graph runs of the dense,
    # robust (with the reseed normals) and banked paths, at each one's
    # (C, K, N, reseed); timed at NOISE_SHAPES, whose rows the paths here do
    # not run (the benchmark cells' banks, a ROI chunk) are timed only.
    noise_common = dict(name="step_noise", route="cuda", source="vitparticlefiltertracker_tpu_torch/csrc/step_noise.cu",
                        replaces="vitparticlefiltertracker_tpu/filters/particle.py:60 (jax.random draws inside the "
                                 "jitted step)", max_abs_err=0.0)
    noise_rows = []
    for path, run in (("dense", main_path), ("robust", robust_path), ("banked", banked_path)):
        (shape, launches), = run["noise_shapes"].items()
        if shape not in noise_times:
            c, k, n, reseed = shape
            noise_times.update(time_step_noise(None, k, n, reseed))
        noise_rows.append(dict(**noise_common, path=path, shape=list(shape), launches=launches, **noise_times[shape]))
    seen = {tuple(r["shape"]) for r in noise_rows}
    multi_card += [dict(**noise_common, path="timed only: the benchmark cells' banks and a ROI chunk (no path here)",
                        shape=list(shape), launches=0, **row) for shape, row in noise_times.items() if shape not in seen]
    # DINOv2 ViT-g/14's block (the dinov2 path, 2 blocks): K1 at its
    # attention shape and the SwiGLU gate at its FFN's one window; the gate
    # at 16 windows is timed only.
    k1_rows.append(dict(**k1_common, path=f"dinov2 (dinov2-g14-reg cut to {DINOV2_DEPTH} blocks)",
                        shape=list(DINOV2_SHAPE), launches=dinov2_path["k1_shapes"].get(DINOV2_SHAPE[:3], 0),
                        max_abs_err=errs[(DINOV2_SHAPE, torch.bfloat16, "fused")], **times[DINOV2_SHAPE]))
    swiglu_common = dict(name="swiglu", route="cuda", source="vitparticlefiltertracker_tpu_torch/csrc/swiglu.cu",
                         replaces="none: the JAX package has no SwiGLU block")
    swiglu_rows = [dict(**swiglu_common, path=f"dinov2 (dinov2-g14-reg cut to {DINOV2_DEPTH} blocks)",
                        shape=list(SWIGLU_SHAPES[0]), launches=dinov2_path["swiglu_shapes"].get(SWIGLU_SHAPES[0], 0),
                        max_abs_err=swiglu_errs[(*SWIGLU_SHAPES[0], torch.bfloat16)][0],
                        **swiglu_times[SWIGLU_SHAPES[0]])]
    multi_card.append(dict(**swiglu_common, path="the FFN at 16 windows: timed only (no path here)",
                           shape=list(SWIGLU_SHAPES[1]), launches=0,
                           max_abs_err=swiglu_errs[(*SWIGLU_SHAPES[1], torch.bfloat16)][0],
                           **swiglu_times[SWIGLU_SHAPES[1]]))
    # The pre-norm junction: at the dense, crop and dinov2 paths' forwards
    # (ViT-B/16's window, its 1024 particles of 4 tokens, DINOv2 ViT-g/14's
    # window) and eval1's f32 window; the other cells' shapes timed only.
    junction_common = dict(name="prenorm_junction", route="cuda",
                           source="vitparticlefiltertracker_tpu_torch/csrc/prenorm_junction.cu",
                           replaces="none: XLA fuses the JAX package's layer norm and residual adds itself")
    junction_rows, run_shapes = [], {}
    for path, shape, run in (("dense", JUNCTION_SHAPES[3], main_path), ("crop", JUNCTION_SHAPES[4], crop_path),
                             (f"dinov2 (dinov2-g14-reg cut to {DINOV2_DEPTH} blocks)", JUNCTION_SHAPES[2], dinov2_path),
                             ("bench eval1", JUNCTION_SHAPES[5], bench["eval1-cpu-synthetic"])):
        m, d, dtype = shape
        run_shapes[shape] = run
        junction_rows.append(dict(**junction_common, path=path, shape=[m, d], dtype=str(dtype).removeprefix("torch."),
                                  launches=run["junction_shapes"].get((m, d), 0),
                                  max_abs_err=junction_errs[(m, d, dtype, True, True)]["max_abs_err"],
                                  **junction_times[shape]))
    multi_card += [dict(**junction_common, path="a benchmark cell's forward: timed only (no path here)", shape=[m, d],
                        dtype=str(dtype).removeprefix("torch."), launches=0,
                        max_abs_err=junction_errs[(m, d, dtype, True, True)]["max_abs_err"],
                        **junction_times[(m, d, dtype)])
                   for m, d, dtype in JUNCTION_SHAPES[:JUNCTION_CELLS] if (m, d, dtype) not in run_shapes]
    check(all(r["launches"] > 0 for r in k1_rows + k2_rows + peer_rows + noise_rows + swiglu_rows + junction_rows),
          "every kernel row was launched on its main path")
    path_keys = ("step_ms_median", "eager_step_ms_median", "turn_medians_ms", "bitwise", "max_pos_diff_px",
                 "rmse_px", "waits_per_step", "waits_in_clip")
    print(json.dumps({"shape_49x12x196x64_bf16": times[REDETECT_SHAPE],
                      "dense": {k: main_path[k] for k in path_keys + ("clip_frames_per_s", "clip_ms")},
                      "crop": {k: crop_path[k] for k in path_keys},
                      "robust": {k: robust_path[k] for k in path_keys + ("lost", "scans", "accepts",
                                                                         "probes", "trunk_regen_s")},
                      "robust_k1_shapes": {str(k): v for k, v in robust_path["k1_shapes"].items()},
                      "banked": {k: banked_path[k] for k in path_keys + ("rmse_px_by_bank",
                                                                         "reinit_bank1_px_from_target2")},
                      "multistream": {k: streams_path[k] for k in ("step_ms_median", "eager_step_ms_median",
                                                                   "aggregate_frames_per_s", "dense_frames_per_s",
                                                                   "rmse_px_by_stream")},
                      "dinov2": {k: dinov2_path[k] for k in ("step_ms_median", "eager_step_ms_median",
                                                             "turn_medians_ms", "bitwise", "max_pos_diff_px")},
                      "stream_dense": stream_dense, "stream_robust": stream_robust, "serve": serve,
                      "stream_roi": {label: {k: v for k, v in run.items() if k in ROI_KEYS}
                                     for label, run in (("eval5-roi-c4", eval5), ("eval5-roi-teleport-c4", teleport),
                                                        ("adaptive", adaptive), ("crop-roi", crop_roi))},
                      "chunk_equals_steps": chunk_eq,
                      "bench": {name: {k: v for k, v in b.items() if not k.endswith("_shapes")}
                                for name, b in bench.items()},
                      "eval3_track": {k: v for k, v in eval3.items() if k != "k1_shapes"},
                      "train": {"parity": train["parity"],
                                **{name: {k: v for k, v in run.items() if "k1_shapes" not in k}
                                   for name, run in (("head", head), ("features", features))}},
                      "mesh": {name: {k: v for k, v in run.items() if k not in ("k1_shapes", "peer_shapes")}
                               for name, run in mesh.items() if name != "peer_times"},
                      "peer_robust": {k: v for k, v in peer["robust"].items() if k not in ("k1_shapes", "peer_shapes")},
                      "peer_tp_forward": peer["tp_forward"],
                      "k2_8_windows_x_1024": {**k2_window_times,
                                              "max_abs_err": k2_window_errs[(8, 1024, torch.bfloat16)]}}))
    print(f"[phase] total: {time.perf_counter() - t_start:.2f} s", flush=True)
    print(f"card: {smi}")
    print(json.dumps({"kernels": k1_rows + k2_rows + peer_rows + noise_rows + swiglu_rows + junction_rows
                                 + multi_card}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
