#!/usr/bin/env python3
"""Where the time of the port's train step goes, on the card.

Runs the train step of chip_smoke.py's train phase (--config head:
configs/train-head.yaml's values, the 2-block head on the frozen seeded
trunk; features: configs/train-features.yaml's, the whole backbone; both at
full width, B 32, canvas 288, window 224, bf16 over f32 masters) for
--warmup steps, times --steps more between CUDA events (the step's device
span; the host's issue time beside it), then profiles --profile steps with
torch.profiler and prints: the device-busy share (summed kernel time over
the profiled wall), kernels a step, and the kernels with the most device
time, also summed by family (GEMMs, attention's softmax, elementwise and
reductions, copies). One JSON line a config goes to --out. Imports only the
port; needs a card.

Usage: python3 tools/port_profile_train.py [--config head|features|both] [--warmup 3]
           [--steps 6] [--profile 2] [--top 20] [--out chiprun_out/train_profile.jsonl]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
from vitparticlefiltertracker_tpu_torch.config import Config  # noqa: E402
from vitparticlefiltertracker_tpu_torch.training.train import build_train_step  # noqa: E402
from vitparticlefiltertracker_tpu_torch.utils.profiling import device_kernels  # noqa: E402

CONFIGS = {"head": chip_smoke.TRAIN_HEAD_CONFIG, "features": chip_smoke.TRAIN_FEATURES_CONFIG}
FAMILIES = (("gemm", ("gemm", "cutlass", "sm90_", "sm80_", "cublas", "xmma", "splitk")),
            ("softmax", ("softmax",)),
            ("copy/cast", ("copy", "memcpy", "memset", "cat", "convert")),
            ("reduce", ("reduce", "norm", "sum", "max", "mean")),
            ("elementwise", ("elementwise", "vectorized", "unrolled", "pointwise")))


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def profile_config(name: str, args) -> dict:
    cfg = Config.from_dict(CONFIGS[name])
    init_fn, step_fn = build_train_step(cfg, "cuda")
    params, opt = init_fn()
    for i in range(args.warmup):
        step_fn(params, opt, i)
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(args.steps)]
    t0 = time.perf_counter()
    for j, (a, b) in enumerate(events):
        a.record()
        step_fn(params, opt, args.warmup + j)
        b.record()
    issue_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    span = statistics.median(a.elapsed_time(b) for a, b in events)
    base = args.warmup + args.steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for j in range(args.profile):
            step_fn(params, opt, base + j)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t1) * 1e3
    kernels = device_kernels(prof)
    by_kernel = {k: v.ms for k, v in kernels.items()}
    calls = sum(v.calls for v in kernels.values())
    busy = sum(by_kernel.values())
    fams = defaultdict(float)
    for k, ms in by_kernel.items():
        fams[family(k)] += ms / args.profile
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[: args.top]
    tr = cfg.train
    out = {"config": name, "batch": tr.batch_size, "step_ms": span, "issue_ms": issue_ms, "wall_ms": wall_ms,
           "pairs_per_s": tr.batch_size / span * 1e3, "device_ms_a_step": busy / args.profile,
           "busy_share": busy / prof_wall, "kernels_a_step": calls / args.profile,
           "families_ms_a_step": dict(sorted(fams.items(), key=lambda kv: -kv[1])),
           "top_ms_a_step": [[k[:90], ms / args.profile] for k, ms in top]}
    print(f"{name}: {span:.2f} ms a step (CUDA events, median of {args.steps}); host issue {issue_ms:.2f} ms, wall "
          f"{wall_ms:.2f} ms; profiled: {busy / args.profile:.2f} ms of kernels a step, busy {100 * busy / prof_wall:.1f} "
          f"% of {prof_wall / args.profile:.2f} ms, {calls / args.profile:.0f} kernels a step", flush=True)
    for fam, ms in out["families_ms_a_step"].items():
        print(f"  {fam:12s} {ms:8.3f} ms a step ({100 * ms * args.profile / busy:.1f} %)")
    for k, ms in top:
        print(f"  {ms / args.profile:8.3f} ms  {k[:110]}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=["head", "features", "both"], default="both")
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--profile", type=int, default=2)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("port_profile_train: needs a card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}", flush=True)
    names = ["head", "features"] if args.config == "both" else [args.config]
    rows = [dict(profile_config(n, args), card=smi) for n in names]
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
