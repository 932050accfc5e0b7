#!/usr/bin/env python3
"""K1's times on the card for one checkout of the port, so that two commits
can be compared in one chip call with the same method.

Imports the port from --root (default: this checkout) and times, in
--dtype (bfloat16 by default; float32 is eval1's), at chip_smoke.py's
phase-11 shapes:

  kernel     flash_attention alone, on the inputs that checkout's ViT hands
             it: views of the fused qkv activation where its wrapper takes
             them, else contiguous copies made before the timing;
  call site  the attention part of one ViT block as models/vit.py runs it:
             multi_head_attention on the fused views, then the output's
             [B, T, D] reshape, with whatever copies that checkout makes;
  sdpa       torch's scaled_dot_product_attention on the fused views (a
             yardstick the port never calls);
  plain      the port's reference_attention on the fused views (K1's plain
             version), and the kernel's largest difference from it.

Each is timed three ways: device time of one call (200 calls captured in a
CUDA graph, replayed 5 times between CUDA events), an eager loop of 200
calls between CUDA events, and the host's issue time of one call in that
loop (perf_counter before the synchronize). Prints one JSON line, and
writes it to --out when given. Needs a card; imports no JAX.

Usage: python3 tools/port_k1_times.py [--root DIR] [--label NAME] [--dtype float32] [--out FILE]
Comparing two commits: unpack the other one with `git archive` and run
parent, change, change, parent in one chip call.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

SHAPES = [(1, 12, 196, 64), (1024, 12, 4, 64), (1, 12, 4, 64), (49, 12, 196, 64)]
ITERS = 200


def time_graph(fn, iters: int = ITERS, reps: int = 5) -> float:
    """Device time of one call: `iters` calls captured in a CUDA graph, the
    graph replayed `reps` times between CUDA events, so the host's launch
    rate does not enter."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def time_eager(fn, iters: int = ITERS) -> tuple[float, float]:
    """(ms a call between CUDA events, host µs a call to issue it): an eager
    loop of launches, which the host's launch rate bounds at small shapes."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host / iters * 1e6


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    args = ap.parse_args()
    dtype = getattr(torch, args.dtype)
    sys.path.insert(0, os.path.abspath(args.root))
    from vitparticlefiltertracker_tpu_torch.ops import attention

    if not torch.cuda.is_available():
        print("port_k1_times: needs a card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in true f32
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for shape in SHAPES:
        b, h, t, d = shape
        g = torch.Generator(device="cuda").manual_seed(7)
        qkv = torch.randn((b, t, h * 3 * d), generator=g, device="cuda").to(dtype)
        q, k, v = qkv.reshape(b, t, h, 3, d).permute(3, 0, 2, 1, 4).unbind(0)
        try:
            attention.flash_attention(q, k, v)
            kq, kk, kv, inputs = q, k, v, "fused views"
        except ValueError:
            kq, kk, kv, inputs = q.contiguous(), k.contiguous(), v.contiguous(), "contiguous copies"
        fns = {
            "kernel": lambda: attention.flash_attention(kq, kk, kv),
            "call_site": lambda: attention.multi_head_attention(q, k, v).transpose(1, 2).reshape(b, t, h * d),
            "sdpa": lambda: sdpa(q, k, v),
            "plain": lambda: attention.reference_attention(q, k, v),
        }
        err = (attention.flash_attention(kq, kk, kv).float() - attention.reference_attention(q, k, v).float())
        row = {"kernel_inputs": inputs, "max_abs_err": float(err.abs().max())}
        for name, fn in fns.items():
            row[f"{name}_device_ms"] = time_graph(fn)
        for name, fn in fns.items():
            row[f"{name}_eager_ms"], row[f"{name}_host_us"] = time_eager(fn)
        rows["x".join(map(str, shape))] = row
        print(f"  {args.label} {shape}: " + ", ".join(
            f"{key} {val:.3e}" if key == "max_abs_err" else f"{key} {val:.4f}" if isinstance(val, float)
            else f"{key} {val}" for key, val in row.items()),
            flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    line = json.dumps({"label": args.label, "root": os.path.abspath(args.root), "card": smi, "dtype": args.dtype,
                       "shapes": rows})
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
