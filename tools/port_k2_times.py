#!/usr/bin/env python3
"""K2's times on the card for one checkout of the port, so that two commits
can be compared in one chip call with the same method.

Imports the port from --root (default: this checkout) and times, bf16, the
crop path's two K2 calls (K2_MAIN and K2_ONE: Swin 256, crop 32, patch 16,
D 768; N 1024, the particles, and N 1, the template and init box), on a
0..255 window with boxes spread over it and the pixel normalization folded
into the weights, as the tracker calls it (k2_inputs, which chip_smoke.py
also uses for its K2 checks):

  kernel   gather_patchify_window, that checkout's K2;
  plain    window_gather_patchify_plain, its plain version;
  product  torch.addmm of the bias with the [N*g*g, 768] tokens, sampled
           beforehand, and the [768, 768] weight: cuBLAS's product alone,
           the yardstick of K2's product part (the port never calls it).

Each is timed as tools/port_k1_times.py times K1: device time of one call
(200 calls captured in a CUDA graph, replayed 5 times between CUDA events),
an eager loop of 200 calls between CUDA events, and the host's issue time
of one call in that loop. With --sweep it also times, for a checkout that
has K2's launch plan, the kernel under each tile at both N. Prints one JSON
line, and appends it to --out when given. Needs a card and no checkpoint;
imports no JAX.

Usage: python3 tools/port_k2_times.py [--root DIR] [--label NAME] [--out FILE] [--sweep]
Comparing two commits: unpack the other one with `git archive` and run
parent, change, change, parent in one chip call.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import torch

# The crop path's two K2 calls (config.yaml: crop 32, window 256, ViT-B/16).
K2_MAIN = dict(n=1024, swin=256, crop=32, patch=16, d=768)
K2_ONE = dict(K2_MAIN, n=1)
TIME_SEED = 11

# The timing helpers of tools/port_k1_times.py, loaded by path (tools/ is no
# package).
_spec = importlib.util.spec_from_file_location(
    "port_k1_times", os.path.join(os.path.dirname(os.path.abspath(__file__)), "port_k1_times.py"))
_k1 = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_k1)
time_graph, time_eager = _k1.time_graph, _k1.time_eager


def k2_inputs(n, swin, patch, d, dtype, raw, seed, device="cuda"):
    """Window, boxes and weights for one K2 call, made on the CPU from
    `seed`. Box centres span the window and 8 px past it; with n >= 4 the
    first four sit on its corners, so the clamp-to-edge taps are read. raw:
    a 0..255 window with the pixel normalization folded into the weights,
    as the tracker calls it; else a randn window."""
    from vitparticlefiltertracker_tpu_torch.models.vit import VitSpec
    from vitparticlefiltertracker_tpu_torch.runtime.tracker import _norm_folded_embed_weights

    g = torch.Generator(device="cpu").manual_seed(seed)
    window = torch.rand((swin, swin, 3), generator=g) * 255 if raw else torch.randn((swin, swin, 3), generator=g)
    centers = torch.rand((n, 2), generator=g) * (swin + 16) - 8
    if n >= 4:
        centers[:4] = torch.tensor([[0.0, 0.0], [swin - 1.0, 0.0], [0.0, swin - 1.0], [swin - 1.0, swin - 1.0]])
    sizes = 4 + torch.rand((n, 2), generator=g) * (swin / 4)
    kernel = torch.randn((patch * patch * 3, d), generator=g) * 0.02
    bias = torch.randn((d,), generator=g) * 0.1
    if raw:
        kernel, bias = _norm_folded_embed_weights({"patch_embed": {"kernel": kernel, "bias": bias}},
                                                  VitSpec(dim=d, patch_size=patch, dtype=torch.float32))
    return [x.to(device) for x in (window, centers, sizes)] + [x.to(device, dtype) for x in (kernel, bias)]


def timing_inputs(m: dict, device: str = "cuda") -> list[torch.Tensor]:
    """The timed inputs at shape `m` (K2_MAIN or K2_ONE): bf16, raw."""
    return k2_inputs(m["n"], m["swin"], m["patch"], m["d"], torch.bfloat16, True, TIME_SEED, device)


def time_k2(pw, m: dict) -> dict:
    """Device (graph), eager and host times of K2, its plain version and the
    product alone at shape `m`; graph timings interleaved plain, kernel,
    product, kernel, plain, each number the lower of its runs."""
    from vitparticlefiltertracker_tpu_torch.models.vit import patchify
    from vitparticlefiltertracker_tpu_torch.ops.patchify import extract_crops

    window, centers, sizes, kernel, bias = timing_inputs(m)
    args = (window, centers, sizes, m["crop"], m["patch"], kernel, bias)
    tokens = patchify(extract_crops(window, centers, sizes, m["crop"]), m["patch"]).to(torch.bfloat16)
    tokens = tokens.reshape(-1, kernel.shape[0]).contiguous()
    fns = {"plain": lambda: pw.window_gather_patchify_plain(*args),
           "kernel": lambda: pw.gather_patchify_window(*args),
           "product": lambda: torch.addmm(bias, tokens, kernel)}
    dev = {name: [] for name in fns}
    for name in ("plain", "kernel", "product", "kernel", "plain"):
        dev[name].append(time_graph(fns[name]))
    eager, host = zip(*(time_eager(fns["kernel"]) for _ in range(2)))
    return {"kernel_device_ms": min(dev["kernel"]), "kernel_device_runs_ms": dev["kernel"],
            "kernel_eager_ms": min(eager), "kernel_host_us": min(host),
            "plain_device_ms": min(dev["plain"]), "product_device_ms": dev["product"][0]}


def sweep(pw, m: dict) -> list[dict]:
    """The kernel at shape `m` under each tensor-core tile, against the
    plan's own choice."""
    window, centers, sizes, kernel, bias = timing_inputs(m)
    args = (window, centers, sizes, m["crop"], m["patch"], kernel, bias)
    base = pw.launch_plan(*args, num_sms=torch.cuda.get_device_properties(0).multi_processor_count)
    out = torch.empty((m["n"], (m["crop"] // m["patch"]) ** 2, m["d"]), dtype=torch.bfloat16, device="cuda")
    rows = []
    for path in ("wide", "narrow"):
        t = pw.TILES[path]
        row_tiles, col_tiles = -(-base.rows // t["bm"]), -(-m["d"] // t["bn"])
        plan = base._replace(path=path, row_tiles=row_tiles, col_tiles=col_tiles, grid=(row_tiles, col_tiles),
                             smem=pw.smem_bytes(path, m["patch"], 3, m["crop"]))
        ms = time_graph(lambda: pw.launch(plan, *args, out))
        rows.append({"n": m["n"], "path": path, "grid": list(plan.grid), "device_ms": ms,
                     "planned": path == base.path})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("port_k2_times: needs a card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from vitparticlefiltertracker_tpu_torch.ops import patchify_window as pw

    torch.backends.cuda.matmul.allow_tf32 = False
    calls = {}
    for m in (K2_MAIN, K2_ONE):
        calls[f"n{m['n']}"] = row = time_k2(pw, m)
        print(f"  {args.label} K2 N {m['n']}: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in row.items()), flush=True)
    result = {"label": args.label, "root": os.path.abspath(args.root), "calls": calls}
    if args.sweep and hasattr(pw, "launch_plan"):
        result["sweep"] = [r for m in (K2_MAIN, K2_ONE) for r in sweep(pw, m)]
        for r in result["sweep"]:
            print(f"  {args.label} sweep {r}", flush=True)
    result["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                    capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    line = json.dumps(result)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
