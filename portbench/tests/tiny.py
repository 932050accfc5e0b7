"""A tiny copy of the benchmark for the CPU tests: the real metric readers
and model families, a two-block ViT at width 192 on 64-px windows, 256 particles, 120x160
occlusion clips, in a directory laid out as the checkout is."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
DIMS = {"depth": 2, "dim": 192, "heads": 3, "mlp_dim": 768, "patch_size": 16, "image_size": 64}


def make(tmp: Path, feeds: int = 2, loop: str = "closed", cell: str = "tiny-cell",
         limits_from: str = "b16-serve16-480p", lost_gate: bool = True) -> Path:
    """-> the tiny benchmark's folder (tmp/portbench, BENCHMARK.json beside it);
    lost_gate False turns the lost gate off (the tiny random ViT loses the
    target often, and a lost step's position is not compared)."""
    bd = tmp / "portbench"
    shutil.copytree(BENCH / "metrics", bd / "metrics")
    shutil.copytree(BENCH / "families", bd / "families")
    for d in ("configs", "workloads", "traffic"):
        (bd / d).mkdir(parents=True)
    cfg = json.loads((BENCH / "configs" / "vitb16-dense-1k.json").read_text())
    cfg["name"], cfg["dims"] = "tiny-config", DIMS
    cfg["tracker_config"]["model"].update(variant="custom", dtype="float32", **DIMS)
    cfg["tracker_config"]["filter"]["num_particles"] = 256
    if not lost_gate:
        cfg["tracker_config"]["filter"]["lost_conf_ratio"] = 0.0
    (bd / "configs" / "tiny-config.json").write_text(json.dumps(cfg))
    traffic = {"feeds": feeds, "frame_size": [120, 160], "scene": "occlusion", "clip_frames": 30, "clip_pool": 2,
               "loop": loop, "rate_fps": 30, "warmup_s": 0.3}
    (bd / "traffic" / "tiny-mix.json").write_text(json.dumps(traffic))
    wl = json.loads((BENCH / "workloads" / f"{limits_from}.json").read_text())
    wl.update(config="tiny-config", traffic="tiny-mix", trace_dispatches=5)
    wl["audit"].update(bursts=3, per_burst=12, gap_s=0.004, min_steps=2)
    (bd / "workloads" / f"{cell}.json").write_text(json.dumps(wl))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [cell]
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return bd
