#!/usr/bin/env python3
"""The port's mesh across several cards: every path of chip_smoke.py's mesh
phase sharded over the ranks of a torchrun group, each against its
mesh=None twin, which every rank also runs on its own card.

For each case: the records of every rank equal (bit for bit: the ranks
compute the same state from all-gathered scores, so the IF-node predicates
of a step, whose bodies hold collectives, agree), finite, within the
smoke's RMSE bound for that path, and at the first step, where both runs
start from the same state, within TWIN_LIMIT_PX of the twin's positions
(chip_smoke.GRAPH_POS_TOL_PX, the tolerance a captured step holds against
the eager one) and CONF_LIMIT of its confidences: a wrong split (a head
slice, a bias added M times) shows there. Later steps are reported, not
held: a split that only rounds its products otherwise (H / M heads, B / K
banks) starts a few f32 ulps off, and resampling grows that into px of
drift, in f32 as in bf16 (PERF.md §6, PR 15). Beside them: the first step
whose positions differ from the twin's and each step's largest
difference; the collectives issued; both step medians (host clock around each Tracker.step,
after 5 warm-up steps, turns twin, mesh, mesh, twin). The train case runs
configs/train-head.yaml data-parallel over every rank against the whole
batch on one card, each step's loss held to tests/test_training.py's rtol
1e-4 (the weights' largest difference reported: after AdamW's first
updates, whose size does not depend on a gradient's, a gradient near zero
that rounds to the other sign moves its weight by up to the rate). Rank 0 prints one JSON line a case and writes
them to --out as each ends; the exit code is 1 unless every case is ok.

--only picks cases by name ("eval3 (1, 2, 2)", "robust", "train"); --f32
adds, for each picked tracker case that splits products (a "model" or
"bank" axis above 1), the same case with model.dtype float32.

Usage, one process a card (4 cards):
    torchrun --standalone --nproc-per-node 4 tools/port_mesh_check.py --out out/mesh4.jsonl
Rehearsal on the CPU (gloo, tiny configs):
    torchrun --standalone --nproc-per-node 4 tools/port_mesh_check.py --device cpu --tiny
Some cases only, in bf16 and in f32:
    torchrun --standalone --nproc-per-node 4 tools/port_mesh_check.py --only "eval3 (1, 2, 2)" --f32
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import chip_smoke as cs  # noqa: E402
from vitparticlefiltertracker_tpu_torch.config import Config  # noqa: E402
from vitparticlefiltertracker_tpu_torch.io.video import open_source  # noqa: E402
from vitparticlefiltertracker_tpu_torch.models import params as vit_params  # noqa: E402
from vitparticlefiltertracker_tpu_torch.parallel import mesh as pm  # noqa: E402
from vitparticlefiltertracker_tpu_torch.runtime.banked import MultiTracker  # noqa: E402
from vitparticlefiltertracker_tpu_torch.runtime.tracker import Tracker  # noqa: E402
from vitparticlefiltertracker_tpu_torch.training.train import build_train_step, make_data_mesh  # noqa: E402

TWIN_LIMIT_PX = cs.GRAPH_POS_TOL_PX  # mesh against twin, first step: positions
CONF_LIMIT = 1e-2  # and confidences (bf16 rounding of a split's products stays well inside)
LOSS_RTOL = 1e-4  # the data-parallel step's loss against the whole batch's (tests/test_training.py)
TINY_MODEL = {"variant": "custom", "depth": 2, "dim": 64, "heads": 4, "mlp_dim": 128, "image_size": 64,
              "dtype": "float32", "checkpoint": ""}


def cases(world: int, tiny: bool) -> list[dict]:
    """(name, config dict, frames, mesh shape, RMSE bound, banked) for a
    group of `world` ranks: the particle axis over all of them, and "model"
    over 2 (inside "particle" world / 2); eval4's banks over "bank"."""
    def cfg(base, ck, frames, **over):
        d = copy.deepcopy(base)
        d["model"]["checkpoint"] = str(cs.ROOT / ck) if ck else ""
        d["io"]["num_frames"] = frames
        for section, values in over.items():
            d.setdefault(section, {}).update(values)
        if tiny:
            d["model"] = dict(TINY_MODEL)
            d["filter"]["num_particles"] = 64
            d["io"]["frame_size"] = [224, 224]
        return d

    half = max(world // 2, 1)
    eval3_d = cs._bench_evals.config(3).to_dict()  # its random init: no checkpoint
    frames = 6 if tiny else None
    out = [
        ("dense", cfg(cs.SMOKE_CONFIG, cs.CHECKPOINT, frames or cs.FRAMES), (1, world, 1), cs.RMSE_BOUND_PX, False),
        ("dense", cfg(cs.SMOKE_CONFIG, cs.CHECKPOINT, frames or cs.FRAMES), (1, half, 2), cs.RMSE_BOUND_PX, False),
        # Not on "model" > 1: its IF bodies would hold cross-card all-reduces (refused, ROADMAP §3 F6).
        ("robust", cfg(cs.ROBUST_CONFIG, cs.HEAD_CHECKPOINT, frames or 48), (1, world, 1), None, False),
        ("eval3", cfg(eval3_d, "", frames or cs.EVAL3_FRAMES), (1, world, 1), cs.EVAL3_RMSE_BOUND_PX, False),
        ("eval3", cfg(eval3_d, "", frames or cs.EVAL3_FRAMES), (1, half, 2), cs.EVAL3_RMSE_BOUND_PX, False),
        ("eval4", cfg(cs.BANKED_CONFIG, cs.CHECKPOINT, frames or 48), (world, 1, 1), cs.BANKED_RMSE_BOUND_PX, True),
        ("eval4", cfg(cs.BANKED_CONFIG, cs.CHECKPOINT, frames or 48), (half, 2, 1), cs.BANKED_RMSE_BOUND_PX, True),
    ]
    if tiny:  # the tiny model on its own clips: the trajectories are not the checkpoint's
        out = [(n, d, s, None, b) for n, d, s, _, b in out]
        for _, d, _, _, b in out:
            if b:
                d["runtime"]["banks"] = 2 * world
                d["io"]["source"] = f"synthetic:multi-{2 * world}"
    return [dict(name=n, cfg=d, shape=s, bound=b, banked=k) for n, d, s, b, k in out]


def run_case(case: dict, device) -> dict:
    """The case's twin and mesh runs in turns on this rank -> summary."""
    cfg = Config.from_dict(copy.deepcopy(case["cfg"]))
    src = open_source(cfg.io.source, cfg.io.num_frames, tuple(cfg.io.frame_size), seed=cfg.filter.seed)
    prm = Tracker(cfg, device=device).vit_params  # the weights as a tracker resolves them (head trunks regenerated)
    mesh = pm.make_mesh(*case["shape"], device=device)
    runs = []
    for kind in ("twin", "mesh", "mesh", "twin"):
        m = mesh if kind == "mesh" else None
        tracker = (MultiTracker(cfg, vit_params=prm, device=device, mesh=m) if case["banked"]
                   else Tracker(cfg, vit_params=prm, device=device, mesh=m))
        cs.reset_counts()
        tracker.init(src.frames[0], src.init_bbox)
        recs = [tracker.step(f) for f in src.frames[1:]]
        recs = [cs.merge_banks(r) for r in recs] if case["banked"] else recs
        runs.append({"kind": kind, "recs": recs, **cs.read_counts()})
    pos = {kind: np.array([r["position"] for r in run["recs"]]) for kind, run in (("twin", runs[0]), ("mesh", runs[1]))}
    conf = {kind: np.array([r["conf"] for r in run["recs"]], np.float64) for kind, run in (("twin", runs[0]),
                                                                                          ("mesh", runs[1]))}
    by_step = np.abs(pos["mesh"] - pos["twin"]).reshape(len(pos["mesh"]), -1).max(axis=1)
    moved = np.flatnonzero(by_step > 0)
    flags = {kind: [(r["lost"], r["resampled"]) for r in run["recs"]] for kind, run in (("twin", runs[0]),
                                                                                       ("mesh", runs[1]))}
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, pos["mesh"].tolist())
    truth = src.truth[1:]
    err = np.linalg.norm(pos["mesh"].reshape(len(truth), -1, 2) - truth.reshape(len(truth), -1, 2), axis=-1)
    rmse = float(np.sqrt(np.mean(err**2)))
    med = [statistics.median(r["recs"][i]["step_ms"] for i in range(min(5, len(r["recs"]) - 1), len(r["recs"])))
           for r in runs]
    out = {"case": case["name"], "mesh": list(case["shape"]), "ranks_agree": all(e == everyone[0] for e in everyone),
           "finite": bool(np.isfinite(pos["mesh"]).all()), "rmse_px": rmse, "rmse_bound_px": case["bound"],
           "twins_equal": bool(np.array_equal(pos["twin"], [r["position"] for r in runs[3]["recs"]])),
           "first_step_pos_diff_px": float(by_step[0]), "twin_limit_px": TWIN_LIMIT_PX,
           "first_step_conf_diff": float(np.abs(conf["mesh"][0] - conf["twin"][0]).max()), "conf_limit": CONF_LIMIT,
           "max_pos_diff_from_twin_px": float(by_step.max()),
           "first_step_off_twin": int(moved[0]) + 1 if moved.size else None,
           "pos_diff_by_step_px": [float(x) for x in by_step],
           "flags_equal_twin": flags["mesh"] == flags["twin"], "all_gathers": runs[1]["all_gathers"],
           "all_reduces": runs[1]["all_reduces"], "k1_shapes": {str(k): v for k, v in runs[1]["k1_shapes"].items()},
           "step_ms_twin": statistics.median([med[0], med[3]]), "step_ms_mesh": statistics.median(med[1:3]),
           "turn_medians_ms": med}
    out["ok"] = (out["ranks_agree"] and out["finite"] and (case["bound"] is None or rmse <= case["bound"])
                 and out["first_step_pos_diff_px"] <= TWIN_LIMIT_PX and out["first_step_conf_diff"] <= CONF_LIMIT)
    return out


def run_train(world: int, device, tiny: bool) -> dict:
    """configs/train-head.yaml (tiny: tests/test_training.py's config)
    data-parallel over the group for 3 steps against the whole batch on
    this rank's card: losses, the largest weight difference, the ranks'
    weights bit for bit equal, the step medians."""
    d = copy.deepcopy(cs.TINY_TRAIN if tiny else cs.TRAIN_HEAD_CONFIG)
    d["train"].update(checkpoint_out="", metrics_out="", batch_size=2 * world if tiny else 32)
    cfg = Config.from_dict(d)
    out = {}
    for kind in ("twin", "mesh"):
        init_fn, step_fn = build_train_step(cfg, device, mesh=make_data_mesh(world, device) if kind == "mesh" else None)
        params, opt = init_fn()
        losses, ms = [], []
        for i in range(3):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2)) if device.type == "cuda" else (None,
                                                                                                                None)
            if start is not None:
                start.record()
            params, opt, metrics = step_fn(params, opt, i)
            if end is not None:
                end.record()
                end.synchronize()
                ms.append(start.elapsed_time(end))
            losses.append(float(metrics["loss"]))
        out[kind] = (losses, {k: v.detach().float().cpu() for k, v in vit_params._flatten(params).items()}, ms)
        del params, opt
    (lt, wt, mt), (lm, wm, mm) = out["twin"], out["mesh"]
    sums = [None] * dist.get_world_size()
    dist.all_gather_object(sums, [float(v.double().sum()) for v in wm.values()])
    out = {"case": "train-head" if not tiny else "train-tiny", "mesh": [world], "losses_mesh": lm, "losses_twin": lt,
            "max_loss_rel_diff": max(abs(a - b) / abs(b) for a, b in zip(lm, lt)),
            "max_weight_diff": max(float((wm[k] - wt[k]).abs().max()) for k in wt),
            "ranks_agree": all(s == sums[0] for s in sums), "step_ms_twin": mt[-1] if mt else None,
            "step_ms_mesh": mm[-1] if mm else None, "loss_rtol": LOSS_RTOL}
    out["ok"] = out["ranks_agree"] and out["max_loss_rel_diff"] <= LOSS_RTOL
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true", help="tiny configs (a CPU rehearsal)")
    ap.add_argument("--out", default="")
    ap.add_argument("--only", nargs="*", default=None, help='case names, e.g. "eval3 (1, 2, 2)" "robust" "train"')
    ap.add_argument("--f32", action="store_true", help="also each picked case that splits products, in float32")
    args = ap.parse_args()
    pm.init_distributed(args.device)
    device = torch.device("cuda", torch.cuda.current_device()) if args.device == "cuda" else torch.device("cpu")
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    world, rank = dist.get_world_size(), dist.get_rank()
    if rank == 0 and device.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip().splitlines()
        print(f"cards: {smi}; torch {torch.__version__}, NCCL {torch.cuda.nccl.version()}", flush=True)
    picked = []
    for case in [*cases(world, args.tiny), None]:
        name = "train" if case is None else f"{case['name']} {case['shape']}"
        if args.only is not None and not any(name == o or name.split(" (")[0] == o for o in args.only):
            continue
        picked.append((name, case))
        if args.f32 and case is not None and (case["shape"][0] > 1 or case["shape"][2] > 1):
            f32 = dict(case, name=f"{case['name']} f32", cfg=copy.deepcopy(case["cfg"]))
            f32["cfg"]["model"]["dtype"] = "float32"
            picked.append((f"{f32['name']} {case['shape']}", f32))
    results = []
    out_f = None
    if rank == 0 and args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        out_f = open(args.out, "w")
    for name, case in picked:
        try:  # every rank fails a case together (a capture, a check), so the next one still runs
            results.append(run_train(world, device, args.tiny) if case is None else run_case(case, device))
        except Exception as e:  # noqa: BLE001 - the tool records the failure and goes on to the next case
            results.append({"case": name, "ok": False, "error": repr(e)[:300]})
        if rank == 0:
            print(json.dumps(results[-1]), flush=True)
        if out_f:  # a line a case as it ends: a run cut at its time limit keeps what it finished
            out_f.write(json.dumps(results[-1]) + "\n")
            out_f.flush()
    if out_f:
        out_f.close()
    # No destroy_process_group: on 4 cards it hung once the step graphs had
    # captured NCCL collectives (ROADMAP §3, F6); the process exits without it.
    return 0 if all(r["ok"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
