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

Beside the trackers: "crop" on the particle axis (K2 on a rank's N / P
boxes); "streams" (MultiStreamTracker.step_packed, a stream a rank on
"bank"); "chunk" (Tracker.step_chunk_device on fixed ROI chunks, on
"particle"); "stream" and "serve" (runtime/streaming.py stream_track: rank
0 reads the source and records, the other ranks follow its dispatches;
dense on "particle", serve's four streams on "bank") and "eval5 stream"
(the eval5 ROI chunks from the native ring at 4K, ViT-L/16, on "particle":
its origins follow the steering's timing, so only its first record and its
RMSE are held); the commands "track", "bench" and "train" through cli.main
on every rank (the process group torchrun made); and "peer": the peer
all-reduce kernel (ops/peer_allreduce.py) against NCCL's all_reduce over
groups of 2 and of every rank, at the B/16, L/16 and scan shapes, each as
a CUDA graph of calls (device ms a call).

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
import contextlib
import copy
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import chip_smoke as cs  # noqa: E402
from vitparticlefiltertracker_tpu_torch import cli  # noqa: E402
from vitparticlefiltertracker_tpu_torch.config import Config  # noqa: E402
from vitparticlefiltertracker_tpu_torch.io.video import open_source  # noqa: E402
from vitparticlefiltertracker_tpu_torch.models import params as vit_params  # noqa: E402
from vitparticlefiltertracker_tpu_torch.ops import peer_allreduce as par  # noqa: E402
from vitparticlefiltertracker_tpu_torch.ops.image import FrameView, StreamFrame  # noqa: E402
from vitparticlefiltertracker_tpu_torch.parallel import mesh as pm  # noqa: E402
from vitparticlefiltertracker_tpu_torch.runtime.banked import MultiStreamTracker, MultiTracker  # noqa: E402
from vitparticlefiltertracker_tpu_torch.runtime.streaming import stream_track  # noqa: E402
from vitparticlefiltertracker_tpu_torch.runtime.tracker import Tracker  # noqa: E402
from vitparticlefiltertracker_tpu_torch.training.train import build_train_step, make_data_mesh  # noqa: E402

TWIN_LIMIT_PX = cs.GRAPH_POS_TOL_PX  # mesh against twin, first step: positions
CONF_LIMIT = 1e-2  # and confidences (bf16 rounding of a split's products stays well inside)
LOSS_RTOL = 1e-4  # the data-parallel step's loss against the whole batch's (tests/test_training.py)
TINY_MODEL = {"variant": "custom", "depth": 2, "dim": 64, "heads": 4, "mlp_dim": 128, "image_size": 64,
              "dtype": "float32", "checkpoint": ""}


def cases(world: int, tiny: bool) -> list[dict]:
    """(name, config dict, mesh shape, RMSE bound, kind) for a group of
    `world` ranks: the particle axis over all of them, and "model" over 2
    (inside "particle" world / 2); eval4's banks and the streams over
    "bank". kind: "track" (Tracker), "banked" (MultiTracker), "streams"
    (MultiStreamTracker), "chunk" (step_chunk_device), "stream" / "serve"
    (stream_track), "command" (cli.main)."""
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
    dense = cfg(cs.SMOKE_CONFIG, cs.CHECKPOINT, frames or cs.FRAMES)
    robust = cfg(cs.ROBUST_CONFIG, cs.HEAD_CHECKPOINT, frames or 48)
    eval5 = cfg(cs.EVAL5_CONFIG, "", frames or 60)
    if tiny:
        eval5["io"]["frame_size"] = [480, 640]
        eval5["runtime"].update(stream_roi=256, stream_roi_out=128)
    out = [
        ("dense", dense, (1, world, 1), cs.RMSE_BOUND_PX, "track"),
        ("dense", dense, (1, half, 2), cs.RMSE_BOUND_PX, "track"),
        # "model" above 1 puts the peer kernel in the probe's and the scan's IF-node bodies.
        ("robust", robust, (1, world, 1), None, "track"),
        ("robust", robust, (1, half, 2), None, "track"),
        ("robust", robust, (1, 1, 2), None, "track"),
        ("crop", cfg(cs.SMOKE_CONFIG, cs.CHECKPOINT, frames or cs.FRAMES, tracker=cs.CROP_OVERRIDES), (1, world, 1),
         cs.CROP_RMSE_BOUND_PX, "track"),
        ("eval3", cfg(eval3_d, "", frames or cs.EVAL3_FRAMES), (1, world, 1), cs.EVAL3_RMSE_BOUND_PX, "track"),
        ("eval3", cfg(eval3_d, "", frames or cs.EVAL3_FRAMES), (1, half, 2), cs.EVAL3_RMSE_BOUND_PX, "track"),
        ("eval4", cfg(cs.BANKED_CONFIG, cs.CHECKPOINT, frames or 48), (world, 1, 1), cs.BANKED_RMSE_BOUND_PX, "banked"),
        ("eval4", cfg(cs.BANKED_CONFIG, cs.CHECKPOINT, frames or 48), (half, 2, 1), cs.BANKED_RMSE_BOUND_PX, "banked"),
        ("streams", dense, (world, 1, 1), None, "streams"),
        ("chunk", dense, (1, world, 1), None, "chunk"),
        ("stream", dense, (1, world, 1), cs.RMSE_BOUND_PX, "stream"),
        ("serve", dense, (world, 1, 1), None, "serve"),
        ("eval5 stream", eval5, (1, world, 1), cs.EVAL5_RMSE_BOUND_PX, "stream"),
        ("track command", dense, (1, world, 1), cs.RMSE_BOUND_PX, "command"),
        ("bench command", dense, (1, world, 1), None, "command"),
        ("train command", copy.deepcopy(cs.TINY_TRAIN if tiny else cs.TRAIN_HEAD_CONFIG), (world, 1, 1), None,
         "command"),
    ]
    train = out[-1][1]["train"]
    train.update(steps=4, eval_every=0, log_every=2, batch_size=2 * world if tiny else 32)
    if tiny:  # the tiny model on its own clips: the trajectories are not the checkpoint's
        out = [(n, d, s, None, k) for n, d, s, _, k in out]
        for _, d, _, _, k in out:
            if k == "banked":
                d["runtime"]["banks"] = 2 * world
                d["io"]["source"] = f"synthetic:multi-{2 * world}"
    return [dict(name=n, cfg=d, shape=s, bound=b, kind=k) for n, d, s, b, k in out]


def _twin_compare(out: dict, pos: dict, conf: dict, case: dict, truth) -> dict:
    """The mesh run's positions [T, ...] and confidences against its
    twin's: the first step's differences, the largest, the first step off;
    the RMSE against `truth`; ok as the module's docstring says."""
    by_step = np.abs(pos["mesh"] - pos["twin"]).reshape(len(pos["mesh"]), -1).max(axis=1)
    moved = np.flatnonzero(by_step > 0)
    err = np.linalg.norm(pos["mesh"].reshape(len(truth), -1, 2) - truth.reshape(len(truth), -1, 2), axis=-1)
    rmse = float(np.sqrt(np.mean(err**2)))
    out.update({"finite": bool(np.isfinite(pos["mesh"]).all()), "rmse_px": rmse, "rmse_bound_px": case["bound"],
                "first_step_pos_diff_px": float(by_step[0]), "twin_limit_px": TWIN_LIMIT_PX,
                "first_step_conf_diff": float(np.abs(conf["mesh"][0] - conf["twin"][0]).max()),
                "conf_limit": CONF_LIMIT, "max_pos_diff_from_twin_px": float(by_step.max()),
                "first_step_off_twin": int(moved[0]) + 1 if moved.size else None,
                "pos_diff_by_step_px": [float(x) for x in by_step]})
    out["ok"] = (out["ranks_agree"] and out["finite"] and (case["bound"] is None or rmse <= case["bound"])
                 and out["first_step_pos_diff_px"] <= TWIN_LIMIT_PX and out["first_step_conf_diff"] <= CONF_LIMIT)
    return out


def _agree(value, mesh=None) -> bool:
    """Whether every rank of the mesh (of the group without one) passed the
    same `value`."""
    group = mesh.all_group if mesh is not None else None
    everyone = [None] * dist.get_world_size(group)
    dist.all_gather_object(everyone, value, group=group)
    return all(e == everyone[0] for e in everyone)


def _mesh_or_none(shape, device):
    """make_mesh(*shape), or None on a rank outside a mesh smaller than the
    group (it joins the build, whose groups every rank creates)."""
    if dist.get_rank() < math.prod(shape):
        return pm.make_mesh(*shape, device=device)
    try:
        pm.make_mesh(*shape, device=device)
    except ValueError:
        return None
    raise AssertionError("a rank outside the mesh was given a place in it")


def _outside(case: dict) -> dict:
    return {"case": case["name"], "mesh": list(case["shape"]), "outside_the_mesh": dist.get_rank(), "ok": True}


def _stream_clips(cfg: Config, k: int):
    """K clips of the config's source (seeds filter.seed + i) -> frames
    [T, K, H, W, 3], truth [T - 1, K, 2], boxes [K, 4]."""
    srcs = [open_source(cfg.io.source, cfg.io.num_frames, tuple(cfg.io.frame_size), seed=cfg.filter.seed + i)
            for i in range(k)]
    return (np.stack([np.stack(x.frames) for x in srcs], axis=1), np.stack([x.truth[1:] for x in srcs], axis=1),
            np.stack([x.init_bbox for x in srcs]).astype(np.float32))


def _chunks(frames: np.ndarray, truth: np.ndarray, c: int = 4, side: int = 320):
    """Fixed ROI chunks of c frames: side-px views around each chunk's mean
    truth, one decimated global view of the chunk's first frame each."""
    h, w = frames.shape[1:3]
    out = []
    for i in range(1, len(frames) - c + 1, c):
        ctr = truth[i - 1:i - 1 + c].mean(axis=0)
        ox, oy = (int(np.clip(ctr[j] - side / 2, 0, (w, h)[j] - side)) for j in (0, 1))
        track = FrameView(torch.from_numpy(np.ascontiguousarray(frames[i:i + c, oy:oy + side, ox:ox + side])),
                          torch.from_numpy(np.tile([ox, oy], (c, 1)).astype(np.float32)), 1.0)
        glob = FrameView(torch.from_numpy(np.ascontiguousarray(frames[i, ::8, ::8])), torch.zeros(2), 8.0)
        out.append(StreamFrame(track, glob))
    return out


def run_case(case: dict, device) -> dict:
    """The case's twin and mesh runs in turns on this rank -> summary."""
    if case["kind"] in ("stream", "serve"):
        return run_stream_case(case, device)
    if case["kind"] == "command":
        return run_command_case(case, device)
    cfg = Config.from_dict(copy.deepcopy(case["cfg"]))
    kind = case["kind"]
    k = cs.STREAMS if kind == "streams" else 0
    if k:
        clips, truth, boxes = _stream_clips(cfg, k)
        clips_dev = torch.from_numpy(clips).to(device)
    else:
        src = open_source(cfg.io.source, cfg.io.num_frames, tuple(cfg.io.frame_size), seed=cfg.filter.seed)
        truth = src.truth[1:]
    prm = Tracker(cfg, device=device).vit_params  # the weights as a tracker resolves them (head trunks regenerated)
    mesh = _mesh_or_none(case["shape"], device)
    if mesh is None:
        return _outside(case)
    chunks = _chunks(np.stack(src.frames), src.truth) if kind == "chunk" else None
    if chunks:
        truth = np.concatenate([src.truth[1 + 4 * i:5 + 4 * i] for i in range(len(chunks))])
    runs = []
    for turn in ("twin", "mesh", "mesh", "twin"):
        m = mesh if turn == "mesh" else None
        cs.reset_counts()
        if kind == "streams":
            tracker = MultiStreamTracker(cfg, k, vit_params=prm, device=device, mesh=m)
            tracker.init(clips[0], boxes)
            recs = []
            for t in range(1, len(clips)):
                row = tracker.step_packed(clips_dev[t]).cpu().numpy()
                recs.append({"position": row[:2 * k].reshape(k, 2).tolist(), "conf": row[6 * k:7 * k].tolist(),
                             "lost": row[9 * k:].tolist(), "resampled": row[8 * k:9 * k].tolist(), "step_ms": 0.0})
        elif kind == "chunk":
            tracker = Tracker(cfg, vit_params=prm, device=device, mesh=m)
            tracker.init(src.frames[0], src.init_bbox)
            recs = []
            for chunk in chunks:
                out = tracker.step_chunk_device(chunk)
                for j in range(out.position.shape[0]):
                    recs.append({"position": out.position[j].tolist(), "conf": float(out.conf[j]),
                                 "lost": bool(out.lost[j]), "resampled": bool(out.resampled[j]), "step_ms": 0.0})
        else:
            tracker = (MultiTracker(cfg, vit_params=prm, device=device, mesh=m) if kind == "banked"
                       else Tracker(cfg, vit_params=prm, device=device, mesh=m))
            tracker.init(src.frames[0], src.init_bbox)
            recs = [tracker.step(f) for f in src.frames[1:]]
            recs = [cs.merge_banks(r) for r in recs] if kind == "banked" else recs
        runs.append({"kind": turn, "recs": recs, **cs.read_counts()})
    pos = {turn: np.array([r["position"] for r in run["recs"]]) for turn, run in (("twin", runs[0]), ("mesh", runs[1]))}
    conf = {turn: np.array([r["conf"] for r in run["recs"]], np.float64) for turn, run in (("twin", runs[0]),
                                                                                         ("mesh", runs[1]))}
    flags = {turn: [(r["lost"], r["resampled"]) for r in run["recs"]] for turn, run in (("twin", runs[0]),
                                                                                      ("mesh", runs[1]))}
    med = [statistics.median(r["recs"][i]["step_ms"] for i in range(min(5, len(r["recs"]) - 1), len(r["recs"])))
           for r in runs]
    out = {"case": case["name"], "mesh": list(case["shape"]), "ranks_agree": _agree(pos["mesh"].tolist(), mesh),
           "twins_equal": bool(np.array_equal(pos["twin"], [r["position"] for r in runs[3]["recs"]])),
           "flags_equal_twin": flags["mesh"] == flags["twin"], "all_gathers": runs[1]["all_gathers"],
           "peer_launches": runs[1]["peer_launches"],
           "peer_shapes": {str(k): v for k, v in runs[1]["peer_shapes"].items()},
           "k1_shapes": {str(k): v for k, v in runs[1]["k1_shapes"].items()},
           "k2_sizes": {str(k): v for k, v in runs[1]["k2_sizes"].items()},
           "step_ms_twin": statistics.median([med[0], med[3]]), "step_ms_mesh": statistics.median(med[1:3]),
           "turn_medians_ms": med}
    return _twin_compare(out, pos, conf, case, truth)


def run_stream_case(case: dict, device) -> dict:
    """stream_track without a mesh on every rank (each reads its own copy
    of the source), then on the mesh: rank 0 reads and records, the others
    follow. Rank 0's records against its twin's; every rank's dispatches
    equal. A ROI stream (eval5) steers on the rows it reads back, so its
    origins, and the records after the first chunk, follow the timing."""
    cfg = Config.from_dict(copy.deepcopy(case["cfg"]))
    serve = case["kind"] == "serve"
    k = cs.STREAMS if serve else 0
    prm = Tracker(cfg, device=device).vit_params
    mesh = _mesh_or_none(case["shape"], device)
    if mesh is None:
        return _outside(case)
    kw = {} if serve else cli.stream_kwargs(cfg)
    runs = {}
    for turn in ("twin", "mesh"):
        m = mesh if turn == "mesh" else None
        leader = m is None or dist.get_rank() == 0
        if serve:
            tracker = MultiStreamTracker(cfg, k, vit_params=prm, device=device, mesh=m)
            clips, truth, boxes = _stream_clips(cfg, k) if leader else (None, None, None)
            source, bbox = (iter(clips) if leader else None), boxes
        else:
            tracker = Tracker(cfg, vit_params=prm, device=device, mesh=m)
            src = open_source(cfg.io.source, cfg.io.num_frames, tuple(cfg.io.frame_size), seed=cfg.filter.seed)
            truth = src.truth[1:]
            source, bbox = (src if leader else None), (src.init_bbox if leader else None)
            if not leader and hasattr(src, "close"):
                src.close()
        recs = []
        cs.reset_counts()
        stats = stream_track(tracker, source, bbox, on_record=recs.append if leader else None, **kw)
        runs[turn] = {"recs": recs, "stats": stats, "truth": truth, **cs.read_counts()}
    twin, mine = runs["twin"], runs["mesh"]
    out = {"case": case["name"], "mesh": list(case["shape"]),
           "ranks_agree": _agree([mine["stats"]["frames"], sorted(mine["stats"]["dispatches"].items())], mesh),
           "dispatches": {str(k): v for k, v in mine["stats"]["dispatches"].items()},
           "frames": mine["stats"]["frames"], "peer_launches": mine["peer_launches"],
           "all_gathers": mine["all_gathers"], "fps_twin": twin["stats"].get("fps"),
           "fps_mesh": mine["stats"].get("fps")}
    if dist.get_rank() != 0:
        out["ok"] = out["ranks_agree"]
        return out
    pos = {turn: np.array([r["position"] for r in runs[turn]["recs"]]) for turn in runs}
    conf = {turn: np.array([r["conf"] for r in runs[turn]["recs"]], np.float64) for turn in runs}
    truth = twin["truth"]
    out["records"] = len(mine["recs"])
    out["ranks_agree"] = out["ranks_agree"] and len(mine["recs"]) == len(twin["recs"])
    return _twin_compare(out, pos, conf, case, truth)


def run_command_case(case: dict, device) -> dict:
    """cli.main on every rank (the torchrun group), on the mesh's axes set
    through runtime.mesh_*: "track command" (rank 0 reads the source and
    writes the records; against a mesh=None Tracker.run on rank 0),
    "bench command" (rank 0 prints one JSON line), "train command"
    (data-parallel over every rank; rank 0 alone writes the checkpoint)."""
    cfg_d = copy.deepcopy(case["cfg"])
    rank = dist.get_rank()
    with tempfile.TemporaryDirectory() as tmp:
        if "train" in cfg_d:
            cfg_d["train"].update(checkpoint_out=os.path.join(tmp, f"head{rank}.npz"), metrics_out="")
        else:
            cfg_d.setdefault("runtime", {}).update(mesh_banks=case["shape"][0], mesh_particles=case["shape"][1],
                                                   mesh_model=case["shape"][2])
            cfg_d["io"]["output"] = os.path.join(tmp, "out.jsonl")
        path = os.path.join(tmp, "cfg.json")
        with open(path, "w") as f:
            json.dump(cfg_d, f)
        argv = [case["name"].split()[0], "--config", path, "--device", device.type, "--quiet"]
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rc = cli.main(argv)
        out = {"case": case["name"], "mesh": list(case["shape"]), "rc": rc, "ranks_agree": _agree(rc)}
        if "train" in cfg_d:
            written = sorted(f for f in os.listdir(tmp) if f.endswith(".npz"))
            out.update(checkpoints=written, ranks_agree=_agree(rc) and _agree(len(written) == (rank == 0)))
            out["ok"] = rc == 0 and out["ranks_agree"] and written == (["head0.npz"] if rank == 0 else [])
            return out
        if rank != 0:
            out["ok"] = rc == 0 and out["ranks_agree"]
            return out
        if case["name"].startswith("bench"):
            lines = [json.loads(x) for x in printed.getvalue().splitlines() if x.startswith("{")]
            out.update(lines=len(lines), fps=lines[0].get("fps") if lines else None)
            out["ok"] = rc == 0 and out["ranks_agree"] and len(lines) == 1
            return out
        recs = [json.loads(x) for x in open(cfg_d["io"]["output"])]
    cfg = Config.from_dict(copy.deepcopy(case["cfg"]))
    src = open_source(cfg.io.source, cfg.io.num_frames, tuple(cfg.io.frame_size), seed=cfg.filter.seed)
    twin = list(Tracker(cfg, device=device).run(src))
    pos = {"mesh": np.array([r["position"] for r in recs]), "twin": np.array([r["position"] for r in twin])}
    conf = {"mesh": np.array([r["conf"] for r in recs]), "twin": np.array([r["conf"] for r in twin])}
    out["records"] = len(recs)
    out["ranks_agree"] = out["ranks_agree"] and len(recs) == len(twin)
    return _twin_compare(out, pos, conf, case, src.truth[1:])


# The peer case's shapes beyond chip_smoke.PEER_SHAPES: batches between a B 1
# forward and the scan's B 49, where the two forms cross (peer_form's
# TWO_SHOT_MIN_ELEMENTS comes from these rows).
PEER_SWEEP_SHAPES = [(2, 196, 768), (4, 196, 768), (8, 196, 768), (16, 196, 768)]


def run_peer(world: int, device, tiny: bool) -> dict:
    """The peer all-reduce kernel, in both forms (one-shot, two-shot),
    against NCCL's all_reduce over "model" groups of 2 (make_mesh(1, world
    / 2, 2)) and of every rank (1, 1, world), at PEER_SHAPES and
    PEER_SWEEP_SHAPES: f32 partials into bf16 with the bias, each a CUDA
    graph of calls replayed between CUDA events (device ms a call); each
    form's sums against the plain version on the gathered partials
    (bitwise) and the ranks' sums equal; the form peer_form picks; the
    bound of each form: the bytes a rank reads over NVLink (450 GB/s each
    way a card): (m - 1) partials (one-shot), (m - 1) / m of a partial and
    of the output (two-shot)."""
    out = {"case": "peer", "rows": [], "ok": True}
    shapes = [(1, 8, 64), (4, 16, 64)] if tiny else cs.PEER_SHAPES + PEER_SWEEP_SHAPES
    for m in sorted({2, world}):
        mesh = pm.make_mesh(1, world // m, m, device=device)
        group, me = mesh.peers, mesh.coords["model"]
        for i, shape in enumerate(shapes):
            parts, bias = cs.peer_inputs(shape, m, seed=20 + i)
            x, b, all_parts = parts[me].to(device), bias.to(device), parts.to(device)
            n = math.prod(shape)
            picked = par.peer_form(n, m, torch.float32)
            want = par.peer_all_reduce_plain(all_parts, b).float()
            nccl = x.clone()
            saved = cs.step_graph.read_counts()
            nccl_ms = cs.time_graph(lambda: dist.all_reduce(nccl, group=mesh.groups["model"]), iters=50, reps=5)
            for form in (par.ONE_SHOT, par.TWO_SHOT):
                got = par.peer_all_reduce(x, b, group, form=form)
                err = float((got.float() - want).abs().max())
                ms = cs.time_graph(lambda: par.peer_all_reduce(x, b, group, form=form), iters=50, reps=5)
                peer_bytes = (m - 1) * n * 4 if form == par.ONE_SHOT else (m - 1) * n * (4 + 2) / m
                row = {"group": m, "shape": list(shape), "form": form, "picked": form == picked, "ms": ms,
                       "nccl_ms": nccl_ms, "bound_ms": peer_bytes / 450e9 * 1e3, "bound_by": "bytes (NVLink)",
                       "max_abs_err": err, "ranks_agree": _agree(got.float().cpu().tolist(), mesh)}
                out["rows"].append(row)
                out["ok"] = out["ok"] and err == 0.0 and row["ranks_agree"]
            cs.step_graph.restore_counts(saved)
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
    for case in [*cases(world, args.tiny), "peer", None]:
        if case == "peer":  # the kernel runs on the card only
            if device.type == "cuda" and (args.only is None or "peer" in args.only):
                picked.append(("peer", "peer"))
            continue
        name = "train" if case is None else f"{case['name']} {case['shape']}"
        if args.only is not None and not any(name == o or name.split(" (")[0] == o for o in args.only):
            continue
        picked.append((name, case))
        if (args.f32 and case is not None and case["kind"] in ("track", "banked")
                and (case["shape"][0] > 1 or case["shape"][2] > 1)):
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
            if case is None:
                results.append(run_train(world, device, args.tiny))
            elif case == "peer":
                results.append(run_peer(world, device, args.tiny))
            else:
                results.append(run_case(case, device))
        except Exception as e:  # noqa: BLE001 - the tool records the failure and goes on to the next case
            results.append({"case": name, "ok": False, "error": repr(e)[:300]})
        if rank == 0:
            print(json.dumps(results[-1]), flush=True)
        if out_f:  # a line a case as it ends: a run cut at its time limit keeps what it finished
            out_f.write(json.dumps(results[-1]) + "\n")
            out_f.flush()
    if out_f:
        out_f.close()
    dist.destroy_process_group()
    return 0 if all(r["ok"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
