"""Rank processes for the port's mesh tests (tests/test_torch_mesh*.py).

``spawn`` starts `world` processes with torch.multiprocessing's spawn
method, joins them in one gloo process group over a file store and runs a
function of this module in each; the tests compare what the ranks return
with the unsharded port (run in the test process through the same
functions, with no mesh) and with the JAX package. This module imports torch
and the port only: the spawned processes import it, and never JAX.

Every rank runs the same scenarios in the same order, each making its own
mesh (``new_group`` is a collective of every rank).
"""

from __future__ import annotations

import contextlib
import copy
import os
import queue
import tempfile
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from vitparticlefiltertracker_tpu_torch import bridge
from vitparticlefiltertracker_tpu_torch.config import Config
from vitparticlefiltertracker_tpu_torch.filters.particle import StepNoise
from vitparticlefiltertracker_tpu_torch.models.vit import VitSpec
from vitparticlefiltertracker_tpu_torch.parallel.mesh import bank_slice, make_mesh, vit_param_shard
from vitparticlefiltertracker_tpu_torch.runtime.step_graph import state_leaves
from vitparticlefiltertracker_tpu_torch.runtime.tracker import build_tracker_fns, pack_track_output

RANK_TIMEOUT_S = 400  # a rank's result, at most (a collective left unmatched times out at 300 s)


def spawn(world: int, fn, *args) -> list:
    """fn(rank, *args) on `world` spawned ranks of one gloo group -> the
    ranks' return values, in rank order. A rank that raises fails the call
    with its traceback; the others are then stopped."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store = os.path.join(tempfile.mkdtemp(prefix="vpt_mesh_test_"), "store")
    procs = [ctx.Process(target=_rank_main, args=(r, world, store, results, fn, args)) for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(world):
            try:
                rank, ok, value = results.get(timeout=RANK_TIMEOUT_S)
            except queue.Empty:
                raise RuntimeError(f"ranks {sorted(set(range(world)) - set(got))} returned nothing in "
                                   f"{RANK_TIMEOUT_S} s") from None
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            got[rank] = value
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(world)]


def _rank_main(rank, world, store, results, fn, args) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                                timeout=timedelta(seconds=300))
        results.put((rank, True, fn(rank, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _mesh(shape):
    return None if shape is None else make_mesh(*shape, device="cpu")


# -- the tracker step with injected draws ----------------------------------------


def run_fns(ref: dict, shape=None, log_branches: bool = False) -> dict | None:
    """The port's step (build_tracker_fns) over a reference's clip with its
    injected draws (test_torch_mesh_tracker.jax_reference) on a mesh of
    `shape` (None: no mesh) -> {"rows": [T, 10 K] packed outputs of this
    rank's banks, "banks": their slice, "state": the last state's leaves
    (numpy), "log": the (branch, predicate) pairs of the step's run_if},
    or None on a rank outside the mesh. Banked references (bboxes [K, 4])
    give each rank its bank_slice."""
    cfg = Config.from_dict(copy.deepcopy(ref["cfg"]))
    if shape is not None and dist.get_rank() >= int(np.prod(shape)):
        # A mesh smaller than the group: new_group is a collective of every
        # rank, so a rank outside it joins the build, which then refuses it.
        try:
            _mesh(shape)
        except ValueError:
            return None
    mesh = _mesh(shape)
    params = bridge.params_from_numpy(ref["params"], VitSpec.from_config(cfg.model))
    if mesh is not None:
        params = vit_param_shard(mesh, params)
    fns = build_tracker_fns(cfg, mesh)
    banked = ref["bbox"].ndim == 2
    mine = None
    if banked:
        k = ref["bbox"].shape[0]
        mine = bank_slice(mesh, k) if mesh is not None else slice(0, k)

    def pick(x):  # this rank's banks of a banked input
        return torch.from_numpy(np.asarray(x if mine is None else x[mine]))

    seeds = ref["seeds"][mine].tolist() if banked else 0
    state = fns.init(params, torch.from_numpy(ref["clip"][0]), pick(ref["bbox"]), seeds, cloud=pick(ref["cloud"]))
    log = []

    def run_if(pred, body):
        value = bool(pred)
        log.append((body.__name__, value))
        if value:
            body()

    rows = []
    for i in range(1, len(ref["clip"])):
        noise = StepNoise(*(pick(x) for x in ref["noises"][i - 1]))
        reseed = pick(ref["reseeds"][i - 1])
        state, out = fns.step(params, state, torch.from_numpy(ref["clip"][i]), noise=noise, reseed=reseed,
                              run_if=run_if if log_branches else None)
        rows.append(pack_track_output(out).numpy())
    return {"rows": np.stack(rows), "banks": (mine.start, mine.stop) if banked else None,
            "state": [x.numpy() for x in state_leaves(state)], "log": log}


def tracker_scenarios(rank: int, refs: dict, cases: list) -> dict:
    """Each case (name, reference name, mesh shape, log_branches) through
    run_fns, in order -> {name: run_fns' result}."""
    return {name: run_fns(refs[ref], shape, log) for name, ref, shape, log in cases}


# -- the Tracker classes with their own draws ----------------------------------------


def _tiny(cfg_dict, **runtime) -> Config:
    d = copy.deepcopy(cfg_dict)
    d.setdefault("runtime", {}).update(runtime)
    return Config.from_dict(d)


def tracker_runs(cfg_dict: dict, clip: np.ndarray, bbox: np.ndarray, shape=None, state_dir: str = "") -> dict:
    """The Tracker class on a mesh of `shape` (None: none) over `clip`:
    records through step; with state_dir, the state saved after the clip
    (state.npz) and the records of a Tracker resumed from the unsharded
    file there (unsharded.npz) over the clip's last two frames again."""
    from vitparticlefiltertracker_tpu_torch.runtime.tracker import Tracker

    tr = Tracker(_tiny(cfg_dict), device="cpu", mesh=_mesh(shape))
    tr.init(clip[0], bbox)
    recs = [tr.step(f) for f in clip[1:]]
    out = {"positions": np.asarray([r["position"] for r in recs]),
           "flags": np.asarray([[r["resampled"], r["lost"]] for r in recs])}
    if state_dir:
        tr.save(os.path.join(state_dir, "state.npz" if shape is not None else "unsharded.npz"))
        tr.resume(os.path.join(state_dir, "unsharded.npz"))
        out["resumed"] = np.asarray([tr.step(f)["position"] for f in clip[-2:]])
    return out


def chunk_run(cfg_dict: dict, arr: np.ndarray, truth: np.ndarray, bbox: np.ndarray, shape=None) -> np.ndarray:
    """tests/test_mesh_wiring.py:48's chunk step: Tracker.step_chunk_device
    on a StreamFrame of 4 ROI views of 160 px and a decimated global view ->
    positions [4, 2]."""
    from vitparticlefiltertracker_tpu_torch.ops.image import FrameView, StreamFrame
    from vitparticlefiltertracker_tpu_torch.runtime.tracker import Tracker

    tr = Tracker(_tiny(cfg_dict), device="cpu", mesh=_mesh(shape))
    tr.init(arr[0], bbox)
    glob = FrameView(pixels=torch.from_numpy(arr[1][::4, ::4].astype(np.float32)), origin=torch.zeros(2),
                     stride=4.0)
    ctr = truth[1:].mean(axis=0)
    ox = int(np.clip(ctr[0] - 80, 0, 224 - 160))
    oy = int(np.clip(ctr[1] - 80, 0, 224 - 160))
    chunk = StreamFrame(
        track=FrameView(pixels=torch.from_numpy(arr[1:, oy:oy + 160, ox:ox + 160].astype(np.float32)),
                        origin=torch.from_numpy(np.tile([ox, oy], (4, 1)).astype(np.float32)), stride=1.0),
        glob=glob,
    )
    return tr.step_chunk_device(chunk).position.numpy()


def banked_runs(cfg_dict: dict, first, steps, bboxes, kind: str, shape=None, reinit=None) -> dict:
    """MultiTracker (kind "banked": `first` one frame, `steps` [T, H, W, 3])
    or MultiStreamTracker ("streams": frames with a leading K) on a mesh of
    `shape` -> packed rows [T, 10 K] from step_packed, the records of
    MultiTracker.step, and with `reinit` (k, frame index, bbox) bank k
    re-targeted before that step."""
    from vitparticlefiltertracker_tpu_torch.runtime.banked import MultiStreamTracker, MultiTracker

    k = bboxes.shape[0]
    if kind == "banked":
        tr = MultiTracker(_tiny(cfg_dict, banks=k), device="cpu", mesh=_mesh(shape))
    else:
        tr = MultiStreamTracker(_tiny(cfg_dict), k, device="cpu", mesh=_mesh(shape))
    tr.init(first, bboxes)
    rows, recs = [], []
    for i, frame in enumerate(steps):
        if reinit is not None and i == reinit[1]:
            tr.reinit_bank(reinit[0], steps[i - 1], reinit[2])
        if kind == "banked" and i % 2:
            recs.append([r["position"] for r in tr.step(frame)])
        else:
            rows.append(tr.step_packed(torch.from_numpy(np.ascontiguousarray(frame))).numpy())
    clip = tr.track_clip_device(torch.from_numpy(np.ascontiguousarray(steps[:2]))).position.numpy()
    return {"rows": np.stack(rows), "recs": np.asarray(recs), "clip": clip}


def class_scenarios(rank: int, cases: list) -> dict:
    """Each case (name, function name of this module, kwargs) in order ->
    {name: its result}."""
    return {name: globals()[fn](**kwargs) for name, fn, kwargs in cases}


def tracker_and_class_scenarios(rank: int, refs: dict, fns_cases: list, class_cases: list) -> tuple[dict, dict]:
    return tracker_scenarios(rank, refs, fns_cases), class_scenarios(rank, class_cases)


# -- training ----------------------------------------------------------------------


def train_steps(cfg_dict: dict, batch=None, draws=None, data: int | None = None) -> dict:
    """build_train_step on a ("data",) mesh of `data` ranks (None: none):
    step 0's loss, metrics and gradients from the given global batch and
    draws (numpy NamedTuples as dicts, or None: drawn), then two whole
    steps from the step generator's own draws (steps 0 and 1) -> numpy."""
    from vitparticlefiltertracker_tpu_torch.models.params import _flatten
    from vitparticlefiltertracker_tpu_torch.training import data as tdata
    from vitparticlefiltertracker_tpu_torch.training import objective as tobj
    from vitparticlefiltertracker_tpu_torch.training import train as ttrain

    cfg = Config.from_dict(copy.deepcopy(cfg_dict))
    mesh = None if data is None else ttrain.make_data_mesh(data, "cpu")
    init_fn, step_fn = ttrain.build_train_step(cfg, "cpu", mesh=mesh)
    params, opt = init_fn()
    out = {}
    if batch is not None:
        tb = tdata.SceneBatch(**{k: torch.from_numpy(v) for k, v in batch.items()})
        td = tobj.LossDraws(**{k: torch.from_numpy(v) for k, v in draws.items()})
        loss, metrics, grads = step_fn.grads(params, 0, tb, td)
        out["grads0"] = {"loss": float(loss), "metrics": {k: float(v) for k, v in metrics.items()},
                         "grads": {k: g.numpy() for k, g in grads.items()}}
    losses = []
    for i in range(2):
        params, opt, metrics = step_fn(params, opt, i)
        losses.append(float(metrics["loss"]))
    out["losses"] = losses
    out["params"] = {k: v.detach().numpy() for k, v in _flatten(params).items()}
    return out


def train_features_run(cfg_dict: dict) -> list:
    """train_features on every rank of the group -> its log lines."""
    from vitparticlefiltertracker_tpu_torch.training.train import train_features

    logs = []
    train_features(Config.from_dict(copy.deepcopy(cfg_dict)), log=logs.append, device="cpu")
    return logs


def train_scenarios(rank: int, cases: list) -> dict:
    return {name: globals()[fn](**kwargs) for name, fn, kwargs in cases}


# -- the mesh itself -----------------------------------------------------------------


def mesh_layout(rank: int, params_np: dict, spec_kw: dict, images: np.ndarray) -> dict:
    """On two ranks: each axis's coordinates and groups (all-gathered rank
    ids, all-reduced sums), the collectives' counts, the ValueError of a mesh
    larger than the group, and one tensor-parallel ViT forward over
    (1, 1, 2) -> numpy."""
    from vitparticlefiltertracker_tpu_torch.models.vit import vit_forward_tokens
    from vitparticlefiltertracker_tpu_torch.parallel import mesh as pm

    out = {}
    for shape in ((2, 1, 1), (1, 2, 1), (1, 1, 2)):
        mesh = make_mesh(*shape, device="cpu")
        before = (pm.all_gather.launches, pm.all_reduce.launches)
        me = torch.tensor([float(rank)])
        out[shape] = {
            "coords": dict(mesh.coords),
            "gathered": {ax: pm.all_gather(me, mesh, ax).reshape(-1).tolist() for ax in mesh.axis_names},
            "summed": {ax: pm.all_reduce(me.clone() + 1, mesh, ax).item() for ax in mesh.axis_names},
            "counted": (pm.all_gather.launches - before[0], pm.all_reduce.launches - before[1]),
        }
    try:
        make_mesh(2, 2, 1, device="cpu")
    except ValueError as e:
        out["too_big"] = str(e)
    mesh = make_mesh(1, 1, 2, device="cpu")
    spec = VitSpec(**spec_kw)._replace(mesh=mesh)
    params = vit_param_shard(mesh, bridge.params_from_numpy(params_np, VitSpec(**spec_kw)))
    out["tp_tokens"] = vit_forward_tokens(params, torch.from_numpy(images), spec).numpy()
    return out


def dinov2_tp_forward(rank: int, tree_np: dict, spec_kw: dict, images: np.ndarray) -> np.ndarray:
    """On two ranks: a DINOv2 forward (SwiGLU FFN, prefix tokens) over
    (1, 1, 2), this rank's slices of the tree -> numpy."""
    from vitparticlefiltertracker_tpu_torch.models.params import _map
    from vitparticlefiltertracker_tpu_torch.models.vit import vit_forward_tokens

    mesh = make_mesh(1, 1, 2, device="cpu")
    params = vit_param_shard(mesh, _map(tree_np, torch.from_numpy))
    return vit_forward_tokens(params, torch.from_numpy(images), VitSpec(**spec_kw)._replace(mesh=mesh)).numpy()


def peer_sums(rank: int, m: int, shape: tuple, seed: int) -> dict:
    """On a (1, 1, m) mesh: row_parallel_sum of this rank's bf16 slice of
    a product (y [.., K], w [K, D], bias [D] made from `seed`; rank r holds
    columns / rows [r K / m, (r + 1) K / m)) -> the sum, and this rank's f32
    partial product (what the other ranks' sums must have summed)."""
    from vitparticlefiltertracker_tpu_torch.parallel.mesh import row_parallel_sum

    y, w, bias = peer_inputs(shape, seed)
    mesh = make_mesh(1, 1, m, device="cpu")
    k = w.shape[0] // m
    mine = slice(rank * k, (rank + 1) * k)
    out = row_parallel_sum(y[..., mine], w[mine], bias, mesh)
    return {"sum": out.float().numpy(), "partial": (y[..., mine].float() @ w[mine].float()).numpy()}


def peer_inputs(shape: tuple, seed: int):
    """bf16 y [*shape[:-1], K], w [K, D], bias [D] of a row-parallel product
    (shape = (*lead, K, D)), from numpy's generator at `seed`."""
    rng = np.random.default_rng(seed)
    *lead, k, d = shape
    y = torch.from_numpy(rng.normal(size=(*lead, k)).astype(np.float32)).bfloat16()
    w = torch.from_numpy((rng.normal(size=(k, d)) / np.sqrt(k)).astype(np.float32)).bfloat16()
    bias = torch.from_numpy(rng.normal(size=(d,)).astype(np.float32)).bfloat16()
    return y, w, bias


def stream_runs(cfg_dict: dict, kind: str, shape=None, frames: int = 8, steer: bool = True, **kw) -> dict:
    """stream_track on a mesh of `shape` (None: none): kind "stream" (a
    Tracker on the config's source, stream_track's keywords in kw) or
    "serve" (a MultiStreamTracker over two moving-square clips, seeds 0 and
    1). Rank 0 (or the one process) opens the source and records; the other
    ranks pass none and follow -> the records and the stats' frames,
    dispatches and spans. steer=False: the ROI shipper ignores the records read back,
    so every crop is aimed at the initial box's centre, with and without a
    mesh alike (use with steer_lag=0: no flow control waits on steering)."""
    from unittest import mock

    from vitparticlefiltertracker_tpu_torch.io.video import open_source
    from vitparticlefiltertracker_tpu_torch.runtime.banked import MultiStreamTracker
    from vitparticlefiltertracker_tpu_torch.runtime.streaming import RoiShipper, stream_track
    from vitparticlefiltertracker_tpu_torch.runtime.tracker import Tracker

    cfg = _tiny(cfg_dict)
    mesh = _mesh(shape)
    leader = mesh is None or mesh.rank == 0
    size = tuple(cfg.io.frame_size)
    if kind == "stream":
        tracker = Tracker(cfg, device="cpu", mesh=mesh)
        src = open_source(cfg.io.source, frames, size, seed=0) if leader else None
        bbox = src.init_bbox if leader else None
    else:
        tracker = MultiStreamTracker(cfg, 2, device="cpu", mesh=mesh)
        srcs = [open_source("synthetic:moving-square", frames, size, seed=i) for i in range(2)] if leader else []
        src = iter(np.stack([np.stack(s.frames) for s in srcs], axis=1)) if leader else None
        bbox = np.stack([np.asarray(s.init_bbox, np.float32) for s in srcs]) if leader else None
    recs = []
    aim = contextlib.nullcontext() if steer else mock.patch.object(RoiShipper, "observe", lambda self, rec: None)
    with aim:
        stats = stream_track(tracker, src, bbox, on_record=recs.append if leader else None, **kw)
    return {"recs": recs, "frames": stats["frames"], "dispatches": stats["dispatches"], "spans": stats["spans"]}


def track_command(rank: int, argv: list) -> int:
    """cli.main(argv) on every rank (the process group is the spawn's)."""
    from vitparticlefiltertracker_tpu_torch import cli

    return cli.main(argv)


def bf16_split_plants(prm: dict, spec_kw: dict, images: np.ndarray) -> dict:
    """On a (1, 1, 2) mesh: the bf16 tensor-parallel forward of `prm` (a
    torch parameter tree) -> its tokens as numpy, sound and with a fault
    planted in the "model" sum (the bias added twice; rank 1's partial
    dropped)."""
    from unittest import mock

    from vitparticlefiltertracker_tpu_torch.models.vit import vit_forward_tokens
    from vitparticlefiltertracker_tpu_torch.parallel import mesh as pm

    mesh = make_mesh(1, 1, 2, device="cpu")
    spec = VitSpec(**spec_kw)._replace(dtype=torch.bfloat16, mesh=mesh)
    shard = vit_param_shard(mesh, prm)
    plain = pm.peer_all_reduce_plain
    plants = {"sound": plain, "bias-twice": lambda parts, bias: plain(parts, bias) + bias,
              "share-dropped": lambda parts, bias: plain(parts[:1], bias)}
    out = {}
    for name, fn in plants.items():
        with mock.patch.object(pm, "peer_all_reduce_plain", fn):
            out[name] = vit_forward_tokens(shard, torch.from_numpy(images), spec).float().numpy()
    return out


def layout_and_streams(rank: int, params_np: dict, spec_kw: dict, images: np.ndarray, tp_prm: dict,
                       peer_cases: list, stream_cases: list, track_argv: list) -> dict:
    """mesh_layout, the bf16 split's plants (bf16_split_plants over
    `tp_prm`), then each peer_sums case (name, m, shape, seed), each
    stream_runs case (name, kwargs) and the track command (argv) on the
    same two ranks."""
    out = mesh_layout(rank, params_np, spec_kw, images)
    out["bf16_plants"] = bf16_split_plants(tp_prm, spec_kw, images)
    out["peer"] = {name: peer_sums(rank, m, shape, seed) for name, m, shape, seed in peer_cases}
    out["streams"] = {name: stream_runs(**kw) for name, kw in stream_cases}
    out["track_rc"] = track_command(rank, track_argv)
    return out


def world_one_runs(rank: int, cases: list, state_dir: str) -> dict:
    """On one rank, a (1, 1, 1) mesh: each case (name, config dict, clip,
    bbox) through tracker_runs; the first one's state saved to state_dir."""
    return {name: tracker_runs(cfg, clip, bbox, (1, 1, 1), state_dir if i == 0 else "")
            for i, (name, cfg, clip, bbox) in enumerate(cases)}
