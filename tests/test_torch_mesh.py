"""Port parity: the device mesh (vitparticlefiltertracker_tpu_torch/parallel/
mesh.py) against the JAX package's parallel/mesh.py.

The pure helpers (auto_mesh_shape, check_tp_divisibility, bank_slice) and
the tensor-parallel parameter slices need no process group: the slices are
held, bit for bit, against the shards that JAX's vit_param_sharding puts on
the suite's 8 fake CPU devices. The collectives and the layout run on gloo
ranks (tests/torch_mesh_workers.py): two ranks for the axes, the counts and
a tensor-parallel ViT forward; one rank for a (1, 1, 1) mesh, whose step is
the unsharded step bit for bit with every collective issued (as the card
runs it): records, and a state file byte for byte.
"""

import copy
import json
import math
import os
import subprocess
import sys
import zipfile

import chip_smoke
import jax
import numpy as np
import pytest
import test_torch_tracker_e2e  # noqa: F401  (one intra-op thread a test worker)
import torch
import torch_mesh_workers as W
from test_torch_mesh_tracker import CROP, TINY
from test_torch_redetect import CASES as REDETECT_CASES

from vitparticlefiltertracker_tpu.config import Config as JConfig
from vitparticlefiltertracker_tpu.models.vit import VitSpec as JVitSpec
from vitparticlefiltertracker_tpu.models.vit import init_vit_params as j_init_vit_params
from vitparticlefiltertracker_tpu.parallel import mesh as jmesh
from vitparticlefiltertracker_tpu.runtime import tracker as jtr
from vitparticlefiltertracker_tpu_torch import bridge
from vitparticlefiltertracker_tpu_torch.io.video import open_source
from vitparticlefiltertracker_tpu_torch.models.params import _flatten
from vitparticlefiltertracker_tpu_torch.models.vit import VitSpec, vit_forward_tokens
from vitparticlefiltertracker_tpu_torch.parallel import mesh as tmesh

SPEC = dict(depth=2, dim=64, heads=4, mlp_dim=128, image_size=32, head_depth=1)


def _unjoined(bank=1, particle=1, model=1, rank=0) -> tmesh.Mesh:
    """A Mesh at `rank` with no process group: enough for the slicing."""
    return tmesh.Mesh(tmesh.AXES, (bank, particle, model), rank, {}, "gloo", 0)


@pytest.mark.parametrize("n", range(1, 17))
def test_auto_mesh_shape_matches_jax(n):
    assert tmesh.auto_mesh_shape(n) == jmesh.auto_mesh_shape(n)


@pytest.mark.parametrize("heads,mlp,axis", [(12, 3072, 2), (12, 3072, 5), (4, 128, 3), (16, 4096, 8)])
def test_check_tp_divisibility_matches_jax(heads, mlp, axis):
    try:
        jmesh.check_tp_divisibility(heads, mlp, axis)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).replace("(", r"\(").replace(")", r"\)")):
            tmesh.check_tp_divisibility(heads, mlp, axis)
    else:
        tmesh.check_tp_divisibility(heads, mlp, axis)


@pytest.mark.parametrize("shape", [(1, 4, 2), (1, 2, 4), (2, 2, 2)])
def test_vit_param_shard_matches_jax_shards(shape):
    """tests/test_tracker_e2e.py:441 in full: each device's shard of JAX's
    tensor-parallel sharding (8 fake CPU devices; wqkv, bqkv, w1, b1 by
    columns, wo and w2 by rows, the residual head's blocks too, the rest
    replicated) is the port's slice at that device's mesh coordinates, bit
    for bit."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the suite's 8 fake CPU devices")
    jp = j_init_vit_params(jax.random.key(0), JVitSpec(**SPEC))
    mesh = jmesh.make_mesh(*shape)
    placed = jax.device_put(jp, jmesh.vit_param_sharding(mesh, jp))
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), VitSpec(**SPEC))
    where = {d.id: tuple(int(i) for i in idx) for idx, d in np.ndenumerate(mesh.devices)}
    jflat = jax.tree_util.tree_flatten_with_path(placed)[0]
    for rank in range(8):
        coords = np.unravel_index(rank, shape)
        mine = _flatten(tmesh.vit_param_shard(_unjoined(*shape, rank=rank), tp))
        for path, arr in jflat:
            name = "/".join(str(getattr(k, "key", k)) for k in path)
            shard = next(s for s in arr.addressable_shards if where[s.device.id] == tuple(coords))
            np.testing.assert_array_equal(mine[name].numpy(), np.asarray(shard.data), err_msg=f"{name} @ {coords}")


def test_vit_param_shard_specs():
    """The leaves each rule hits (tests/test_tracker_e2e.py:441's specs, as
    shapes at M = 2); M = 1 hands back the caller's tensors."""
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, j_init_vit_params(jax.random.key(0), JVitSpec(**SPEC))),
                                  VitSpec(**SPEC))
    got = _flatten(tmesh.vit_param_shard(_unjoined(1, 4, 2, rank=1), tp))
    assert got["blocks/attn/wqkv"].shape == (2, 64, 96)
    assert got["blocks/attn/bqkv"].shape == (2, 96)
    assert got["blocks/attn/wo"].shape == (2, 32, 64)
    assert got["blocks/attn/bo"].shape == (2, 64)
    assert got["blocks/mlp/w1"].shape == (2, 64, 64) and got["blocks/mlp/b1"].shape == (2, 64)
    assert got["blocks/mlp/w2"].shape == (2, 64, 64)
    assert got["head/blocks/attn/wqkv"].shape == (1, 64, 96)
    assert got["blocks/ln1/scale"] is _flatten(tp)["blocks/ln1/scale"]
    assert got["patch_embed/kernel"] is _flatten(tp)["patch_embed/kernel"]
    whole = tmesh.vit_param_shard(_unjoined(1, 8, 1), tp)
    assert all(a is b for a, b in zip(_flatten(whole).values(), _flatten(tp).values()))


def test_bank_slice():
    assert [tmesh.bank_slice(_unjoined(4, 2, rank=r), 8) for r in (0, 1, 2, 7)] == [
        slice(0, 2), slice(0, 2), slice(2, 4), slice(6, 8)]
    with pytest.raises(ValueError, match="runtime.banks 6 must divide by runtime.mesh_banks 4"):
        tmesh.bank_slice(_unjoined(4), 6)


def test_no_mesh_touches_no_process_group():
    """Without a mesh nothing calls torch.distributed: a tracker runs with no
    process group and issues no collective."""
    from vitparticlefiltertracker_tpu_torch.config import Config
    from vitparticlefiltertracker_tpu_torch.runtime.tracker import Tracker

    counts = (tmesh.all_gather.launches, tmesh.all_reduce.launches)
    src = open_source("synthetic:moving-square", 3, (224, 224), seed=0)
    tr = Tracker(Config.from_dict(copy.deepcopy(TINY)), device="cpu")
    list(tr.run(src))
    assert tr.mesh is None and not torch.distributed.is_initialized()
    assert (tmesh.all_gather.launches, tmesh.all_reduce.launches) == counts


def test_init_distributed_one_rank_file_store(tmp_path):
    """A group of one process over the file store it is given (as the card's
    smoke and tests open NCCL), gloo for the CPU; a second call is a no-op;
    a (1, 1, 1) mesh issues and counts every collective at size 1."""
    store = tmp_path / "store"
    tmesh.init_distributed("cpu", store=str(store))
    try:
        assert (torch.distributed.get_world_size(), torch.distributed.get_backend()) == (1, "gloo")
        assert store.exists()
        tmesh.init_distributed("cpu", store=str(tmp_path / "other"))
        assert not (tmp_path / "other").exists()
        mesh = tmesh.make_mesh(1, 1, 1, "cpu")
        counts = (tmesh.all_gather.launches, tmesh.all_reduce.launches)
        x = torch.arange(6.0).reshape(2, 3)
        assert torch.equal(tmesh.all_gather(x, mesh, "particle"), x[None])
        assert torch.equal(tmesh.all_reduce(x.clone(), mesh, "model"), x)
        assert (tmesh.all_gather.launches, tmesh.all_reduce.launches) == (counts[0] + 1, counts[1] + 1)
    finally:
        torch.distributed.destroy_process_group()


# The peer all-reduce's plain version on two ranks: (name, ranks, (*lead, K, D), seed).
PEER_CASES = [("tokens", 2, (1, 5, 64, 64), 0), ("batch", 2, (3, 7, 32, 48), 1)]
# stream_track on two ranks (rank 0 reads, rank 1 follows): whole frames on a
# particle mesh; ROI chunks of 2 on it (the ROI spans the 224-px frame, so
# its origin is (0, 0) whatever the steering: the same inputs as without a
# mesh), the global view new every other frame; one-frame ROI steps whose
# global view has the ROI's shape (56 px, and 224 px decimated by 4), with
# the crops held at the initial box (unsteered, so that both runs crop the
# same pixels) while the target moves; serve's two streams on "bank".
STREAM_CASES = [
    ("stream", dict(cfg_dict=TINY, kind="stream", shape=(1, 2, 1))),
    ("roi-chunk", dict(cfg_dict=TINY, kind="stream", shape=(1, 2, 1), roi_px=224, glob_stride=4, glob_every=2,
                       chunk=2, steer_lag=4)),
    ("roi-glob-as-roi", dict(cfg_dict=TINY, kind="stream", shape=(1, 2, 1), roi_px=56, glob_stride=4, glob_every=2,
                             steer_lag=0, steer=False)),
    ("serve", dict(cfg_dict=TINY, kind="serve", shape=(2, 1, 1))),
]
NATIVE_SETS = ["io.source=native-synthetic:moving-square", "io.num_frames=6", "io.frame_size=[224,224]",
               "model.variant=vit-t16", "model.image_size=64", "model.dtype=float32", "filter.num_particles=64"]


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    """Two ranks: the axes, a tensor-parallel forward (f32, and bf16 with
    faults planted), the peer all-reduce's plain version, streams and the
    track command on a native source; and the same runs without a mesh
    here."""
    rng = np.random.default_rng(0)
    params = jax.tree.map(np.asarray, j_init_vit_params(jax.random.key(1), JVitSpec(**SPEC)))
    images = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    spec = dict(SPEC, dtype=torch.float32)
    tp_prm = chip_smoke.with_drawn_biases(bridge.params_from_numpy(params, VitSpec(**spec)), seed=2)
    tmp = tmp_path_factory.mktemp("native_track")
    argv = ["track", "--device", "cpu", "--quiet", *(x for v in NATIVE_SETS for x in ("--set", v))]
    mesh_argv = [*argv, "--set", "runtime.mesh_particles=2", "--set", f"io.output={tmp / 'mesh.jsonl'}"]
    ranks = W.spawn(2, W.layout_and_streams, params, spec, images, tp_prm, PEER_CASES, STREAM_CASES, mesh_argv)
    want = vit_forward_tokens(bridge.params_from_numpy(params, VitSpec(**spec)), torch.from_numpy(images),
                              VitSpec(**spec)).numpy()
    from vitparticlefiltertracker_tpu_torch import cli

    assert cli.main([*argv, "--set", f"io.output={tmp / 'one.jsonl'}"]) == 0
    native = [[json.loads(line) for line in open(tmp / f)] for f in ("mesh.jsonl", "one.jsonl")]
    streams = {name: W.stream_runs(**dict(kw, shape=None)) for name, kw in STREAM_CASES}
    x = torch.from_numpy(images)
    whole = {dt: vit_forward_tokens(tp_prm, x, VitSpec(**spec)._replace(dtype=dt)) for dt in (torch.bfloat16, torch.float32)}
    return ranks, want, {"streams": streams, "native": native, "bf16_whole": whole}


@pytest.mark.parametrize("shape,axis", [((2, 1, 1), "bank"), ((1, 2, 1), "particle"), ((1, 1, 2), "model")])
def test_mesh_axes_lay_ranks_out_as_jax(layout, shape, axis):
    """rank = (b P + p) M + m, as JAX reshapes its devices; each axis's group
    holds the ranks along it (all_gather in rank order, all_reduce summing),
    the size-1 axes a group of one rank that still gets its collective; each
    call counted once."""
    ranks, _, _ = layout
    for rank, out in enumerate(ranks):
        got = out[shape]
        assert got["coords"] == dict(zip(tmesh.AXES, (int(c) for c in np.unravel_index(rank, shape))))
        for ax in tmesh.AXES:
            members = [0.0, 1.0] if ax == axis else [float(rank)]
            assert got["gathered"][ax] == members
            assert got["summed"][ax] == sum(m + 1 for m in members)
        assert got["counted"] == (3, 3)


def test_make_mesh_larger_than_the_group_raises(layout):
    ranks, _, _ = layout
    for out in ranks:
        assert out["too_big"] == "mesh (2 bank x 2 particle x 1 model) needs 4 devices, have 2"


def test_tensor_parallel_vit_forward_matches_whole(layout):
    """The ViT (and its residual head) over (1, 1, 2): heads and MLP columns
    split, the row-parallel products all-reduced before their biases, gives
    the whole forward's tokens; both ranks hold the same tokens."""
    ranks, want, _ = layout
    for out in ranks:
        np.testing.assert_allclose(out["tp_tokens"], want, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(out["tp_tokens"], ranks[0]["tp_tokens"])


@pytest.mark.parametrize("plant", ["sound", "bias-twice", "share-dropped"])
def test_bf16_split_within_the_smokes_rounding_limit(layout, plant):
    """chip_smoke.py's peer phase holds the bf16 "model" split to its
    mesh=None twin: the tokens' distance at most TP_BF16_RATIO times the
    twin's own distance from the f32 forward (biases drawn, so that a bias
    fault shows). On two CPU ranks a sound split is within it, and a split
    with a fault planted in the "model" sum is far outside it."""
    ranks, _, runs = layout
    twin, f32 = runs["bf16_whole"][torch.bfloat16], runs["bf16_whole"][torch.float32]
    split = torch.from_numpy(ranks[0]["bf16_plants"][plant])
    np.testing.assert_array_equal(ranks[1]["bf16_plants"][plant], ranks[0]["bf16_plants"][plant])
    _, _, ratio = chip_smoke.tp_split_ratio(split, twin, f32)
    if plant == "sound":
        assert ratio <= chip_smoke.TP_BF16_RATIO
    else:
        assert ratio > 10 * chip_smoke.TP_BF16_RATIO


@pytest.mark.parametrize("case", [c[0] for c in PEER_CASES])
def test_peer_all_reduce_plain_sums_in_rank_order_once(layout, case):
    """The "model" sum of a row-parallel product (parallel/mesh.py
    row_parallel_sum; on CPU ranks the peer kernel's plain version): each
    rank's partial product in f32, summed in rank order, plus the bias,
    rounded once to bf16; both ranks hold the same bits; against the
    mesh=None product y @ w + bias within bf16 rounding."""
    from vitparticlefiltertracker_tpu_torch.ops.peer_allreduce import peer_all_reduce_plain

    ranks, _, _ = layout
    _, m, shape, seed = next(c for c in PEER_CASES if c[0] == case)
    y, w, bias = W.peer_inputs(shape, seed)
    parts = [torch.from_numpy(r["peer"][case]["partial"]) for r in ranks]
    acc = parts[0] + parts[1]  # f32, rank order
    want = (acc + bias.float()).bfloat16().float().numpy()
    np.testing.assert_array_equal(peer_all_reduce_plain(torch.stack(parts), bias).float().numpy(), want)
    for r in ranks:
        np.testing.assert_array_equal(r["peer"][case]["sum"], want)
    whole = (y @ w + bias).float().numpy()
    np.testing.assert_allclose(want, whole, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("case", [c[0] for c in STREAM_CASES])
def test_stream_on_a_mesh_records_as_without(layout, case):
    """stream_track on two ranks: rank 0 alone reads the source and records,
    rank 1 follows its dispatches (runtime/streaming.py MeshFeed). Rank 0's
    records are the mesh=None stream's (the sharded tolerance: a particle
    slice's products round otherwise on the CPU; "bank" splits whole
    streams); both ranks submit the same dispatches."""
    ranks, _, runs = layout
    want = runs["streams"][case]
    got = [r["streams"][case] for r in ranks]
    assert got[1]["recs"] == [] and len(got[0]["recs"]) == len(want["recs"]) > 0
    assert got[0]["dispatches"] == got[1]["dispatches"] == want["dispatches"]
    assert got[0]["frames"] == got[1]["frames"] == want["frames"]
    for a, b in zip(got[0]["recs"], want["recs"]):
        assert a["frame"] == b["frame"] and a["lost"] == b["lost"]
        np.testing.assert_allclose(a["position"], b["position"], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("case", [c[0] for c in STREAM_CASES])
def test_mesh_feed_spans(layout, case):
    """MeshFeed's spans (utils/profiling.py) on two ranks: rank 0 sends the
    host's decisions (mesh.control) and broadcasts the input (mesh.broadcast)
    once or more a dispatch; rank 1 waits for each message (mesh.wait) and makes the same dispatches."""
    ranks, _, _ = layout
    lead, follower = (r["streams"][case] for r in ranks)
    dispatches = sum(lead["dispatches"].values())
    assert lead["spans"]["stream.submit"]["n"] == dispatches > 0
    for name in ("mesh.control", "mesh.broadcast"):
        assert lead["spans"][name]["n"] >= dispatches, name
    assert "mesh.wait" not in lead["spans"]
    assert follower["spans"]["mesh.wait"]["n"] >= dispatches
    assert follower["spans"]["mesh.broadcast"]["n"] >= dispatches
    assert follower["spans"]["step.launch"]["n"] == dispatches
    assert "mesh.control" not in follower["spans"] and "stream.submit" not in follower["spans"]


def test_track_command_reads_a_native_source_once_on_a_mesh(layout):
    """`track` with io.source native-synthetic (the native ring) on a
    particle mesh of two ranks: rank 0 reads the ring and writes the
    records; they match the one-process run."""
    ranks, _, runs = layout
    assert [r["track_rc"] for r in ranks] == [0, 0]
    got, want = runs["native"]
    assert [r["frame"] for r in got] == [r["frame"] for r in want] == [1, 2, 3, 4, 5]
    np.testing.assert_allclose([r["position"] for r in got], [r["position"] for r in want], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("n,blocks", [(8, 1), (196 * 768, 37), (196 * 1024, 49), (49 * 196 * 768, 128)])
def test_peer_kernel_grid(n, blocks):
    """The peer kernel's grid: a vector of 8 elements a thread, 512 threads
    a block, at most 128 blocks (all resident at once on the card)."""
    from vitparticlefiltertracker_tpu_torch.ops.peer_allreduce import launch_blocks

    assert launch_blocks(n) == blocks


# The peer all-reduce's two forms: the choice, the two-shot cut and order.
# A call's leading batch -> the group sizes that take the two-shot form for
# [B, 196, 768] (the B 1 forward's and, at 1024 wide, eval3's stay one-shot;
# the measured crossings: 4 on 2 cards, 2 on 4).
PEER_CALLS = {"b16 B1": ((1, 196, 768), ()), "l16 B1": ((1, 196, 1024), ()),
              "B2": ((2, 196, 768), (3, 4, 8)), "B4": ((4, 196, 768), (2, 3, 4, 8)),
              "scan": ((49, 196, 768), (2, 3, 4, 8))}


@pytest.mark.parametrize("m", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("call", sorted(PEER_CALLS))
def test_peer_form_keeps_b1_calls_one_shot(call, m):
    """The form is a function of (n, m, the partial's dtype) alone, so every
    rank picks the same one: a one-rank group and a bf16 partial always one-shot, the
    B 1 forwards' calls one-shot, the re-detection scan's two-shot on 2
    ranks or more, the batches between at the crossings measured on 2 and
    4 cards."""
    from vitparticlefiltertracker_tpu_torch.ops import peer_allreduce as par

    shape, two_shot_groups = PEER_CALLS[call]
    n = math.prod(shape)
    assert par.peer_form(n, m, torch.float32) == (par.TWO_SHOT if m in two_shot_groups else par.ONE_SHOT)
    assert par.peer_form(n, m, torch.bfloat16) == par.ONE_SHOT


@pytest.mark.parametrize("m", [2, 3, 4, 8])
@pytest.mark.parametrize("n", [8, 64, 196 * 768, 8 * 196 * 768 + 8, 49 * 196 * 768, 49 * 196 * 1024])
def test_two_shot_cut_reduces_every_vector_once(n, m):
    """Every vector of the n / 8 lies in exactly one (rank, block) piece;
    rank r's pieces are contiguous and in block order inside its slice; the
    cut depends on (n, m, blocks) only, so block b's pieces are the same on
    every rank (the barriers are per block index); the grid fits
    MAX_BLOCKS and the buffer holds both regions."""
    from vitparticlefiltertracker_tpu_torch.ops import peer_allreduce as par

    blocks = par.form_blocks(n, m, par.TWO_SHOT)
    assert 1 <= blocks <= par.MAX_BLOCKS
    assert blocks == par.launch_blocks(-(-(n // 8) // m) * 8)
    cut = par.two_shot_ranges(n, m, blocks)
    seen = np.zeros(n // 8, np.int64)
    for r, pieces in enumerate(cut):
        assert all(a[1] == b[0] for a, b in zip(pieces, pieces[1:]))
        assert all(lo <= hi for lo, hi in pieces)
        for lo, hi in pieces:
            seen[lo:hi] += 1
    np.testing.assert_array_equal(seen, 1)
    assert par.two_shot_ranges(n, m, blocks) == cut
    assert par.buffer_bytes(n, par.TWO_SHOT, torch.bfloat16) == n * 6
    assert par.buffer_bytes(n, par.ONE_SHOT, torch.bfloat16) == n * 4


def _two_shot_emulated(parts: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The two-shot kernel's arithmetic in torch on the CPU: rank r's block b
    sums its piece of slice r over the ranks' partials in rank order 0..m-1
    in f32 from zero, adds the bias and rounds once; every rank then holds
    every rank's sums (the gather copies bits)."""
    from vitparticlefiltertracker_tpu_torch.ops import peer_allreduce as par

    m, n, d = parts.shape[0], parts[0].numel(), bias.shape[0]
    flat = parts.reshape(m, n // 8, 8)
    bias8 = bias.float().reshape(d // 8, 8)
    out = torch.empty(n // 8, 8, dtype=bias.dtype)
    for pieces in par.two_shot_ranges(n, m, par.form_blocks(n, m, par.TWO_SHOT)):
        for lo, hi in pieces:
            acc = torch.zeros(hi - lo, 8)
            for p in range(m):
                acc = acc + flat[p, lo:hi]
            out[lo:hi] = (acc + bias8[torch.arange(lo, hi) * 8 % d // 8]).to(bias.dtype)
    return out.reshape(parts.shape[1:])


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [2, 3, 4])
def test_two_shot_order_equals_plain_bitwise(m, out_dtype):
    """The two-shot order, emulated, is bitwise the plain version's (the
    one-shot form's): at the scan's width on a cut short of its rows, and at
    a ragged length whose last slice and pieces are short."""
    from vitparticlefiltertracker_tpu_torch.ops.peer_allreduce import peer_all_reduce_plain

    rng = np.random.default_rng(m)
    for shape in ((5, 196, 768), (3, 17, 40)):
        parts = torch.from_numpy(rng.standard_normal((m, *shape)).astype(np.float32) * 3)
        bias = torch.from_numpy(rng.standard_normal(shape[-1]).astype(np.float32)).to(out_dtype)
        got = _two_shot_emulated(parts, bias)
        want = peer_all_reduce_plain(parts, bias)
        assert got.dtype == want.dtype == out_dtype
        assert torch.equal(got, want)


def test_peer_kernel_takes_cuda_tensors_only():
    """The kernel's wrapper on a CPU tensor raises (the mesh sends CPU
    tensors to the plain version; there is no fallback)."""
    from vitparticlefiltertracker_tpu_torch.ops.peer_allreduce import peer_all_reduce

    with pytest.raises(ValueError, match="CUDA tensors"):
        peer_all_reduce(torch.zeros(8), torch.zeros(8), None)


@pytest.fixture(scope="module")
def world_one(tmp_path_factory):
    """The Tracker class on a (1, 1, 1) mesh of one gloo rank and without a
    mesh, on dense, crop and teleport clips."""
    tmp = str(tmp_path_factory.mktemp("world_one"))
    cases = []
    for name, d, frames in (("dense", TINY, 6), ("crop", CROP, 6), ("teleport", REDETECT_CASES["dense"], 12)):
        src = open_source(d["io"]["source"], frames, tuple(d["io"]["frame_size"]), seed=0)
        cases.append((name, d, np.stack(src.frames), np.asarray(src.init_bbox, np.float32)))
    unsharded = {name: W.tracker_runs(d, clip, bbox, None, tmp if i == 0 else "")
                 for i, (name, d, clip, bbox) in enumerate(cases)}
    (sharded,) = W.spawn(1, W.world_one_runs, cases, tmp)
    return {"unsharded": unsharded, "sharded": sharded, "tmp": tmp, "cases": cases}


@pytest.mark.parametrize("name", ["dense", "crop", "teleport"])
def test_world_one_mesh_equals_unsharded_bitwise(world_one, name):
    """At one rank the sharded step, every collective issued on axes of 1,
    is the unsharded step bit for bit (what the card's world-size-1 run
    shows with NCCL)."""
    got, want = world_one["sharded"][name], world_one["unsharded"][name]
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_world_one_state_file_is_byte_equal_and_resumes_in_both(world_one):
    """Tracker.save on a mesh writes the unsharded state: each npz member's
    bytes equal the unsharded file's. The mesh tracker resumed from the
    unsharded file steps as the unsharded tracker resumed from it; the JAX
    package's Tracker resumes the sharded file and steps."""
    tmp = world_one["tmp"]
    with zipfile.ZipFile(os.path.join(tmp, "state.npz")) as a, zipfile.ZipFile(os.path.join(tmp, "unsharded.npz")) as b:
        assert sorted(a.namelist()) == sorted(b.namelist())
        for member in a.namelist():
            assert a.read(member) == b.read(member), member
    np.testing.assert_array_equal(world_one["sharded"]["dense"]["resumed"], world_one["unsharded"]["dense"]["resumed"])
    _, d, clip, _ = world_one["cases"][0]
    jt = jtr.Tracker(JConfig.from_dict(copy.deepcopy(d)))
    jt.resume(os.path.join(tmp, "state.npz"))
    rec = jt.step(clip[-1])
    assert np.isfinite(rec["position"]).all()


ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CLI_TINY = ["--device", "cpu", "--set", "model.variant=vit-t16", "--set", "model.image_size=64", "--set",
            "model.dtype=float32", "--set", "filter.num_particles=64", "--set", "io.num_frames=6", "--set",
            "io.frame_size=[224,224]"]


def _torchrun(argv: list, cwd, nproc: int = 2) -> subprocess.CompletedProcess:
    """python -m vitparticlefiltertracker_tpu_torch `argv` under torchrun
    (one process a rank, a rendezvous on localhost), in `cwd`."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", str(nproc), "-m",
           "vitparticlefiltertracker_tpu_torch", *argv]
    return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=240)


def test_track_command_under_torchrun_writes_once(tmp_path):
    """`torchrun --nproc-per-node 2 -m vitparticlefiltertracker_tpu_torch
    track --set runtime.mesh_particles=2`: every rank tracks; rank 0 alone
    writes the records and the state file, which match the one-process run
    (the sharded tolerance)."""
    from vitparticlefiltertracker_tpu_torch import cli

    proc = _torchrun(["track", *CLI_TINY, "--set", "runtime.mesh_particles=2", "--set",
                      f"io.output={tmp_path / 'mesh.jsonl'}", "--set", f"io.save_state={tmp_path / 'mesh.npz'}"],
                     tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert cli.main(["track", *CLI_TINY, "--set", f"io.output={tmp_path / 'one.jsonl'}", "--quiet"]) == 0
    got, want = ([json.loads(s) for s in (tmp_path / f).read_text().splitlines()] for f in ("mesh.jsonl", "one.jsonl"))
    assert [r["frame"] for r in got] == [r["frame"] for r in want] == [1, 2, 3, 4, 5]
    np.testing.assert_allclose([r["position"] for r in got], [r["position"] for r in want], rtol=1e-4, atol=1e-3)
    assert proc.stderr.count("saved state to") == 1 and (tmp_path / "mesh.npz").exists()


def test_stream_and_serve_commands_under_torchrun(tmp_path):
    """`stream` (the native ring as its source, the particle axis over 2)
    and `serve` (2 streams, one a rank on "bank") under torchrun: rank 0
    alone reads and writes; its records match the one-process commands'
    (the sharded tolerance; "bank" splits whole streams)."""
    from vitparticlefiltertracker_tpu_torch import cli

    for cmd, sets, mesh in (("stream", NATIVE_SETS, "runtime.mesh_particles=2"),
                            ("serve", CLI_TINY[2:] + ["--set", "runtime.streams=2"], "runtime.mesh_banks=2")):
        argv = [cmd, "--device", "cpu", "--quiet"]
        argv += list(sets) if cmd == "serve" else [x for v in sets for x in ("--set", v)]
        proc = _torchrun([*argv, "--set", mesh, "--set", f"io.output={tmp_path / (cmd + '_mesh.jsonl')}"], tmp_path)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert cli.main([*argv, "--set", f"io.output={tmp_path / (cmd + '_one.jsonl')}"]) == 0
        got, want = ([json.loads(x) for x in (tmp_path / f"{cmd}_{k}.jsonl").read_text().splitlines()]
                     for k in ("mesh", "one"))
        assert [(r["frame"], r.get("stream")) for r in got] == [(r["frame"], r.get("stream")) for r in want]
        assert len(got) == (5 if cmd == "stream" else 10)
        np.testing.assert_allclose([r["position"] for r in got], [r["position"] for r in want], rtol=1e-4, atol=1e-3)


def test_train_and_bench_commands_under_torchrun(tmp_path):
    """`train` under torchrun goes data-parallel over the ranks (JAX's log
    line, one checkpoint); `bench` on a particle mesh prints one JSON line."""
    proc = _torchrun(["train", "--device", "cpu", "--set", "model.variant=custom", "--set", "model.depth=1", "--set",
                      "model.dim=32", "--set", "model.heads=2", "--set", "model.mlp_dim=64", "--set",
                      "model.image_size=32", "--set", "model.dtype=float32", "--set", "train.steps=2", "--set",
                      "train.batch_size=4", "--set", "train.canvas=64", "--set", "train.window=32", "--set",
                      "train.warmup=1", "--set", "train.log_every=1", "--set",
                      f"train.checkpoint_out={tmp_path / 'w.npz'}"], tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stderr.count("data-parallel training over 2 devices") == 1  # rank 0 logs
    assert (tmp_path / "w.npz").exists()
    proc = _torchrun(["bench", *CLI_TINY, "--set", "runtime.mesh_particles=2", "--quiet"], tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [s for s in proc.stdout.splitlines() if s.startswith("{")]
    assert len(lines) == 1 and json.loads(lines[0])["config"]["num_particles"] == 64


@pytest.mark.parametrize("argv", [
    ["track", "--set", "runtime.mesh_particles=2", "--set", "io.source=camera:0"],
    ["track", "--set", "runtime.mesh_particles=2", "--set", "io.source=native-synthetic:moving-square"],
    ["stream", "--set", "runtime.mesh_particles=2"],
    ["serve", "--set", "runtime.mesh_banks=2"],
])
def test_commands_refuse_what_a_mesh_cannot_read_yet(argv):
    """Nothing is refused any more: a camera or the native ring as a mesh's
    source, and the stream and serve commands under a mesh, are read once
    on rank 0 and followed by the other ranks (runtime/streaming.py
    MeshFeed). Each command gets as far as the mesh, which one process
    cannot hold (ValueError), with no NotImplementedError and before any
    source is opened."""
    from vitparticlefiltertracker_tpu_torch import cli

    try:
        with pytest.raises(ValueError, match="needs 2 devices, have 1"):
            cli.main([*argv, "--device", "cpu"])
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
