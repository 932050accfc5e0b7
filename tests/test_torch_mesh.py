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
import os
import subprocess
import sys
import zipfile

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


@pytest.fixture(scope="module")
def layout():
    rng = np.random.default_rng(0)
    params = jax.tree.map(np.asarray, j_init_vit_params(jax.random.key(1), JVitSpec(**SPEC)))
    images = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    spec = dict(SPEC, dtype=torch.float32)
    ranks = W.spawn(2, W.mesh_layout, params, spec, images)
    want = vit_forward_tokens(bridge.params_from_numpy(params, VitSpec(**spec)), torch.from_numpy(images),
                              VitSpec(**spec)).numpy()
    return ranks, want


@pytest.mark.parametrize("shape,axis", [((2, 1, 1), "bank"), ((1, 2, 1), "particle"), ((1, 1, 2), "model")])
def test_mesh_axes_lay_ranks_out_as_jax(layout, shape, axis):
    """rank = (b P + p) M + m, as JAX reshapes its devices; each axis's group
    holds the ranks along it (all_gather in rank order, all_reduce summing),
    the size-1 axes a group of one rank that still gets its collective; each
    call counted once."""
    ranks, _ = layout
    for rank, out in enumerate(ranks):
        got = out[shape]
        assert got["coords"] == dict(zip(tmesh.AXES, (int(c) for c in np.unravel_index(rank, shape))))
        for ax in tmesh.AXES:
            members = [0.0, 1.0] if ax == axis else [float(rank)]
            assert got["gathered"][ax] == members
            assert got["summed"][ax] == sum(m + 1 for m in members)
        assert got["counted"] == (3, 3)


def test_make_mesh_larger_than_the_group_raises(layout):
    ranks, _ = layout
    for out in ranks:
        assert out["too_big"] == "mesh (2 bank x 2 particle x 1 model) needs 4 devices, have 2"


def test_tensor_parallel_vit_forward_matches_whole(layout):
    """The ViT (and its residual head) over (1, 1, 2): heads and MLP columns
    split, the row-parallel products all-reduced before their biases, gives
    the whole forward's tokens; both ranks hold the same tokens."""
    ranks, want = layout
    for out in ranks:
        np.testing.assert_allclose(out["tp_tokens"], want, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(out["tp_tokens"], ranks[0]["tp_tokens"])


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
    """A camera or the native ring as a mesh's source, and the stream and
    serve commands under a mesh, raise NotImplementedError pointing to
    ROADMAP.md, before any process group is made."""
    from vitparticlefiltertracker_tpu_torch import cli

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main([*argv, "--device", "cpu"])
    assert not torch.distributed.is_initialized()
