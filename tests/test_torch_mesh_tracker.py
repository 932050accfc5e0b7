"""Port parity on a mesh: the trackers (runtime/tracker.py, runtime/banked.py)
with runtime.mesh_* over four gloo ranks on the CPU.

The ranks are spawned processes (tests/torch_mesh_workers.py, which imports
no JAX); one spawn runs every case of this file, in the same order on every
rank, and the tests read its results. Each sharded run is held three ways:

- against the port's unsharded run of the same function here, at the JAX
  suite's sharded tolerance (rtol 1e-4, atol 1e-3 on positions;
  tests/test_mesh_wiring.py, tests/test_tracker_e2e.py:363-438). A rank
  scores its particles with the step's own arithmetic, but a product over
  N / P rows may round otherwise than one over N on the CPU; at one rank
  the sharded step is the unsharded one bit for bit
  (tests/test_torch_mesh.py);
- against the JAX package's unsharded step on the same clip, weights and
  injected draws, at the e2e parity tolerances (test_torch_tracker_e2e:
  position 0.5 px, `resampled` and `lost` exact, conf 1e-3);
- every rank against every other: the same outputs and branch predicates.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_tracker_e2e  # noqa: F401  (one intra-op thread a test worker)
import torch
import torch_mesh_workers as W
from test_torch_redetect import CASES as REDETECT_CASES

from vitparticlefiltertracker_tpu.config import Config as JConfig
from vitparticlefiltertracker_tpu.filters import particle as jpf
from vitparticlefiltertracker_tpu.io.video import open_source as j_open_source
from vitparticlefiltertracker_tpu.models.params import resolve_vit_params
from vitparticlefiltertracker_tpu.runtime import banked as jbk
from vitparticlefiltertracker_tpu.runtime import tracker as jtr
from vitparticlefiltertracker_tpu_torch.config import Config as TConfig
from vitparticlefiltertracker_tpu_torch.io.video import open_source
from vitparticlefiltertracker_tpu_torch.runtime import tracker as ttr

WORLD = 4
FRAMES = 6  # one init frame + 5 steps
# tests/test_mesh_wiring.py's tiny tracker, with 4 heads so that "model" can split them.
TINY = {
    "model": {"variant": "custom", "depth": 2, "dim": 64, "heads": 4, "mlp_dim": 128, "image_size": 64,
              "dtype": "float32", "checkpoint": ""},
    "filter": {"num_particles": 64, "motion": {"sigma_pos": 3.0}},
    "tracker": {"mode": "dense"},
    "io": {"source": "synthetic:moving-square", "num_frames": FRAMES, "frame_size": [224, 224]},
}
CROP = copy.deepcopy(TINY)
CROP["tracker"] = {"mode": "crop", "crop_impl": "window-pallas"}
SHARDED_RTOL, SHARDED_ATOL = 1e-4, 1e-3  # tests/test_mesh_wiring.py, tests/test_tracker_e2e.py:384-438


def jax_reference(cfg_dict, frames=FRAMES, banks=0) -> dict:
    """The JAX package's unsharded step over `frames` frames of the config's
    source (seed 0), one filter or `banks` banks on its box, with every draw
    it makes (initial cloud, step noise, reseed normals) kept for injection
    into the port -> numpy inputs for torch_mesh_workers.run_fns and the JAX
    outputs ("jax", TrackOutputs; not sent to the ranks)."""
    d = copy.deepcopy(cfg_dict)
    if banks:
        d.setdefault("runtime", {})["banks"] = banks
    jcfg = JConfig.from_dict(copy.deepcopy(d))
    n = jcfg.filter.num_particles
    src = j_open_source(jcfg.io.source, frames, tuple(jcfg.io.frame_size), seed=0)
    clip, bbox = np.asarray(src.frames), np.asarray(src.init_bbox, np.float32)
    jp = resolve_vit_params(jcfg)
    seeds = np.arange(max(banks, 1), dtype=np.int32) + jcfg.filter.seed
    keys = [jax.random.key(int(s)) for s in seeds]
    bboxes = np.tile(bbox, (len(seeds), 1))
    pfp = jtr._pf_params(jcfg)
    cloud = np.stack([np.asarray(jpf.init_state(jax.random.fold_in(key, 0xFFFFFFFF), jnp.asarray(b[:2] + b[2:] / 2),
                                                n, pfp).particles) for key, b in zip(keys, bboxes)])
    noises, reseeds = [], []
    for i in range(frames - 1):
        fkeys = [jax.random.fold_in(key, i) for key in keys]
        drawn = [jpf.draw_step_noise(fk, n) for fk in fkeys]
        noises.append(tuple(np.stack([np.asarray(x[f]) for x in drawn]) for f in range(4)))
        reseeds.append(np.stack([np.asarray(jax.random.normal(jax.random.fold_in(fk, 0x5EED1), (n, 2), jnp.float32))
                                 for fk in fkeys]))
    with jax.default_matmul_precision("highest"):
        if banks:
            jinit, jstep, _ = jbk.build_banked_fns(jcfg)
            jstate = jax.jit(jinit)(jp, jnp.asarray(clip[0]), jnp.asarray(bboxes), jnp.asarray(seeds))
        else:
            jf = jtr.build_tracker_fns(jcfg)
            jinit, jstep = jf.init, jf.step
            jstate = jax.jit(jinit)(jp, jnp.asarray(clip[0]), jnp.asarray(bbox), jnp.int32(seeds[0]))
        jstep = jax.jit(jstep)
        outs = []
        for i in range(1, frames):
            jstate, jo = jstep(jp, jstate, jnp.asarray(clip[i]))
            outs.append(jax.tree.map(np.asarray, jo))
    one = (lambda x: x) if banks else (lambda x: x[0])
    return {"cfg": d, "params": jax.tree.map(np.asarray, jp), "clip": clip, "bbox": bboxes if banks else bbox,
            "seeds": seeds, "cloud": one(cloud), "noises": [tuple(one(x) for x in nz) for nz in noises],
            "reseeds": [one(r) for r in reseeds], "jax": outs}


def _compare_jax(rows: np.ndarray, jouts, banks=None) -> None:
    """Port rows [T, 10 K] against the JAX outputs at the e2e tolerances."""
    for i, (row, jo) in enumerate(zip(rows, jouts)):
        to = ttr.unpack_track_output(torch.from_numpy(row), banks)
        np.testing.assert_allclose(to.position.numpy(), jo.position, atol=0.5, err_msg=f"frame {i + 1}")
        np.testing.assert_array_equal(to.resampled.numpy(), jo.resampled, err_msg=f"frame {i + 1}")
        np.testing.assert_array_equal(to.lost.numpy(), jo.lost, err_msg=f"frame {i + 1}")
        np.testing.assert_allclose(to.conf.numpy(), jo.conf, atol=1e-3, err_msg=f"frame {i + 1}")


def _banked_rows(results: list, k: int) -> np.ndarray:
    """The ranks' [T, 10 K_local] rows of run_fns -> [T, 10 K] in the packed
    layout, each rank's banks in place (ranks sharing a bank slice agree)."""
    out = np.zeros((results[0]["rows"].shape[0], 10, k), np.float32)
    for r in results:
        lo, hi = r["banks"]
        out[:, :, lo:hi] = _fields(r["rows"], hi - lo)
    return _unfields(out)


def _fields(rows: np.ndarray, k: int) -> np.ndarray:
    """[T, 10 K] packed rows -> [T, 10, K]: value v of bank b at [:, v, b]."""
    cols, i = [], 0
    for width in (2, 2, 2, 1, 1, 1, 1):
        block = rows[:, i * k:(i + width) * k].reshape(rows.shape[0], k, width)
        cols.extend(block[:, :, w] for w in range(width))
        i += width
    return np.stack(cols, axis=1)


def _unfields(f: np.ndarray) -> np.ndarray:
    """_fields' inverse."""
    t, _, k = f.shape
    out, v = [], 0
    for width in (2, 2, 2, 1, 1, 1, 1):
        out.append(np.stack([f[:, v + w] for w in range(width)], axis=-1).reshape(t, k * width))
        v += width
    return np.concatenate(out, axis=1)


REFS = {"dense": (TINY, 0), "crop": (CROP, 0), "banked": (TINY, 2), "teleport": (REDETECT_CASES["dense"], 0)}
FNS_CASES = [  # (name, reference, mesh (bank, particle, model), log the branches)
    ("particle", "dense", (1, 4, 1), False),
    ("particle-crop", "crop", (1, 4, 1), False),
    ("tp", "dense", (1, 2, 2), False),
    ("banked", "banked", (2, 2, 1), False),
    ("banked-tp", "banked", (2, 1, 2), False),
    ("teleport", "teleport", (1, 4, 1), True),
    ("teleport-tp", "teleport", (1, 1, 2), True),
    ("teleport-tp-particle", "teleport", (1, 2, 2), True),
]


def _class_inputs(tmp: str) -> tuple[list, dict]:
    """The Tracker-class cases (torch_mesh_workers.class_scenarios) and
    their unsharded results, run here."""
    src = open_source("synthetic:moving-square", FRAMES, (224, 224), seed=0)
    clip, bbox = np.stack(src.frames), np.asarray(src.init_bbox, np.float32)
    five = open_source("synthetic:moving-square", 5, (224, 224), seed=0)
    arr, truth = np.stack(five.frames), np.asarray(five.truth)
    streams = [open_source("synthetic:moving-square", 5, (224, 224), seed=i) for i in range(2)]
    sclip = np.stack([np.stack(s.frames) for s in streams], axis=1)  # [T, K, H, W, 3]
    sboxes = np.stack([np.asarray(s.init_bbox, np.float32) for s in streams])
    multi = open_source("synthetic:multi-2", FRAMES, (224, 224), seed=0)
    mclip, mboxes = np.stack(multi.frames), np.asarray(multi.init_bbox, np.float32)
    cases = {
        "state": ("tracker_runs", dict(cfg_dict=TINY, clip=clip, bbox=bbox, state_dir=tmp)),
        "tp-class": ("tracker_runs", dict(cfg_dict=TINY, clip=clip, bbox=bbox)),
        "chunk": ("chunk_run", dict(cfg_dict=TINY, arr=arr, truth=truth, bbox=np.asarray(five.init_bbox, np.float32))),
        "streams": ("banked_runs", dict(cfg_dict=TINY, first=sclip[0], steps=sclip[1:], bboxes=sboxes, kind="streams")),
        "multi": ("banked_runs", dict(cfg_dict=TINY, first=mclip[0], steps=mclip[1:], bboxes=mboxes, kind="banked",
                                      reinit=(1, 3, mboxes[0]))),
    }
    shapes = {"state": (1, 4, 1), "tp-class": (1, 2, 2), "chunk": (1, 4, 1), "streams": (2, 2, 1),
              "multi": (2, 2, 1)}
    unsharded = {name: getattr(W, fn)(**kw) for name, (fn, kw) in cases.items()}  # writes unsharded.npz first
    sharded = [(name, fn, dict(kw, shape=shapes[name])) for name, (fn, kw) in cases.items()]
    return sharded, unsharded


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on four ranks (one spawn), beside the JAX references and
    the port's unsharded runs of the same cases."""
    refs = {name: jax_reference(d, frames=12 if name == "teleport" else FRAMES, banks=b)
            for name, (d, b) in REFS.items()}
    sent = {name: {k: v for k, v in ref.items() if k != "jax"} for name, ref in refs.items()}
    tmp = str(tmp_path_factory.mktemp("mesh_state"))
    class_cases, class_unsharded = _class_inputs(tmp)
    ranks = W.spawn(WORLD, W.tracker_and_class_scenarios, sent, FNS_CASES, class_cases)
    unsharded = {name: W.run_fns(sent[name], None, name == "teleport") for name in REFS}
    return {"refs": refs, "ranks": ranks, "unsharded": unsharded, "class_unsharded": class_unsharded, "tmp": tmp}


def _fns(runs, case):
    """The ranks' results of a case (the ranks of its mesh: a (1, 1, 2) mesh
    holds two of the four)."""
    return [r[0][case] for r in runs["ranks"] if r[0][case] is not None]


def _cls(runs, case):
    return [r[1][case] for r in runs["ranks"]]


@pytest.mark.parametrize("case,ref", [("particle", "dense"), ("particle-crop", "crop"), ("teleport", "teleport")])
def test_particle_sharded_step_matches_unsharded(runs, case, ref):
    """tests/test_mesh_wiring.py:28: the particle-sharded step (dense: the
    fused cell scorer on N / 4 particles a rank; crop: K2's plain version
    and one ViT forward on N / 4 crops a rank) matches the unsharded step,
    its flags exactly, and every rank holds the same state bit for bit."""
    want = runs["unsharded"][ref]
    got = _fns(runs, case)
    for r in got:
        np.testing.assert_allclose(r["rows"], want["rows"], rtol=SHARDED_RTOL, atol=SHARDED_ATOL)
        np.testing.assert_array_equal(r["rows"][:, 8:], want["rows"][:, 8:])  # resampled, lost
        for a, b in zip(r["state"], got[0]["state"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case,ref", [("particle", "dense"), ("particle-crop", "crop"), ("tp", "dense"),
                                      ("teleport", "teleport"), ("teleport-tp", "teleport"),
                                      ("teleport-tp-particle", "teleport")])
def test_sharded_step_matches_jax(runs, case, ref):
    """The sharded port against the JAX package's unsharded step on the same
    weights, clip and draws (e2e tolerances)."""
    for r in _fns(runs, case):
        _compare_jax(r["rows"], runs["refs"][ref]["jax"])


def test_tensor_parallel_matches_replicated(runs):
    """tests/test_tracker_e2e.py:412: heads and MLP columns split over
    "model" (with "particle" 2) give the replicated trajectory; the ranks
    agree exactly (the all-reduce hands every rank the same sums)."""
    want = runs["unsharded"]["dense"]["rows"]
    got = _fns(runs, "tp")
    for r in got:
        np.testing.assert_allclose(r["rows"], want, rtol=SHARDED_RTOL, atol=SHARDED_ATOL)
        np.testing.assert_array_equal(r["rows"], got[0]["rows"])


@pytest.mark.parametrize("case", ["teleport-tp", "teleport-tp-particle"])
def test_robust_tensor_parallel_matches_unsharded_bitwise_across_ranks(runs, case):
    """The teleport (robust) config, whose probe and scan run ViT forwards,
    with "model" 2 ((1, 1, 2), and (1, 2, 2) with "particle" 2), eager:
    every row-parallel sum of the trunk, the head and the scan's forward
    goes through the peer all-reduce's plain version. The rows match the
    unsharded step's, the flags exactly; the ranks hold the same state bit
    for bit and take the same branches as the unsharded step."""
    want = runs["unsharded"]["teleport"]
    got = _fns(runs, case)
    for r in got:
        np.testing.assert_allclose(r["rows"], want["rows"], rtol=SHARDED_RTOL, atol=SHARDED_ATOL)
        np.testing.assert_array_equal(r["rows"][:, 8:], want["rows"][:, 8:])
        assert r["log"] == want["log"]
        for a, b in zip(r["state"], got[0]["state"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["banked", "banked-tp"])
def test_banked_sharded_matches_unsharded_and_jax(runs, case):
    """tests/test_tracker_e2e.py:385 and :412 on (2, 2, 1) and (2, 1, 2): the
    banks ride "bank" (each rank steps its bank, seeded with its global
    index), particles or heads inside a bank; the gathered rows match the
    unsharded banked step and the JAX package's vmapped one."""
    rows = _banked_rows(_fns(runs, case), 2)
    np.testing.assert_allclose(rows, runs["unsharded"]["banked"]["rows"], rtol=SHARDED_RTOL, atol=SHARDED_ATOL)
    _compare_jax(rows, runs["refs"]["banked"]["jax"], banks=2)


def test_teleport_branches_taken_alike_on_every_rank(runs):
    """On the teleport clip (probe on lost frames, scan after 2) every rank
    of a particle mesh computes the same predicates, so each IF-node body,
    whose forward would hold collectives on a model axis, runs on the same
    frames everywhere: the same (branch, predicate) log on every rank as
    the unsharded step's, with probes and scans taken."""
    want = runs["unsharded"]["teleport"]["log"]
    assert ("probe", True) in want and ("scan", True) in want
    for r in _fns(runs, "teleport"):
        assert r["log"] == want


def test_sharded_state_file_has_the_unsharded_layout_and_resumes(runs):
    """Tracker.save on a particle mesh writes (on rank 0) the whole state in
    the unsharded layout: the same members, shapes and dtypes, the values at
    the sharded tolerance (byte for byte at one rank: tests/test_torch_mesh.py).
    A sharded Tracker resumes the unsharded file and steps as the unsharded
    tracker does; the JAX package reads the sharded file."""
    tmp = runs["tmp"]
    with np.load(os.path.join(tmp, "state.npz")) as a, np.load(os.path.join(tmp, "unsharded.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype and a[name].shape == b[name].shape, name
            np.testing.assert_allclose(a[name], b[name], rtol=SHARDED_RTOL, atol=SHARDED_ATOL, err_msg=name)
    want = runs["class_unsharded"]["state"]
    for r in _cls(runs, "state"):
        np.testing.assert_allclose(r["resumed"], want["resumed"], rtol=SHARDED_RTOL, atol=SHARDED_ATOL)
    js = jtr.load_tracker_state(os.path.join(tmp, "state.npz"))
    ts = ttr.load_tracker_state(os.path.join(tmp, "state.npz"))
    np.testing.assert_array_equal(np.asarray(js.pf.particles), ts.pf.particles.numpy())
    np.testing.assert_array_equal(np.asarray(js.center), ts.center.numpy())


def test_single_tracker_particle_sharded_matches_unsharded(runs):
    """tests/test_mesh_wiring.py:28 through the Tracker class (its own
    draws): the records of a particle mesh equal the unsharded ones."""
    want = runs["class_unsharded"]["state"]
    for r in _cls(runs, "state"):
        np.testing.assert_allclose(r["positions"], want["positions"], rtol=SHARDED_RTOL, atol=SHARDED_ATOL)
        np.testing.assert_array_equal(r["flags"], want["flags"])


def test_tensor_parallel_tracker_class_matches_unsharded(runs):
    want = runs["class_unsharded"]["tp-class"]
    for r in _cls(runs, "tp-class"):
        np.testing.assert_allclose(r["positions"], want["positions"], rtol=SHARDED_RTOL, atol=SHARDED_ATOL)


def test_single_tracker_sharded_chunk_step(runs):
    """tests/test_mesh_wiring.py:48: step_chunk_device under a particle mesh."""
    want = runs["class_unsharded"]["chunk"]
    assert want.shape == (4, 2)
    for r in _cls(runs, "chunk"):
        np.testing.assert_allclose(r, want, rtol=SHARDED_RTOL, atol=SHARDED_ATOL)


def test_multistream_sharded_matches_unsharded(runs):
    """tests/test_mesh_wiring.py:95: streams ride "bank" on (2, 2, 1); every
    rank returns both streams' rows."""
    want = runs["class_unsharded"]["streams"]
    for r in _cls(runs, "streams"):
        for key in ("rows", "clip"):
            np.testing.assert_allclose(r[key], want[key], rtol=SHARDED_RTOL, atol=SHARDED_ATOL)


def test_multitracker_sharded_with_reinit_matches_unsharded(runs):
    """tests/test_tracker_e2e.py:363 and :385 through MultiTracker on
    (2, 2, 1): step, step_packed, track_clip_device and reinit_bank (on the
    rank that holds the bank) as without a mesh."""
    want = runs["class_unsharded"]["multi"]
    for r in _cls(runs, "multi"):
        for key in ("rows", "recs", "clip"):
            np.testing.assert_allclose(r[key], want[key], rtol=SHARDED_RTOL, atol=SHARDED_ATOL)


def test_single_tracker_mesh_banks_rejected():
    """tests/test_mesh_wiring.py:89: mesh_banks belongs to the banked tracker."""
    d = copy.deepcopy(TINY)
    d["runtime"] = {"mesh_banks": 2, "mesh_particles": 2}
    with pytest.raises(ValueError, match="mesh_banks"):
        ttr.Tracker(TConfig.from_dict(d), device="cpu")


def _unjoined_mesh(bank=1, particle=1, model=1):
    """A Mesh of these axis sizes at rank 0 with no process group behind it:
    enough for the checks a tracker makes before its first collective."""
    from vitparticlefiltertracker_tpu_torch.parallel.mesh import AXES, Mesh

    return Mesh(AXES, (bank, particle, model), 0, {}, "gloo", 0)


@pytest.mark.parametrize("kind,shape,match", [
    ("banked", (2, 1, 1), "runtime.banks 3 must divide by runtime.mesh_banks 2"),
    ("streams", (2, 1, 1), "num_streams 3 must divide by runtime.mesh_banks 2"),
    ("single", (1, 3, 1), "num_particles 64 must divide by the particle axis 3"),
    ("single", (1, 1, 3), "tensor-parallel axis 3 must divide model.heads"),
    ("single", (2, 1, 1), "mesh_banks > 1 requires runtime.banks > 1"),
])
def test_mesh_axis_that_does_not_divide_raises(kind, shape, match):
    """Every axis that does not divide what it shards raises ValueError (as
    in the JAX package), before any collective."""
    from vitparticlefiltertracker_tpu_torch.runtime.banked import MultiStreamTracker, MultiTracker

    d = copy.deepcopy(TINY)
    d["runtime"] = {"banks": 3} if kind == "banked" else {}
    cfg, mesh = TConfig.from_dict(d), _unjoined_mesh(*shape)
    with pytest.raises(ValueError, match=match):
        if kind == "banked":
            MultiTracker(cfg, device="cpu", mesh=mesh)
        elif kind == "streams":
            MultiStreamTracker(cfg, 3, device="cpu", mesh=mesh)
        else:
            ttr.Tracker(cfg, device="cpu", mesh=mesh)


@pytest.mark.parametrize("config,shape,peers,refused", [
    ("teleport", (1, 1, 2), False, True), ("teleport", (1, 2, 2), False, True),
    ("teleport", (1, 1, 2), True, False), ("teleport", (1, 2, 2), True, False),
    ("teleport", (1, 4, 1), False, False), ("dense", (1, 1, 2), False, False)])
def test_graph_step_refuses_cross_card_collectives_in_its_branches(config, shape, peers, refused):
    """F6, what is left of it: the probe's and the scan's IF-node bodies run
    a ViT forward, whose "model" sums only the peer all-reduce kernel can
    serve inside a conditional node. A mesh with its peer group (every CUDA
    mesh: ops/peer_allreduce.PeerGroup, built at mesh build) is not
    refused; a "model" axis above 1 without one is (NotImplementedError
    naming ROADMAP.md). A particle axis and a config without the branches
    never are; the eager step on the CPU never is (tests above)."""
    d = REDETECT_CASES["dense"] if config == "teleport" else TINY
    cfg = TConfig.from_dict(copy.deepcopy(d))
    mesh = _unjoined_mesh(*shape)
    mesh.peers = object() if peers else None  # a stand-in: the check reads only whether there is one
    if refused:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ttr.refuse_cross_card_branches(cfg, mesh)
    else:
        ttr.refuse_cross_card_branches(cfg, mesh)


@pytest.mark.parametrize("infos,access,error", [
    ([("a", "0000:18:00.0"), ("a", "0000:2a:00.0")], 1, None),  # peer access over NVLink
    ([("a", "0000:18:00.0"), ("a", "0000:18:00.0")], 0, None),  # two processes on one card
    ([("a", "0000:18:00.0"), ("b", "0000:18:00.0")], 1, "another host"),
    ([("a", "0000:18:00.0"), ("a", "0000:2a:00.0")], 0, "no peer access"),
    ([("a", "0000:18:00.0"), ("a", "0000:2a:00.0")], -1, "cannot see"),
])
def test_peer_group_refuses_cards_it_cannot_map(infos, access, error):
    """The check a CUDA mesh's "model" group makes at build, before any
    buffer: every other rank's card must be this one, or one it has peer
    access to on the same host; otherwise RuntimeError naming ROADMAP.md
    (there is no NCCL fallback)."""
    from vitparticlefiltertracker_tpu_torch.ops.peer_allreduce import check_peer_access

    if error is None:
        check_peer_access(infos, 0, lambda bus: access)
    else:
        with pytest.raises(RuntimeError, match=f"{error}.*ROADMAP"):
            check_peer_access(infos, 0, lambda bus: access)
