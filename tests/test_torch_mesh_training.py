"""Port parity on a mesh: data-parallel training (training/train.py:
make_data_mesh, build_train_step(..., mesh=), train_features over the
process group) on four gloo ranks on the CPU, against the unsharded step
and the JAX package's.

Mirrors tests/test_training.py:97 (the data-parallel step equals the
unsharded one: loss rtol 1e-4, weights atol 2e-5) and
tests/test_mesh_wiring.py:122 (train_features goes data-parallel over every
device). The ranks run tests/torch_mesh_workers.py (no JAX), in one spawn.
"""

import copy
import json
import os

import jax
import numpy as np
import pytest
from test_torch_training import (
    GRAD_TOL,
    LOSS_RTOL,
    PARAM_ATOL,
    _np_tree,
    jax_step_inputs,
    loss_kw,
    tiny_train_dict,
)
import torch_mesh_workers as W

from vitparticlefiltertracker_tpu.config import Config as JConfig
from vitparticlefiltertracker_tpu.training import objective as jobj
from vitparticlefiltertracker_tpu.training import train as jtrain
from vitparticlefiltertracker_tpu_torch.config import Config
from vitparticlefiltertracker_tpu_torch.parallel.mesh import Mesh
from vitparticlefiltertracker_tpu_torch.training import train as ttrain

WORLD = 4
BATCH = 8  # two pairs a rank


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's step-0 loss and gradients on its own draws; the port's step on
    those draws and two steps on its own, unsharded here and on a ("data",)
    mesh of four ranks; train_features on the four ranks (a batch they
    divide, and one they do not)."""
    d = tiny_train_dict(batch_size=BATCH)
    jcfg = JConfig.from_dict(copy.deepcopy(d))
    init_fn, _ = jtrain.build_train_step(jcfg)
    jp, _ = init_fn()
    jb, keys, tb, draws = jax_step_inputs(jcfg, 0)
    es, kw = jtrain._train_embed_spec(jcfg), loss_kw(jcfg)
    (loss, _), grads = jax.jit(jax.value_and_grad(lambda p: jobj.batch_loss(p, es, jb, keys, **kw), has_aux=True))(jp)
    batch = {k: v.numpy() for k, v in tb._asdict().items()}
    loss_draws = {k: v.numpy() for k, v in draws._asdict().items()}
    tmp = tmp_path_factory.mktemp("dp_train")
    feats = dict(copy.deepcopy(d), train=dict(d["train"], steps=2, log_every=1,
                                              checkpoint_out=str(tmp / "w.npz"), metrics_out=str(tmp / "m.jsonl")))
    odd = dict(copy.deepcopy(d), train=dict(d["train"], steps=1, batch_size=6, log_every=1,
                                            checkpoint_out=str(tmp / "odd" / "w.npz"),
                                            metrics_out=str(tmp / "odd" / "m.jsonl")))
    cases = [("steps", "train_steps", dict(cfg_dict=d, batch=batch, draws=loss_draws, data=WORLD)),
             ("features", "train_features_run", dict(cfg_dict=feats)),
             ("odd", "train_features_run", dict(cfg_dict=odd))]
    ranks = W.spawn(WORLD, W.train_scenarios, cases)
    return {"jax_loss": float(loss), "jax_grads": _np_tree(grads), "ranks": ranks, "feats": feats,
            "unsharded": W.train_steps(d, batch, loss_draws), "odd": odd}


def test_dp_grads_match_unsharded_and_jax(runs):
    """Step 0 on JAX's draws of the global batch, each rank embedding its
    quarter: the all-reduced loss and gradients are the unsharded step's and
    JAX's (loss rtol 1e-4, gradients 2e-5)."""
    want = runs["unsharded"]["grads0"]
    for r in runs["ranks"]:
        got = r["steps"]["grads0"]
        for ref_loss in (want["loss"], runs["jax_loss"]):
            np.testing.assert_allclose(got["loss"], ref_loss, rtol=LOSS_RTOL)
        for k, v in got["metrics"].items():
            np.testing.assert_allclose(v, want["metrics"][k], rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
        for k, g in got["grads"].items():
            np.testing.assert_allclose(g, want["grads"][k], rtol=0, atol=GRAD_TOL, err_msg=k)
            np.testing.assert_allclose(g, runs["jax_grads"][k], rtol=0, atol=GRAD_TOL, err_msg=k)


def test_sharded_train_step_matches_unsharded(runs):
    """tests/test_training.py:97: two data-parallel steps on the step
    generator's own draws give the unsharded step's loss (rtol 1e-4) and
    weights (atol 2e-5); the weights stay replicated, bit for bit, on every
    rank (AdamW on the same all-reduced gradients)."""
    want = runs["unsharded"]
    got = [r["steps"] for r in runs["ranks"]]
    for r in got:
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=LOSS_RTOL)
        for k, v in r["params"].items():
            np.testing.assert_allclose(v, want["params"][k], rtol=0, atol=PARAM_ATOL, err_msg=k)
            np.testing.assert_array_equal(v, got[0]["params"][k], err_msg=k)


def test_train_features_auto_data_parallel(runs):
    """tests/test_mesh_wiring.py:122: train_features over a process group of
    four ranks whose count divides the batch logs JAX's data-parallel line;
    rank 0 alone writes the checkpoint and the metrics file."""
    logs = [r["features"] for r in runs["ranks"]]
    for lines in logs:
        assert any("data-parallel training over 4 devices" in s for s in lines), lines
        metrics = [json.loads(s) for s in lines if s.startswith("{")]
        assert metrics and np.isfinite(metrics[-1]["loss"])
        for m, m0 in zip(metrics, (json.loads(s) for s in logs[0] if s.startswith("{"))):
            m.pop("wall_s"), m0.pop("wall_s")
            assert m == m0  # global means, the same on every rank
    _rank_zero_wrote(runs["feats"]["train"], logs, [1, 2])


def test_train_features_batch_not_divisible_runs_single_device(runs):
    """A batch the four ranks do not divide: every rank trains alone, with
    JAX's log line, and rank 0 of the process group still writes the
    checkpoint and the metrics file alone."""
    logs = [r["odd"] for r in runs["ranks"]]
    for lines in logs:
        assert any("train.batch_size 6 not divisible by 4 devices; running single-device" in s for s in lines)
    _rank_zero_wrote(runs["odd"]["train"], logs, [1])


def _rank_zero_wrote(tr: dict, logs: list, steps: list) -> None:
    """Only rank 0 logged the save; the metrics file holds one line a logged
    step and the checkpoint is there."""
    saved = [any(s == f"saved {tr['checkpoint_out']}" for s in lines) for lines in logs]
    assert saved == [True] + [False] * (len(logs) - 1), saved
    with open(tr["metrics_out"]) as f:
        assert [json.loads(s)["step"] for s in f] == steps
    assert os.path.getsize(tr["checkpoint_out"]) > 0


def test_build_train_step_batch_not_divisible_raises():
    """As the JAX package's build_train_step: the data axis must divide
    train.batch_size (checked before any collective)."""
    mesh = Mesh(("data",), (3,), 0, {}, "gloo", 0)
    with pytest.raises(ValueError, match="must divide by the data-parallel axis 3"):
        ttrain.build_train_step(Config.from_dict(tiny_train_dict(batch_size=BATCH)), "cpu", mesh=mesh)
