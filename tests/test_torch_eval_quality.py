"""The port's quality tool (tools/port_eval_quality.py) against the JAX
package's (tools/eval_quality.py) on the CPU, at a tiny size.

Both tools run the same clip, seeds and config (the tiny model below, the
JAX package's seeded random weights, which the port draws bit for bit), the
JAX side under HIGHEST matmul precision. The port's tracker is handed the
JAX package's noise draws (its init cloud, step noise and reseed normals,
keyed on the same seeds and frame indices) through the functions it draws
them with, so both trajectories are comparable at the e2e tolerance
(tests/test_torch_tracker_e2e.py: 0.5 px, flags exact).
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_tracker_e2e  # noqa: F401  (one intra-op thread a test worker)
import torch

from vitparticlefiltertracker_tpu.filters import particle as jpf
from vitparticlefiltertracker_tpu.runtime import tracker as jtr
from vitparticlefiltertracker_tpu_torch.filters import particle as tpf
from vitparticlefiltertracker_tpu_torch.runtime import tracker as ttr

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TINY_SETS = ["model.variant=custom", "model.depth=2", "model.dim=64", "model.heads=4", "model.mlp_dim=128",
             "model.image_size=64", "filter.num_particles=64"]
SEEDS = (0, 1)
FRAMES = 8
SIZE = (160, 192)


def _tool(name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tools():
    return _tool("eval_quality"), _tool("port_eval_quality")


def _banks(seed, idx):
    seeds = list(seed) if isinstance(seed, (list, tuple)) else [seed]
    idxs = list(idx) if isinstance(idx, (list, tuple)) else [idx] * len(seeds)
    return list(zip(seeds, idxs))


def _inject_jax_draws(monkeypatch, jcfg) -> None:
    """The port's tracker draws the JAX package's numbers: init_state's
    cloud from fold_in(key(seed), 0xFFFFFFFF), step noise from
    fold_in(key(seed), frame), the reseed normals from fold_in of that by
    0x5EED1 (runtime/tracker.py of each package), bank k with seed + k."""
    pfp = jtr._pf_params(jcfg)
    orig_init = ttr.init_state

    def step_noise(seed, idx, n, device, dtype=torch.float32):
        draws = [jpf.draw_step_noise(jax.random.fold_in(jax.random.key(int(s)), int(i)), n) for s, i in _banks(seed, idx)]
        stacked = [torch.from_numpy(np.stack([np.asarray(d[f]) for d in draws])) for f in range(4)]
        return tpf.StepNoise(*(x if isinstance(seed, (list, tuple)) else x[0] for x in stacked))

    def reseed(seed, idx, n, device):
        out = torch.from_numpy(np.stack([np.asarray(jax.random.normal(
            jax.random.fold_in(jax.random.fold_in(jax.random.key(int(s)), int(i)), 0x5EED1), (n, 2), jnp.float32))
            for s, i in _banks(seed, idx)]))
        return out if isinstance(seed, (list, tuple)) else out[0]

    def init_state(seed, center, n, params, dtype=torch.float32, cloud=None):
        seeds = list(seed) if isinstance(seed, (list, tuple)) else [seed]
        centers = center.reshape(len(seeds), 2)
        states = [orig_init(s, c, n, params, dtype, cloud=torch.from_numpy(np.array(jpf.init_state(
            jax.random.fold_in(jax.random.key(int(s)), 0xFFFFFFFF), jnp.asarray(c.numpy()), n, pfp).particles)))
            for s, c in zip(seeds, centers)]
        if not isinstance(seed, (list, tuple)):
            return states[0]
        return tpf.PFState(*(torch.stack(x) for x in zip(*states)))

    monkeypatch.setattr(ttr, "draw_step_noise", step_noise)
    monkeypatch.setattr(ttr, "draw_reseed_noise", reseed)
    monkeypatch.setattr(ttr, "init_state", init_state)


def test_tool_tables_match_the_jax_tool(tools):
    """The same geometries and clip overrides as tools/eval_quality.py."""
    jq, tq = tools
    assert tq.GEOMETRIES == jq.GEOMETRIES
    assert tq.CLIP_OVERRIDES == jq.CLIP_OVERRIDES


@pytest.mark.parametrize("geometry,clip,sets", [
    ("flagship", "moving-square", []),
    ("flagship", "teleport", []),
    ("eval4", "multi-2", ["runtime.banks=2"]),
])
def test_tiny_run_matches_the_jax_tool(tools, monkeypatch, geometry, clip, sets):
    """run_single / run_banked of both tools on the same tiny clips and
    seeds (--device cpu): per-frame errors within 0.5 px, lost flags equal,
    the same box diagonal; so the rows' RMSE, final-5, max and lost% agree."""
    jq, tq = tools
    geo = jq.GEOMETRIES[geometry]
    frames = 16 if clip == "teleport" else FRAMES  # teleport scores from the fourth frame after its reappearance
    jcfg = jq.build_cfg(geo, clip, "", TINY_SETS + sets)
    tcfg = tq.build_cfg(geo, clip, "", TINY_SETS + sets, device="cpu")
    assert tcfg.to_dict() == jcfg.to_dict()
    _inject_jax_draws(monkeypatch, jcfg)
    j_run = jq.run_banked if geo["banks"] > 1 else jq.run_single
    t_run = tq.run_banked if geo["banks"] > 1 else tq.run_single
    for seed in SEEDS:
        with jax.default_matmul_precision("highest"):
            j_err, j_lost, j_diag = j_run(jcfg, clip, seed, frames, SIZE, False)
        t_err, t_lost, t_diag = t_run(tcfg, clip, seed, frames, SIZE, False, "cpu")
        np.testing.assert_allclose(t_err, j_err, atol=0.5, err_msg=f"seed {seed}")
        np.testing.assert_array_equal(t_lost.astype(bool), np.asarray(j_lost).astype(bool), err_msg=f"seed {seed}")
        assert t_diag == pytest.approx(j_diag)


def test_main_writes_its_own_rows(tools, tmp_path):
    """The tool's command line on the CPU: one row a clip appended to its
    own JSONL and the table rendered beside it; the JAX tool's files are
    not touched."""
    _, tq = tools
    theirs = [os.path.join(ROOT, "docs", f) for f in ("quality_runs.jsonl", "QUALITY.md")]
    before = [os.path.getmtime(f) for f in theirs]
    runs, md = tmp_path / "runs.jsonl", tmp_path / "PORT_QUALITY.md"
    argv = ["--device", "cpu", "--seeds", "0", "--frames", "6", "--clips", "moving-square", "needle",
            "--frame-size", *map(str, SIZE), "--runs", str(runs), "--md", str(md),
            *(x for s in TINY_SETS for x in ("--set", s))]
    assert tq.main(argv) == 0
    rows = [json.loads(line) for line in runs.read_text().splitlines()]
    assert [r["clip"] for r in rows] == ["moving-square", "needle"]
    assert all(r["device"] == "cpu" and r["weights"] == "random" and np.isfinite(r["rmse_px"]) for r in rows)
    table = md.read_text()
    assert "| flagship | moving-square | random |" in table and "| flagship | needle | random |" in table
    assert [os.path.getmtime(f) for f in theirs] == before
