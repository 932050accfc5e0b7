"""The training probe (vitparticlefiltertracker_tpu_torch/training/probe.py)
and the probe-selected checkpoint of train_features, on the CPU, as
tests/test_training.py holds the JAX package's.

The probe's trackers are built once and get each evaluation's weights in
place (Tracker.load_weights): after a weight change a probe scores what a
probe built fresh on those weights scores. The port's trackers draw their
own noise (a torch.Generator keyed on seed and frame), so the RMSE is the
port's own, not compared with the JAX package's.
"""

import json

import numpy as np
import test_torch_tracker_e2e  # noqa: F401  (one intra-op thread a test worker)

from vitparticlefiltertracker_tpu_torch.config import Config
from vitparticlefiltertracker_tpu_torch.models import params as tparams
from vitparticlefiltertracker_tpu_torch.models.embedder import DenseEmbedSpec
from vitparticlefiltertracker_tpu_torch.training import probe as tprobe
from vitparticlefiltertracker_tpu_torch.training import train as ttrain

SMALL = {"model": {"variant": "vit-t16", "image_size": 64, "dtype": "float32", "use_flash_attention": False},
         "train": {"batch_size": 4, "canvas": 96, "window": 64}}


def _weights(cfg, seed: int) -> dict:
    return tparams.init_vit_params(tparams.jax_random.key(seed), DenseEmbedSpec.from_config(cfg).vit)


def _probe(cfg, clips=("moving-square", "lookalikes")):
    return tprobe.make_probe(cfg, clips=clips, frames=5, frame_size=(128, 128), num_particles=64, image_size=64,
                             device="cpu")


def test_probe_applies_lookalikes_robustness_gates():
    """The lookalikes clip runs under the eval's robustness stack (its own
    tracker), ungated clips share one plain tracker; a "+blur" clip is its
    family's clip through _blur_clip."""
    assert "tracker.relock_conf_ratio" in tprobe.PROBE_OVERRIDES["lookalikes"]
    cfg = Config.from_dict(SMALL)
    out = _probe(cfg, ("moving-square", "lookalikes", "lookalikes+blur"))(_weights(cfg, 0))
    assert set(out) == {"probe_moving-square", "probe_lookalikes", "probe_lookalikes+blur", "probe_rmse"}
    assert all(np.isfinite(v) for v in out.values())
    assert np.isclose(out["probe_rmse"], np.mean([v for k, v in out.items() if k != "probe_rmse"]))


def test_probe_after_a_weight_change_equals_a_fresh_probe():
    cfg = Config.from_dict(SMALL)
    w1, w2 = _weights(cfg, 0), _weights(cfg, 1)
    probe = _probe(cfg)
    first = probe(w1)
    again = probe(w2)
    assert again == _probe(cfg)(w2)
    assert again != first


def test_train_features_keeps_the_best_probe_weights(tmp_path):
    """eval_every: a step-0 probe (logged, never selected), a probe at every
    eval step, and the checkpoint of the best probe RMSE; the trainer's
    64-px window loads into the probe's 224-px trackers (dense mode reads no
    pos_embed)."""
    ckpt = str(tmp_path / "best.npz")
    d = json.loads(json.dumps(SMALL))
    d["train"].update(steps=3, warmup=1, lr=1e-3, eval_every=1, eval_frames=4, eval_particles=64,
                      eval_clips=["moving-square"], log_every=10, checkpoint_out=ckpt)
    lines = []
    params = ttrain.train_features(Config.from_dict(d), log=lines.append, device="cpu")
    rows = [json.loads(s) for s in lines if s.startswith("{")]
    assert [r["step"] for r in rows] == [0, 1, 2, 3]
    assert all(np.isfinite(r["probe_rmse"]) for r in rows)
    chosen = [s for s in lines if s.startswith("checkpoint selection")]
    assert len(chosen) == 1
    step = int(chosen[0].split()[3])
    assert step >= 1 and rows[step]["probe_rmse"] == min(r["probe_rmse"] for r in rows[1:])
    saved = tparams.load_params(ckpt)
    for k, v in tparams._flatten(params).items():
        assert np.array_equal(tparams._flatten(saved)[k].numpy(), v.numpy()), k
