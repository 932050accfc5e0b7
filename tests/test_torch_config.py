"""Port config (vitparticlefiltertracker_tpu_torch/config.py) against the
JAX package's: the same files give the same resolved config, and
chip_smoke.py's built-in dict is config.yaml plus its one override."""

import glob
import json
import os

import pytest
import yaml

from vitparticlefiltertracker_tpu import config as jconfig
from vitparticlefiltertracker_tpu_torch import config as tconfig

ROOT = os.path.join(os.path.dirname(__file__), "..")
FILES = ["config.yaml"] + sorted(os.path.relpath(p, ROOT) for p in glob.glob(os.path.join(ROOT, "configs", "*.yaml")))


@pytest.mark.parametrize("name", FILES)
def test_same_files_resolve_the_same(name):
    path = os.path.join(ROOT, name)
    assert tconfig.load_config(path).to_dict() == jconfig.load_config(path).to_dict()


def test_overrides_and_errors_match():
    path = os.path.join(ROOT, "config.yaml")
    ov = ["filter.num_particles=64", "model.variant=vit-s16", "tracker.roi_grid=3"]
    assert tconfig.load_config(path, ov).to_dict() == jconfig.load_config(path, ov).to_dict()
    for bad in [{"model": {"nope": 1}}, {"tracker": {"mode": "sideways"}},
                {"model": {"variant": "vit-x"}}]:
        with pytest.raises(ValueError):
            tconfig.Config.from_dict(bad)
    with pytest.raises(ValueError, match="unknown config path"):
        tconfig.apply_override(tconfig.Config(), "filter.nope=1")


def test_chip_smoke_config_is_config_yaml_plus_checkpoint():
    import chip_smoke

    with open(os.path.join(ROOT, "config.yaml")) as f:
        want = yaml.safe_load(f)
    want["model"]["checkpoint"] = "checkpoints/vit_b16_tracking.npz"
    assert chip_smoke.SMOKE_CONFIG == want
    assert os.path.exists(os.path.join(ROOT, chip_smoke.CHECKPOINT))


def test_chip_smoke_robust_config_is_robust_head_plus_overrides():
    """chip_smoke.py's robust path: configs/robust-head.yaml plus the
    teleport clip's gates of tools/eval_quality.py, the automatic head blend
    and the teleport source, in both packages' loaders."""
    import importlib.util

    import chip_smoke

    spec = importlib.util.spec_from_file_location("eval_quality", os.path.join(ROOT, "tools", "eval_quality.py"))
    eval_quality = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(eval_quality)
    overrides = [f"{k}={v}" for k, v in eval_quality.CLIP_OVERRIDES["teleport"].items()]
    overrides += ["model.head_blend_auto=true", "io.source=synthetic:teleport"]
    path = os.path.join(ROOT, "configs", "robust-head.yaml")
    want = jconfig.load_config(path, overrides).to_dict()
    assert tconfig.load_config(path, overrides).to_dict() == want
    assert tconfig.Config.from_dict(chip_smoke.ROBUST_CONFIG).to_dict() == want
    assert os.path.exists(os.path.join(ROOT, chip_smoke.HEAD_CHECKPOINT))


def test_chip_smoke_banked_config_is_eval4_plus_overrides():
    """chip_smoke.py's banked path: configs/eval4-tpu-multiobject-720p.yaml
    with the dense path's checkpoint and tools/eval_quality.py's eval4 clip
    (48 frames of synthetic:multi-8), in both packages' loaders."""
    import chip_smoke

    overrides = ["model.checkpoint=checkpoints/vit_b16_tracking.npz", "io.source=synthetic:multi-8",
                 "io.num_frames=48"]
    path = os.path.join(ROOT, "configs", "eval4-tpu-multiobject-720p.yaml")
    want = jconfig.load_config(path, overrides).to_dict()
    assert tconfig.load_config(path, overrides).to_dict() == want
    assert tconfig.Config.from_dict(chip_smoke.BANKED_CONFIG).to_dict() == want
    assert want["runtime"]["banks"] == 8 and want["filter"]["num_particles"] == 1024
    assert tuple(want["io"]["frame_size"]) == (720, 1280)


def test_chip_smoke_eval5_config_is_eval5_plus_overrides():
    """chip_smoke.py's eval5-roi-c4 path: configs/eval5-tpu-streaming-4k.yaml
    with the native ring's source and 60 frames, in both packages' loaders."""
    import chip_smoke

    overrides = ["io.source=native-synthetic:moving-square", "io.num_frames=60"]
    path = os.path.join(ROOT, "configs", "eval5-tpu-streaming-4k.yaml")
    want = jconfig.load_config(path, overrides).to_dict()
    assert tconfig.load_config(path, overrides).to_dict() == want
    assert tconfig.Config.from_dict(chip_smoke.EVAL5_CONFIG).to_dict() == want
    assert want["model"]["variant"] == "vit-l16" and want["filter"]["num_particles"] == 16384
    assert (want["runtime"]["stream_roi"], want["runtime"]["stream_roi_out"], want["runtime"]["stream_chunk"]) == (
        1600, 288, 4)


@pytest.mark.parametrize("name,overrides", [
    ("TRAIN_HEAD_CONFIG", ["train.steps=30", "train.eval_every=30", "train.log_every=30"]),
    ("TRAIN_FEATURES_CONFIG", ["train.steps=10", "train.eval_every=0", "train.log_every=10"]),
])
def test_chip_smoke_train_configs_are_the_train_yamls_plus_overrides(name, overrides):
    """chip_smoke.py's train phase: configs/train-head.yaml and
    configs/train-features.yaml with the steps cut (and the probe at the last
    step, or none), in both packages' loaders."""
    import chip_smoke

    path = os.path.join(ROOT, "configs", "train-head.yaml" if name == "TRAIN_HEAD_CONFIG" else "train-features.yaml")
    want = jconfig.load_config(path, overrides).to_dict()
    assert tconfig.load_config(path, overrides).to_dict() == want
    assert tconfig.Config.from_dict(getattr(chip_smoke, name)).to_dict() == want
    assert want["train"]["batch_size"] == 32 and want["model"]["variant"] == "vit-b16"


@pytest.mark.parametrize("name", ["config.yaml", "configs/robust-head.yaml"])
def test_json_config_reads_as_its_yaml(name, tmp_path):
    """The same sections as a .json file load without a YAML parser (as
    chip_smoke.py's serve check writes its config) into the same config."""
    path = os.path.join(ROOT, name)
    with open(path) as f:
        raw = yaml.safe_load(f)
    json_path = tmp_path / "config.json"
    json_path.write_text(json.dumps(raw))
    assert tconfig.load_config(str(json_path)).to_dict() == tconfig.load_config(path).to_dict()
