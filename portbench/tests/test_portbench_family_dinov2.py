"""The DINOv2 family (``families/dinov2.py``) on the CPU at a tiny size: a
cell on a tiny DINOv2 configuration runs the program's dense path on the
family's tree and is correct against the family's plain forward; its notes
carry the family's FLOP count and K1's shape with the prefix tokens; a
program whose LayerScale is planted wrong is not correct."""

import json

import torch

from portbench import harness
from tiny import make

DINO = {"depth": 2, "dim": 128, "heads": 2, "mlp_dim": 256, "patch_size": 14, "image_size": 56, "registers": 2}


def _dino_bench(tmp_path):
    """The tiny benchmark with its configuration turned into a tiny DINOv2
    (family dinov2, the program's keys for the block and the prefix)."""
    bd = make(tmp_path, feeds=1, cell="tiny-cell", lost_gate=False)
    path = bd / "configs" / "tiny-config.json"
    cfg = json.loads(path.read_text())
    cfg.update(family="dinov2", dims=DINO)
    m = cfg["tracker_config"]["model"]
    m.update(variant="custom", drop_cls_token=False, ffn="swiglu", **{k: v for k, v in DINO.items()})
    path.write_text(json.dumps(cfg))
    return bd


def test_tiny_dinov2_cell_is_correct(tmp_path):
    bd = _dino_bench(tmp_path)
    out = harness.run_cell("tiny-cell", 2**32 + 41, 1.5, True, "cpu", bench_dir=bd)
    assert out["correct"], out["checks"]
    notes = out["notes"]
    fam = harness.load_family("dinov2", bd)
    _, cfg = harness.cell_files("tiny-cell", bd)
    assert notes["family"] == "dinov2"
    assert notes["flops_per_frame"] == fam.flops_per_frame(DINO, cfg["tracker_config"])
    assert notes["k1_shape"] == [1, 2, 16 + 1 + 2, 64]


def test_a_wrong_layer_scale_is_not_correct(tmp_path):
    bd = _dino_bench(tmp_path)

    def plant(tracker):
        blocks = tracker.vit_params["blocks"]
        blocks["mlp"]["w3"].mul_(3.0)  # LayerScale folded in three times over

    out = harness.run_cell("tiny-cell", 2**32 + 41, 1.5, False, "cpu", bench_dir=bd, plant=plant)
    assert not out["correct"]


def test_family_tree_has_the_new_leaves():
    fam = harness.load_family("dinov2")
    tree = fam.weights(5, DINO, "cpu")
    assert tree["reg_tokens"].shape == (2, 128) and tree["cls_token"].shape == (128,)
    assert tree["blocks"]["mlp"]["w12"].shape == (2, 128, 512) and tree["blocks"]["mlp"]["w3"].shape == (2, 256, 128)
    g = torch.cat([tree["blocks"]["ls1"]["gamma"], tree["blocks"]["ls2"]["gamma"]])
    assert 0.1 <= float(g.min()) and float(g.max()) <= 1.0 and float(g.std()) > 0.1
    assert "pos_embed" not in tree
