"""The yardstick's counts: FLOPs a frame of each configuration (its model
family's count), K1's bytes, FLOPs and grid."""

import json

from portbench import counts, harness
from tiny import BENCH


def _config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_flops_per_frame_of_each_configuration():
    b, l16 = _config("vitb16-dense-1k"), _config("vitl16-dense-4k")
    vit = harness.load_family("vit")
    assert vit.flops_per_frame(b["dims"], b["tracker_config"]) == 37_033_672_704
    assert vit.flops_per_frame(l16["dims"], l16["tracker_config"]) == 133_621_612_544


def test_k1_bytes_flops_and_least_time():
    assert counts.k1_bytes(1, 12, 196, 64) == 1_204_224
    assert counts.k1_flops(1, 12, 196, 64) == 118_013_952
    # [1, 12, 196, 64] is bound by its bytes on the H100's peaks.
    assert counts.k1_least_s(1, 12, 196, 64) == 1_204_224 / counts.PEAK_HBM_BYTES


def test_k1_grid_matches_the_kernels_launch_plan():
    # ops/attention.py launch_plan's bf16 tiled grids (PERF.md's kernel table).
    assert counts.k1_grid(1, 12, 196) == 156
    assert counts.k1_grid(1, 16, 196) == 208
    assert counts.k1_grid(8, 12, 196) == 384
    assert counts.k1_grid(16, 12, 196) == 768
