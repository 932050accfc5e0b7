"""The yardstick's arithmetic: operations and bytes from shapes, the card's
peaks, and K1's launch grid.

A family's ``flops_per_frame`` (``families/<family>.py``) counts its
forward and adds ``scoring_flops``, the ROI cell scoring's share of
``vitparticlefiltertracker_tpu_torch/runtime/benchmark.py``
``estimate_flops_per_frame`` (a frozen copy, the JAX package's count term
for term); ``k1_grid`` is a frozen copy of the grid arithmetic of
``ops/attention.py`` ``launch_plan`` for bfloat16 at T > 16, by which a
traced launch is matched to its shape.
"""

from __future__ import annotations

# Published dense peaks of one NVIDIA H100 SXM (the data sheet, at its 700 W
# limit): bf16 tensor-core FLOP/s and HBM3 bytes/s.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
H100_SMS = 132


def scoring_flops(grid: int, dim: int, tracker_config: dict) -> int:
    """Matmul FLOPs of a dense step's ROI scoring of one filter's particles
    on a grid x grid token map of width `dim`: the hat-weight contractions
    of "cells" (roi_grid^2 cells a particle) or of "pooled"."""
    n, k = tracker_config["filter"]["num_particles"], tracker_config["tracker"]["roi_grid"]
    if tracker_config["tracker"]["appearance"] == "cells":
        return n * (2 * k * grid * grid * dim + 2 * k * k * grid * dim)
    return n * (2 * grid * grid * dim + 2 * grid * dim)


def k1_flops(b: int, h: int, t: int, dh: int) -> float:
    """QK^T and PV: 4 B H T^2 dh."""
    return 4.0 * b * h * t * t * dh


def k1_bytes(b: int, h: int, t: int, dh: int, itemsize: int = 2) -> float:
    """q, k, v read once and o written once."""
    return 4.0 * b * h * t * dh * itemsize


def k1_least_s(b: int, h: int, t: int, dh: int) -> float:
    """The least time a launch can take: the larger of its FLOPs over the
    bf16 peak and its bytes over HBM's."""
    return max(k1_flops(b, h, t, dh) / PEAK_BF16_FLOPS, k1_bytes(b, h, t, dh) / PEAK_HBM_BYTES)


def k1_grid(b: int, h: int, t: int, num_sms: int = H100_SMS) -> int:
    """K1's bf16 tiled grid: 16 query rows a warp, the widest block (4, 2 or
    1 warps) that still puts num_sms blocks on the card."""
    bh = b * h
    for warps in (4, 2, 1):
        blocks = bh * -(-t // (16 * warps))
        if blocks >= num_sms:
            return blocks
    return blocks
