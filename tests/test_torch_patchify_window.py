"""Port parity: the fused window gather+patchify+embed
(vitparticlefiltertracker_tpu_torch/ops/patchify_window.py).

The plain version runs against both JAX paths on the same numpy inputs:
window_gather_patchify_xla (under HIGHEST matmul precision) and the Pallas
kernel gather_patchify_window_pallas in interpret mode. The cases are those
of tests/test_patchify_pallas.py, with its tolerances: 1e-4 in f32, atol
0.15 and rtol 0.05 with bf16 weights (the Pallas kernel rounds once after
the bias, the plain version after the product and again after the bias).
Kernel K2 itself needs the card: tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitparticlefiltertracker_tpu.ops.patchify_pallas import (
    gather_patchify_window_pallas,
    window_gather_patchify_xla,
)
from vitparticlefiltertracker_tpu_torch.ops import patchify_window as pw

SWIN, CROP, PATCH, C, D = 64, 32, 16, 3, 128
F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=0.15, rtol=0.05)


def _setup(seed=0, n=13, swin=SWIN, d=D):
    rng = np.random.default_rng(seed)
    window = rng.normal(size=(swin, swin, C)).astype(np.float32)
    centers = rng.uniform(8.0, swin - 8.0, size=(n, 2)).astype(np.float32)
    sizes = rng.uniform(6.0, 24.0, size=(n, 2)).astype(np.float32)
    kernel = (rng.normal(size=(PATCH * PATCH * C, d)) * 0.02).astype(np.float32)
    bias = (rng.normal(size=(d,)) * 0.1).astype(np.float32)
    return window, centers, sizes, kernel, bias


def _edge_clamp():
    window, _, _, kernel, bias = _setup()
    centers = np.array([[1.0, 1.0], [SWIN - 2.0, SWIN - 2.0], [SWIN - 1.0, 0.0]], np.float32)
    sizes = np.full((3, 2), 20.0, np.float32)
    return window, centers, sizes, kernel, bias


def _raw_window_folded_weights():
    """The tracker's inputs: a raw 0..255 window and pixel normalization
    folded into the embed weight (runtime/tracker.py)."""
    from vitparticlefiltertracker_tpu_torch.models.vit import VitSpec
    from vitparticlefiltertracker_tpu_torch.runtime.tracker import _norm_folded_embed_weights

    window, centers, sizes, kernel, bias = _setup(n=6)
    window = np.random.default_rng(1).uniform(0, 255, size=window.shape).astype(np.float32)
    prm = {"patch_embed": {"kernel": torch.from_numpy(kernel), "bias": torch.from_numpy(bias)}}
    k, b = _norm_folded_embed_weights(prm, VitSpec(dim=D, dtype=torch.float32))
    return window, centers, sizes, k.numpy(), b.numpy()


# name -> (inputs, crop, patch, weight dtype, Pallas block_n)
CASES = {
    "basic": (lambda: _setup(), 32, 16, "float32", 8),
    "ragged": (lambda: _setup(n=5), 32, 16, "float32", 4),
    "single": (lambda: _setup(n=1), 32, 16, "float32", 8),
    "edge_clamp": (_edge_clamp, 32, 16, "float32", 8),
    "bf16": (lambda: _setup(n=4), 32, 16, "bfloat16", 8),
    "grid_32_16": (lambda: _setup(n=3), 32, 16, "float32", 8),
    "grid_48_16": (lambda: _setup(n=3), 48, 16, "float32", 8),
    "raw_window_folded": (_raw_window_folded_weights, 32, 16, "float32", 8),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_both_jax_paths(case):
    make, crop, patch, dt, block_n = CASES[case]
    window, centers, sizes, kernel, bias = make()
    n, d = centers.shape[0], kernel.shape[1]
    tdt = torch.bfloat16 if dt == "bfloat16" else torch.float32
    jdt = jnp.bfloat16 if dt == "bfloat16" else jnp.float32
    got = pw.window_gather_patchify_plain(
        torch.from_numpy(window), torch.from_numpy(centers), torch.from_numpy(sizes),
        crop, patch, torch.from_numpy(kernel).to(tdt), torch.from_numpy(bias).to(tdt),
    )
    g2 = (crop // patch) ** 2
    assert got.shape == (n, g2, d) and got.dtype == tdt
    args = (jnp.asarray(window), jnp.asarray(centers), jnp.asarray(sizes), crop, patch,
            jnp.asarray(kernel).astype(jdt), jnp.asarray(bias).astype(jdt))
    with jax.default_matmul_precision("highest"):
        xla = window_gather_patchify_xla(*args)
    pallas = gather_patchify_window_pallas(*args, block_n=block_n, interpret=True)
    tol = BF16_TOL if dt == "bfloat16" else F32_TOL
    for want in (xla, pallas):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def test_dispatch_on_cpu_is_the_plain_version():
    window, centers, sizes, kernel, bias = (torch.from_numpy(x) for x in _setup(n=5))
    before = pw.gather_patchify_window.launches
    got = pw.window_gather_patchify(window, centers, sizes, CROP, PATCH, kernel, bias)
    want = pw.window_gather_patchify_plain(window, centers, sizes, CROP, PATCH, kernel, bias)
    assert torch.equal(got, want)
    assert pw.gather_patchify_window.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    window, centers, sizes, kernel, bias = (torch.from_numpy(x) for x in _setup(n=2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        pw.gather_patchify_window(window, centers, sizes, CROP, PATCH, kernel, bias)
