"""Port parity: the fused window gather+patchify+embed
(vitparticlefiltertracker_tpu_torch/ops/patchify_window.py).

The plain version runs against both JAX paths on the same numpy inputs:
window_gather_patchify_xla (under HIGHEST matmul precision) and the Pallas
kernel gather_patchify_window_pallas in interpret mode. The cases are those
of tests/test_patchify_pallas.py, with its tolerances: 1e-4 in f32, atol
0.15 and rtol 0.05 with bf16 weights (the Pallas kernel rounds once after
the bias, the plain version after the product and again after the bias).
Kernel K2 itself needs the card: tests/test_torch_cuda.py and chip_smoke.py.
Its launch plan (the kernel, tile and grid a call gets) is pure Python and
is tested here.
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


# --- K2's launch plan (no card needed) ---------------------------------------

def _operands(n, crop, d, dtype=torch.bfloat16, swin=256, patch=PATCH):
    window = torch.zeros((swin, swin, C))
    kernel = torch.zeros((patch * patch * C, d), dtype=dtype)
    return window, torch.zeros((n, 2)), torch.zeros((n, 2)), crop, patch, kernel, torch.zeros((d,), dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [192, 384, 768, 1024, 100])  # every preset's width (config.py), and D % 8 != 0
@pytest.mark.parametrize("crop", [32, 48])  # 4 and 9 tokens a box: tiles straddle boxes
@pytest.mark.parametrize("n", [1, 2, 5, 16, 17, 1024, 16384])  # 16384: eval5's particle count
def test_launch_plan_covers_every_row_and_column(n, crop, d, dtype):
    plan = pw.launch_plan(*_operands(n, crop, d, dtype))
    rows = n * (crop // PATCH) ** 2
    tile = pw.TILES[plan.path]
    assert plan.rows == rows and (plan.n, plan.swin, plan.c, plan.d) == (n, 256, C, d)
    # bf16 with D % 8 == 0 on tensor cores: the wide tile where its blocks
    # cover three quarters of the SMs, else the narrow one; everything else
    # on the scalar kernel.
    if dtype == torch.bfloat16 and d % 8 == 0:
        wide_blocks = -(-rows // 64) * -(-d // 384)
        assert plan.path == ("wide" if 4 * wide_blocks >= 3 * pw.H100_SMS else "narrow")
    else:
        assert plan.path == "scalar"
    assert plan.row_tiles == -(-rows // tile["bm"]) and plan.col_tiles == -(-d // tile["bn"])
    # Every (row tile, column tile) has a block of its own.
    assert plan.grid == (plan.row_tiles, plan.col_tiles)
    assert plan.smem == pw.smem_bytes(plan.path, PATCH, C, crop) <= pw.MAX_SMEM_BYTES


@pytest.mark.parametrize("n,crop,d,dtype,path,grid", [
    (1, 32, 768, torch.bfloat16, "narrow", (1, 24)),  # template and init: D over 24 blocks
    (1024, 32, 768, torch.bfloat16, "wide", (64, 2)),  # the particles: 128 blocks of 64 x 384
    (16384, 48, 768, torch.bfloat16, "wide", (2304, 2)),  # eval5's particles
    (17, 32, 768, torch.bfloat16, "narrow", (5, 24)),
    (33, 48, 1024, torch.bfloat16, "narrow", (19, 32)),
    (1024, 32, 192, torch.bfloat16, "narrow", (256, 6)),
    (1024, 32, 100, torch.bfloat16, "scalar", (256, 1)),
    (1024, 32, 768, torch.float32, "scalar", (256, 1)),
])
def test_launch_plan_path_and_grid(n, crop, d, dtype, path, grid):
    plan = pw.launch_plan(*_operands(n, crop, d, dtype))
    assert (plan.path, plan.grid) == (path, grid)


def test_launch_plan_shared_memory():
    # Weight ring + bf16 token rows padded to K + 8 + the crop's offsets.
    assert pw.smem_bytes("wide", 16, 3, 32) == 2 * (4 * 32 * 392 + 64 * 776) + 4 * 32 == 199808
    assert pw.smem_bytes("narrow", 16, 3, 32) == 2 * (8 * 64 * 40 + 16 * 776) + 4 * 32 == 65920
    assert pw.smem_bytes("scalar", 16, 3, 48) == 4 * (16 * 768 + 48)
    # Each path's block fits at the larger crop.
    for path in pw.TILES:
        assert pw.smem_bytes(path, 16, 3, 48) <= pw.MAX_SMEM_BYTES


def test_launch_plan_refusals():
    ok = _operands(4, 32, 768)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        pw.launch_plan(*_operands(4, 32, 768, torch.float16))
    with pytest.raises(ValueError, match="multiple of patch_size"):
        pw.launch_plan(*ok[:3], 40, *ok[4:])
    with pytest.raises(ValueError, match="contiguous"):
        pw.launch_plan(ok[0], torch.zeros((2, 4)).t(), *ok[2:])
    with pytest.raises(ValueError, match="N >= 1"):
        pw.launch_plan(*_operands(0, 32, 768))
    with pytest.raises(ValueError, match=r"\[Swin, Swin, C\]"):
        pw.launch_plan(torch.zeros((64, 32, 3)), *ok[1:])
    with pytest.raises(ValueError, match=r"kernel must be \[768, D\]"):
        pw.launch_plan(*ok[:5], torch.zeros((767, 768), dtype=torch.bfloat16), ok[6])
    with pytest.raises(ValueError, match="float32"):
        pw.launch_plan(ok[0].double(), *ok[1:])
    # The tensor-core kernel reads the weight in 16-byte chunks.
    shifted = torch.zeros(768 * 768 + 1, dtype=torch.bfloat16)[1:].view(768, 768)
    with pytest.raises(ValueError, match="16 bytes"):
        pw.launch_plan(*ok[:5], shifted, ok[6])
    # 64-px patches: 12,288 values a token, more than a block's shared memory holds.
    with pytest.raises(ValueError, match="shared memory"):
        pw.launch_plan(*_operands(1, 64, 768, patch=64))
    with pytest.raises(ValueError, match="shared memory"):
        pw.launch_plan(*_operands(1, 64, 768, torch.float32, patch=64))


# --- K windows in one call (K filter banks) -----------------------------------

def _windows(k, n, seed=0):
    """k windows, each with its own n boxes, stacked: [K, Swin, Swin, C],
    [K, N, 2], [K, N, 2] (numpy), and the shared weights."""
    parts = [_setup(seed=seed + i, n=n) for i in range(k)]
    window, centers, sizes = (np.stack([p[j] for p in parts]) for j in range(3))
    return window, centers, sizes, parts[0][3], parts[0][4]


@pytest.mark.parametrize("k,n", [(1, 13), (2, 5), (3, 1)])
def test_plain_over_windows_matches_jax_vmap(k, n):
    """K windows with their own boxes in one call == the JAX package's vmap
    of both its paths over the windows (what its banked step makes of the
    Pallas call), and == K calls of one window each, bit for bit."""
    window, centers, sizes, kernel, bias = _windows(k, n)
    t = [torch.from_numpy(x) for x in (window, centers, sizes)]
    got = pw.window_gather_patchify_plain(*t, CROP, PATCH, torch.from_numpy(kernel), torch.from_numpy(bias))
    assert got.shape == (k, n, (CROP // PATCH) ** 2, D)
    each = torch.stack([pw.window_gather_patchify_plain(t[0][i], t[1][i], t[2][i], CROP, PATCH,
                                                        torch.from_numpy(kernel), torch.from_numpy(bias))
                        for i in range(k)])
    assert torch.equal(got, each)
    kb = (jnp.asarray(kernel), jnp.asarray(bias))
    with jax.default_matmul_precision("highest"):
        xla = jax.vmap(lambda w, c, s: window_gather_patchify_xla(w, c, s, CROP, PATCH, *kb))(
            jnp.asarray(window), jnp.asarray(centers), jnp.asarray(sizes))
    pallas = jax.vmap(lambda w, c, s: gather_patchify_window_pallas(w, c, s, CROP, PATCH, *kb, block_n=8,
                                                                     interpret=True))(
        jnp.asarray(window), jnp.asarray(centers), jnp.asarray(sizes))
    for want in (xla, pallas):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("k,n,path,grid", [
    (8, 1024, "wide", (512, 2)),  # eval4's 8 banks x 1024 particles, crop mode: one launch
    (2, 1024, "wide", (128, 2)),
    (2, 1, "narrow", (1, 24)),  # two banks' template calls: 8 rows in one 16-row tile
    (8, 1, "narrow", (2, 24)),
])
def test_launch_plan_over_windows(k, n, path, grid):
    """The plan counts the token rows of all K windows: K * N * g*g rows in
    the row tiles, and the window count passed to the kernel."""
    window = torch.zeros((k, 256, 256, C))
    kernel = torch.zeros((PATCH * PATCH * C, 768), dtype=torch.bfloat16)
    plan = pw.launch_plan(window, torch.zeros((k, n, 2)), torch.zeros((k, n, 2)), 32, PATCH, kernel,
                          torch.zeros((768,), dtype=torch.bfloat16))
    assert (plan.windows, plan.n, plan.rows, plan.swin) == (k, n, k * n * 4, 256)
    assert (plan.path, plan.grid) == (path, grid)
    one = pw.launch_plan(window[0], torch.zeros((n, 2)), torch.zeros((n, 2)), 32, PATCH, kernel,
                         torch.zeros((768,), dtype=torch.bfloat16))
    assert one.windows == 1 and one.rows == n * 4


def test_launch_plan_over_windows_refusals():
    kernel, bias = torch.zeros((768, 64)), torch.zeros((64,))
    window = torch.zeros((2, 64, 64, C))
    with pytest.raises(ValueError, match=r"\[K, N, 2\]"):
        pw.launch_plan(window, torch.zeros((3, 4, 2)), torch.zeros((3, 4, 2)), 32, PATCH, kernel, bias)
    with pytest.raises(ValueError, match=r"\[K, N, 2\]"):
        pw.launch_plan(window, torch.zeros((4, 2)), torch.zeros((4, 2)), 32, PATCH, kernel, bias)
    with pytest.raises(ValueError, match=r"\[Swin, Swin, C\]"):
        pw.launch_plan(torch.zeros((2, 2, 64, 64, C)), torch.zeros((2, 4, 2)), torch.zeros((2, 4, 2)), 32,
                       PATCH, kernel, bias)
