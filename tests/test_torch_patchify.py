"""Port parity: bilinear sampling, window extraction and the crop-mode
patchify path (vitparticlefiltertracker_tpu_torch/ops/{image,patchify}.py).

Each function runs in both packages on the same numpy inputs from a seed,
in f32, the JAX side under HIGHEST matmul precision. Tolerances: 1e-5 for
the gathers (elementwise lerps, same order of operations), 1e-4 for the
hat-weight products and the embed (sums taken in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitparticlefiltertracker_tpu.ops import image as jimg
from vitparticlefiltertracker_tpu.ops import patchify as jpat
from vitparticlefiltertracker_tpu_torch.ops import image as timg
from vitparticlefiltertracker_tpu_torch.ops import patchify as tpat

T = torch.from_numpy
J = jnp.asarray
GATHER_TOL = 1e-5
PRODUCT_TOL = 1e-4


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def _img(rng, h=96, w=120, c=3):
    return rng.normal(size=(h, w, c)).astype(np.float32)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_bilinear_sample_matches_jax(rng):
    img = _img(rng)
    # Points inside, on the last row/column and past every edge (clamped).
    ys = rng.uniform(-5.0, 100.0, size=(7, 11)).astype(np.float32)
    xs = rng.uniform(-5.0, 125.0, size=(7, 11)).astype(np.float32)
    ys[0, :3] = [0.0, 95.0, 94.5]
    xs[0, :3] = [119.0, 0.0, 118.25]
    _close(timg.bilinear_sample(T(img), T(ys), T(xs)), jimg.bilinear_sample(J(img), J(ys), J(xs)),
           GATHER_TOL)


def test_bilinear_sample_hits_pixel_centres(rng):
    img = _img(rng, 16, 16)
    yy, xx = np.meshgrid(np.arange(16, dtype=np.float32), np.arange(16, dtype=np.float32), indexing="ij")
    out = timg.bilinear_sample(T(img), T(yy), T(xx))
    np.testing.assert_array_equal(out.numpy(), img)


@pytest.mark.parametrize("center,side", [((60.0, 48.0), 40.0), ((3.0, 90.0), 70.0), ((118.0, 2.5), 200.0)])
def test_extract_window_matches_jax_and_mxu(rng, center, side):
    img = _img(rng)
    c = np.asarray(center, np.float32)
    s = np.float32(side)
    got = timg.extract_window(T(img), T(c), torch.tensor(s), 24)
    with jax.default_matmul_precision("highest"):
        want = jimg.extract_window(J(img), J(c), J(s), 24)
    _close(got, want, GATHER_TOL)
    _close(timg.extract_window_mxu(T(img), T(c), torch.tensor(s), 24), want, PRODUCT_TOL)


def _boxes(rng, n, lo, hi, size_lo=6.0, size_hi=40.0):
    centers = np.stack([rng.uniform(lo[0], hi[0], n), rng.uniform(lo[1], hi[1], n)], 1).astype(np.float32)
    sizes = rng.uniform(size_lo, size_hi, size=(n, 2)).astype(np.float32)
    return centers, sizes


def test_crop_sample_coords_match_jax(rng):
    centers, sizes = _boxes(rng, 5, (10, 10), (100, 80))
    ys, xs = tpat.crop_sample_coords(T(centers), T(sizes), 16)
    jys, jxs = jpat.crop_sample_coords(J(centers), J(sizes), 16)
    assert ys.shape == (5, 16, 16)
    _close(ys, jys, GATHER_TOL)
    _close(xs, jxs, GATHER_TOL)


def test_extract_crops_match_jax(rng):
    img = _img(rng)
    centers, sizes = _boxes(rng, 9, (-4, -4), (124, 100))  # some hang past the frame
    got = tpat.extract_crops(T(img), T(centers), T(sizes), 16)
    want = jpat.extract_crops(J(img), J(centers), J(sizes), 16)
    assert got.shape == (9, 16, 16, 3)
    _close(got, want, GATHER_TOL)


# Interior boxes, boxes at the frame border (the region clamps, the samples
# clamp to the edge, as tests/test_image_ops.py checks for the JAX package),
# and centers on .5 (the region corner rounds half to even in both).
CROP_CASES = {
    "interior": (np.array([[40.0, 30.0], [70.3, 61.7], [99.9, 20.2]], np.float32), 24.0),
    "frame_edge": (np.array([[2.0, 2.0], [118.0, 50.0], [50.0, 95.0], [119.0, 95.0]], np.float32), 20.0),
    "half_even": (np.array([[40.5, 33.5], [41.5, 34.5], [62.5, 47.5]], np.float32), 24.0),
}


@pytest.mark.parametrize("case", sorted(CROP_CASES))
def test_extract_crops_mxu_matches_jax(rng, case):
    img = _img(rng)
    centers, side = CROP_CASES[case]
    sizes = np.full_like(centers, side)
    got = tpat.extract_crops_mxu(T(img), T(centers), T(sizes), 16, region=32)
    with jax.default_matmul_precision("highest"):
        want = jpat.extract_crops_mxu(J(img), J(centers), J(sizes), 16, region=32)
    _close(got, want, PRODUCT_TOL)
    # ... and the region-sliced crops equal the gathered ones (the box fits).
    _close(got, tpat.extract_crops(T(img), T(centers), T(sizes), 16).numpy(), 1e-3)


def test_extract_crops_mxu_region_corner_rounds_half_to_even():
    """A centre at x.5 puts the region corner at round-half-even(x.5) - R/2:
    with a ramp image, the first region column is visible in the crop."""
    img = np.tile(np.arange(64, dtype=np.float32)[None, :, None], (64, 1, 3))
    for cx in (20.5, 21.5):
        centers = np.array([[cx, 32.0]], np.float32)
        sizes = np.array([[40.0, 4.0]], np.float32)  # wider than the region: clamps
        got = tpat.extract_crops_mxu(T(img), T(centers), T(sizes), 8, region=16)
        want = jpat.extract_crops_mxu(J(img), J(centers), J(sizes), 8, region=16)
        _close(got, want, PRODUCT_TOL)
        assert float(got[0, 0, 0, 0]) == float(np.round(cx)) - 8


@pytest.mark.parametrize("use_mxu", [True, False])
def test_gather_patchify_matches_jax(rng, use_mxu):
    img = _img(rng)
    centers, sizes = _boxes(rng, 6, (15, 15), (105, 80), 8.0, 30.0)
    kernel = (rng.normal(size=(8 * 8 * 3, 16)) * 0.05).astype(np.float32)
    bias = rng.normal(size=(16,)).astype(np.float32)
    got = tpat.gather_patchify(T(img), T(centers), T(sizes), 16, 8, T(kernel), T(bias),
                               region=32, use_mxu=use_mxu)
    with jax.default_matmul_precision("highest"):
        want = jpat.gather_patchify(J(img), J(centers), J(sizes), 16, 8, J(kernel), J(bias),
                                    region=32, use_mxu=use_mxu)
    assert got.shape == (6, 4, 16)
    _close(got, want, PRODUCT_TOL)


def test_gather_patchify_bf16_close_to_jax(rng):
    """bf16 weights: tokens and output rounded in both; tolerance as
    tests/test_patchify_pallas.py's bf16 case (atol 0.15, rtol 0.05)."""
    img = _img(rng)
    centers, sizes = _boxes(rng, 4, (15, 15), (105, 80), 8.0, 30.0)
    kernel = (rng.normal(size=(8 * 8 * 3, 16)) * 0.05).astype(np.float32)
    bias = rng.normal(size=(16,)).astype(np.float32)
    got = tpat.gather_patchify(T(img), T(centers), T(sizes), 16, 8, T(kernel).bfloat16(),
                               T(bias).bfloat16(), region=32)
    with jax.default_matmul_precision("highest"):
        want = jpat.gather_patchify(J(img), J(centers), J(sizes), 16, 8, J(kernel).astype(jnp.bfloat16),
                                    J(bias).astype(jnp.bfloat16), region=32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=0.15, rtol=0.05)


def test_gather_patchify_token_layout(rng):
    """Token 0 is the top-left patch of the crop, flattened (py, px, c)."""
    img = _img(rng, 64, 64)
    kernel = (rng.normal(size=(8 * 8 * 3, 16)) * 0.01).astype(np.float32)
    centers = np.array([[30.0, 30.0]], np.float32)
    sizes = np.array([[16.0, 16.0]], np.float32)
    toks = tpat.gather_patchify(T(img), T(centers), T(sizes), 16, 8, T(kernel), torch.zeros(16), region=32)
    crop = tpat.extract_crops_mxu(T(img), T(centers), T(sizes), 16, region=32)[0]
    want = crop[:8, :8].reshape(-1) @ T(kernel)
    torch.testing.assert_close(toks[0, 0], want, rtol=PRODUCT_TOL, atol=PRODUCT_TOL)
