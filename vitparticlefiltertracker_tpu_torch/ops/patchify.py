"""Batched particle-crop extraction and patch embedding — the port of the
JAX package's ``ops/patchify.py`` (the ``crop_impl: frame`` lowering).

For each particle box (any float center and size) sample a crop_size x
crop_size pixel grid bilinearly from the frame and patch-embed it, giving
[N, T, D] tokens for one batched ViT forward. Plain PyTorch in both
packages: ``extract_crops`` gathers 4 taps per sample; ``extract_crops_mxu``
slices one static R x R region per particle and resamples it with two
batched hat-weight products.
"""

from __future__ import annotations

import torch

from vitparticlefiltertracker_tpu_torch.models.vit import patchify
from vitparticlefiltertracker_tpu_torch.ops.image import _offsets, bilinear_sample, hat_weights


def crop_sample_coords(
    centers: torch.Tensor,  # [N, 2] box centers (x, y) in frame px
    sizes: torch.Tensor,  # [N, 2] box (w, h) in frame px
    crop_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-particle crop sampling grids -> (ys, xs), each [N, crop, crop]."""
    n = centers.shape[0]
    t = _offsets(crop_size, centers.device)
    ys = centers[:, 1:2] + sizes[:, 1:2] * t[None, :]  # [N, crop]
    xs = centers[:, 0:1] + sizes[:, 0:1] * t[None, :]
    ys = ys[:, :, None].expand(n, crop_size, crop_size)
    xs = xs[:, None, :].expand(n, crop_size, crop_size)
    return ys, xs


def extract_crops(
    frame: torch.Tensor,  # [H, W, C] float frame
    centers: torch.Tensor,
    sizes: torch.Tensor,
    crop_size: int,
) -> torch.Tensor:
    """[N, crop, crop, C] bilinear crops (clamp-to-edge)."""
    ys, xs = crop_sample_coords(centers, sizes, crop_size)
    return bilinear_sample(frame, ys, xs)


def extract_crops_mxu(
    frame: torch.Tensor,  # [H, W, C] float frame
    centers: torch.Tensor,  # [N, 2]
    sizes: torch.Tensor,  # [N, 2]
    crop_size: int,
    region: int = 64,
) -> torch.Tensor:
    """Crops from one static [R, R] region per particle, gathered in one
    batched index, then separable bilinear through hat-weight products.

    `region` must cover the largest box extent in pixels; samples beyond it
    clamp to the region edge (clamp-to-edge for in-frame boxes that fit).
    Region corners round half to even, as jnp.round does.
    """
    h, w, c = frame.shape
    r = min(region, h, w)
    t = _offsets(crop_size, frame.device)
    ys = torch.clamp(centers[:, 1:2] + sizes[:, 1:2] * t[None, :], 0.0, h - 1.0)
    xs = torch.clamp(centers[:, 0:1] + sizes[:, 0:1] * t[None, :], 0.0, w - 1.0)
    y0 = torch.clamp(torch.round(centers[:, 1]) - r // 2, 0, h - r).to(torch.int64)
    x0 = torch.clamp(torch.round(centers[:, 0]) - r // 2, 0, w - r).to(torch.int64)

    span = torch.arange(r, device=frame.device)
    rows = (y0[:, None] + span)[:, :, None]  # [N, R, 1]
    cols = (x0[:, None] + span)[:, None, :]  # [N, 1, R]
    regions = frame[rows, cols]  # [N, R, R, C]

    wy = hat_weights(ys - y0[:, None].to(torch.float32), r)  # [N, crop, R]
    wx = hat_weights(xs - x0[:, None].to(torch.float32), r)
    a = torch.einsum("nkr,nrwc->nkwc", wy, regions)
    return torch.einsum("njw,nkwc->nkjc", wx, a)  # [N, crop, crop, C]


def gather_patchify(
    frame: torch.Tensor,  # [H, W, C] float frame
    centers: torch.Tensor,  # [N, 2]
    sizes: torch.Tensor,  # [N, 2]
    crop_size: int,
    patch_size: int,
    kernel: torch.Tensor,  # [p*p*C, D] patch-embed weight
    bias: torch.Tensor,  # [D]
    region: int = 64,
    use_mxu: bool = True,
) -> torch.Tensor:
    """Crop-extract + patchify + embed -> [N, T, D] tokens in the weight's
    dtype: tokens rounded to it, one product, bias added in it."""
    if use_mxu:
        crops = extract_crops_mxu(frame, centers, sizes, crop_size, region)
    else:
        crops = extract_crops(frame, centers, sizes, crop_size)  # [N, s, s, C]
    tokens = patchify(crops, patch_size)  # [N, g*g, p*p*C]
    dtype = kernel.dtype
    return tokens.to(dtype) @ kernel + bias.to(dtype)
