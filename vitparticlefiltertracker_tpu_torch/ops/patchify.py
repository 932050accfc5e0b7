"""Batched particle-crop extraction and patch embedding — the port of the
JAX package's ``ops/patchify.py`` (the ``crop_impl: frame`` lowering).

For each particle box (any float center and size) sample a crop_size x
crop_size pixel grid bilinearly from the frame and patch-embed it, giving
[N, T, D] tokens for one batched ViT forward. Plain PyTorch in both
packages: ``extract_crops`` gathers 4 taps per sample; ``extract_crops_mxu``
slices one static R x R region per particle and resamples it with two
batched hat-weight products. Boxes take optional leading axes (K filter
banks: centers [K, N, 2] -> tokens [K, N, T, D]), over one shared frame or,
for ``extract_crops`` and ``gather_patchify``, a frame of their own
([K, H, W, C]).
"""

from __future__ import annotations

import torch

from vitparticlefiltertracker_tpu_torch.models.vit import patchify
from vitparticlefiltertracker_tpu_torch.ops.image import _offsets, bilinear_sample, hat_weights


def crop_sample_coords(
    centers: torch.Tensor,  # [..., N, 2] box centers (x, y) in frame px
    sizes: torch.Tensor,  # [..., N, 2] box (w, h) in frame px
    crop_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-particle crop sampling grids -> (ys, xs), each [..., N, crop, crop]."""
    t = _offsets(crop_size, centers.device)
    ys = centers[..., 1:2] + sizes[..., 1:2] * t  # [..., N, crop]
    xs = centers[..., 0:1] + sizes[..., 0:1] * t
    shape = (*ys.shape, crop_size)
    return ys[..., :, None].expand(shape), xs[..., None, :].expand(shape)


def extract_crops(
    frame: torch.Tensor,  # [H, W, C] float frame, or [*F, H, W, C] with centers [*F, N, 2]
    centers: torch.Tensor,
    sizes: torch.Tensor,
    crop_size: int,
) -> torch.Tensor:
    """[..., N, crop, crop, C] bilinear crops (clamp-to-edge)."""
    ys, xs = crop_sample_coords(centers, sizes, crop_size)
    return bilinear_sample(frame, ys, xs)


def extract_crops_mxu(
    frame: torch.Tensor,  # [H, W, C] float frame
    centers: torch.Tensor,  # [N, 2]
    sizes: torch.Tensor,  # [N, 2]
    crop_size: int,
    region: int = 64,
    frame_of: torch.Tensor | None = None,  # [N] int64: the box's frame of [F, H, W, C]
) -> torch.Tensor:
    """Crops from one static [R, R] region per particle, gathered in one
    batched index, then separable bilinear through hat-weight products.

    `region` must cover the largest box extent in pixels; samples beyond it
    clamp to the region edge (clamp-to-edge for in-frame boxes that fit).
    Region corners round half to even, as jnp.round does. With `frame_of`,
    `frame` is a stack of frames and box i reads frame frame_of[i].
    """
    h, w, c = frame.shape[-3:]
    r = min(region, h, w)
    t = _offsets(crop_size, frame.device)
    ys = torch.clamp(centers[:, 1:2] + sizes[:, 1:2] * t[None, :], 0.0, h - 1.0)
    xs = torch.clamp(centers[:, 0:1] + sizes[:, 0:1] * t[None, :], 0.0, w - 1.0)
    y0 = torch.clamp(torch.round(centers[:, 1]) - r // 2, 0, h - r).to(torch.int64)
    x0 = torch.clamp(torch.round(centers[:, 0]) - r // 2, 0, w - r).to(torch.int64)

    span = torch.arange(r, device=frame.device)
    rows = (y0[:, None] + span)[:, :, None]  # [N, R, 1]
    cols = (x0[:, None] + span)[:, None, :]  # [N, 1, R]
    regions = frame[rows, cols] if frame_of is None else frame[frame_of[:, None, None], rows, cols]  # [N, R, R, C]

    wy = hat_weights(ys - y0[:, None].to(torch.float32), r)  # [N, crop, R]
    wx = hat_weights(xs - x0[:, None].to(torch.float32), r)
    a = torch.einsum("nkr,nrwc->nkwc", wy, regions)
    return torch.einsum("njw,nkwc->nkjc", wx, a)  # [N, crop, crop, C]


def gather_patchify(
    frame: torch.Tensor,  # [H, W, C] float frame, or [K, H, W, C] with centers [K, N, 2]
    centers: torch.Tensor,  # [..., N, 2]
    sizes: torch.Tensor,  # [..., N, 2]
    crop_size: int,
    patch_size: int,
    kernel: torch.Tensor,  # [p*p*C, D] patch-embed weight
    bias: torch.Tensor,  # [D]
    region: int = 64,
    use_mxu: bool = True,
) -> torch.Tensor:
    """Crop-extract + patchify + embed -> [..., N, T, D] tokens in the
    weight's dtype: tokens rounded to it, one product, bias added in it."""
    lead = centers.shape[:-1]
    if use_mxu:
        frame_of = None
        if frame.dim() == 4:  # a frame a bank: each box reads its bank's frame
            frame_of = torch.arange(frame.shape[0], device=frame.device)[:, None].expand(lead).reshape(-1)
        crops = extract_crops_mxu(frame, centers.reshape(-1, 2), sizes.reshape(-1, 2), crop_size, region, frame_of)
    else:
        crops = extract_crops(frame, centers, sizes, crop_size)  # [..., N, s, s, C]
    tokens = patchify(crops.reshape(-1, *crops.shape[-3:]), patch_size)  # [*N, g*g, p*p*C]
    dtype = kernel.dtype
    tokens = tokens.to(dtype) @ kernel + bias.to(dtype)
    return tokens.reshape(*lead, *tokens.shape[-2:])
