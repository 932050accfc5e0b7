"""Fused crop sampling + patchify + patch embed over a resampled search
window: kernel K2 and its plain version — the port of the JAX package's
``ops/patchify_pallas.py`` (``gather_patchify_window_pallas`` and
``window_gather_patchify_xla``).

For each particle box (center, size) in window pixels: a crop_size x
crop_size bilinear crop of the [Swin, Swin, C] window (clamp-to-edge), cut
into g x g patch tokens in the canonical (py, px, c) order, embedded as
tokens @ K + b -> [N, g*g, D].

``gather_patchify_window`` wraps K2 (csrc/window_patchify.cu).
``window_gather_patchify_plain`` is the plain PyTorch version of the same
function. ``window_gather_patchify`` sends a CUDA tensor to the kernel and a
CPU tensor to the plain version; there is no size gate and no fallback: on
a CUDA tensor the kernel launches or the call raises.
"""

from __future__ import annotations

from collections import Counter

import torch

from vitparticlefiltertracker_tpu_torch.models.vit import patchify
from vitparticlefiltertracker_tpu_torch.ops.patchify import extract_crops

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def window_gather_patchify_plain(
    window: torch.Tensor,  # [Swin, Swin, C]
    centers: torch.Tensor,  # [N, 2] (x, y) in window px
    sizes: torch.Tensor,  # [N, 2] (w, h) in window px
    crop_size: int,
    patch_size: int,
    kernel: torch.Tensor,  # [p*p*C, D] patch-embed weight
    bias: torch.Tensor,  # [D]
) -> torch.Tensor:
    """Plain version: gathered bilinear crops in f32, tokens rounded to the
    weight's dtype, one product, then the bias added in that dtype (so in
    bf16 it rounds after the product and again after the bias, where the
    kernel rounds once)."""
    crops = extract_crops(window.to(torch.float32), centers, sizes, crop_size)
    toks = patchify(crops, patch_size)  # [N, g*g, p*p*C]
    return toks.to(kernel.dtype) @ kernel + bias.to(kernel.dtype)


def gather_patchify_window(
    window: torch.Tensor,
    centers: torch.Tensor,
    sizes: torch.Tensor,
    crop_size: int,
    patch_size: int,
    kernel: torch.Tensor,
    bias: torch.Tensor,
) -> torch.Tensor:
    """Kernel K2 on the card. window: contiguous CUDA [Swin, Swin, C] f32;
    centers, sizes: contiguous [N, 2] f32; kernel [p*p*C, D] and bias [D]:
    contiguous, both float32 or both bfloat16 -> [N, g*g, D] in their dtype.

    Adds one to ``gather_patchify_window.launches`` (and to
    ``gather_patchify_window.sizes[N]``) per launch, so a run can show that
    its patch embedding went through the kernel, and for how many boxes.
    """
    tensors = (window, centers, sizes, kernel, bias)
    if not all(x.is_cuda for x in tensors):
        raise ValueError(
            "gather_patchify_window takes CUDA tensors; use window_gather_patchify_plain on the CPU"
        )
    if len({x.device for x in tensors}) != 1:
        raise ValueError("window, centers, sizes, kernel and bias must be on one device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("gather_patchify_window needs contiguous tensors")
    if window.dim() != 3 or window.shape[0] != window.shape[1]:
        raise ValueError(f"window must be [Swin, Swin, C], got {tuple(window.shape)}")
    swin, _, c = window.shape
    n = centers.shape[0]
    if centers.shape != (n, 2) or sizes.shape != (n, 2) or n < 1:
        raise ValueError(f"centers and sizes must be [N, 2] with N >= 1, got "
                         f"{tuple(centers.shape)}, {tuple(sizes.shape)}")
    if not (window.dtype == centers.dtype == sizes.dtype == torch.float32):
        raise ValueError("window, centers and sizes must be float32")
    if kernel.dtype != bias.dtype or kernel.dtype not in _DTYPE_CODES:
        raise ValueError(f"kernel and bias must both be float32 or bfloat16, got "
                         f"{kernel.dtype}, {bias.dtype}")
    p = patch_size
    if crop_size % p != 0 or crop_size < p:
        raise ValueError(f"crop_size {crop_size} must be a multiple of patch_size {p}")
    d = kernel.shape[1] if kernel.dim() == 2 else -1
    if kernel.shape != (p * p * c, d) or bias.shape != (d,):
        raise ValueError(f"kernel must be [{p * p * c}, D] and bias [D], got "
                         f"{tuple(kernel.shape)}, {tuple(bias.shape)}")
    from vitparticlefiltertracker_tpu_torch.ops._build import window_patchify_library

    lib = window_patchify_library()
    if lib.vpt_window_patchify_smem_bytes(p, c) < 0:
        raise ValueError(f"patch {p} with {c} channels needs more shared memory than a block has")
    g = crop_size // p
    out = torch.empty((n, g * g, d), dtype=kernel.dtype, device=window.device)
    with torch.cuda.device(window.device):
        stream = torch.cuda.current_stream(window.device).cuda_stream
        rc = lib.vpt_window_patchify_fwd(
            window.data_ptr(), centers.data_ptr(), sizes.data_ptr(), kernel.data_ptr(),
            bias.data_ptr(), out.data_ptr(), n, swin, c, crop_size, p, d,
            _DTYPE_CODES[kernel.dtype], stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"vpt_window_patchify_fwd failed with code {rc} at N {n}, Swin {swin}, "
            f"crop {crop_size}, patch {p}, D {d}"
        )
    gather_patchify_window.launches += 1
    gather_patchify_window.sizes[n] += 1
    return out


gather_patchify_window.launches = 0
gather_patchify_window.sizes = Counter()


def window_gather_patchify(
    window: torch.Tensor,
    centers: torch.Tensor,
    sizes: torch.Tensor,
    crop_size: int,
    patch_size: int,
    kernel: torch.Tensor,
    bias: torch.Tensor,
) -> torch.Tensor:
    """Dispatch on where the window lies: CUDA -> kernel K2, CPU -> plain."""
    if window.is_cuda:
        f32 = torch.float32
        return gather_patchify_window(
            window.to(f32).contiguous(), centers.to(f32).contiguous(), sizes.to(f32).contiguous(),
            crop_size, patch_size, kernel.contiguous(), bias.to(kernel.dtype).contiguous(),
        )
    return window_gather_patchify_plain(window, centers, sizes, crop_size, patch_size, kernel, bias)
