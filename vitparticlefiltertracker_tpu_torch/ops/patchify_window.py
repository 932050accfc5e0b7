"""Fused crop sampling + patchify + patch embed over a resampled search
window: kernel K2 and its plain version — the port of the JAX package's
``ops/patchify_pallas.py`` (``gather_patchify_window_pallas`` and
``window_gather_patchify_xla``).

For each particle box (center, size) in window pixels: a crop_size x
crop_size bilinear crop of the [Swin, Swin, C] window (clamp-to-edge), cut
into g x g patch tokens in the canonical (py, px, c) order, embedded as
tokens @ K + b -> [N, g*g, D]. K windows [K, Swin, Swin, C], each with its
own N boxes [K, N, 2], give [K, N, g*g, D] in one launch (K filter banks;
the port of what the JAX package's vmap does to the Pallas call).

``gather_patchify_window`` wraps K2 (csrc/window_patchify.cu).
``window_gather_patchify_plain`` is the plain PyTorch version of the same
function. ``window_gather_patchify`` sends a CUDA tensor to the kernel and a
CPU tensor to the plain version; there is no size gate and no fallback: on
a CUDA tensor the kernel launches or the call raises. ``launch_plan`` is
the pure-Python part of a launch (checks, kernel, tile, grid), so the CPU
tests reach it.
"""

from __future__ import annotations

from collections import Counter
from typing import NamedTuple

import torch

from vitparticlefiltertracker_tpu_torch.models.vit import patchify
from vitparticlefiltertracker_tpu_torch.ops.patchify import extract_crops
from vitparticlefiltertracker_tpu_torch.utils.platform import H100_SMS, sm_count

MAX_SMEM_BYTES = 232448  # 227 KB, the most a block can use
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PATH_CODES = {"scalar": 0, "narrow": 1, "wide": 2}
# csrc/window_patchify.cu: each path's token rows (bm) and output columns
# (bn) a tile; for the mma paths the weight ring's depth (bk) and stages.
TILES = {
    "wide": dict(bm=64, bn=384, bk=32, stages=4),
    "narrow": dict(bm=16, bn=32, bk=64, stages=8),
    "scalar": dict(bm=16, bn=768),
}
# The wide tile is taken when its blocks cover this share of the SMs (one
# wave: 128 blocks at N 1024, crop 32, on 132 SMs).
_FILL = 0.75
_MAX_GRID_X, _MAX_GRID_Y = 2**31 - 1, 65535


def window_gather_patchify_plain(
    window: torch.Tensor,  # [Swin, Swin, C], or [K, Swin, Swin, C]
    centers: torch.Tensor,  # [N, 2] (x, y) in window px ([K, N, 2]: each window's own)
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
    crops = extract_crops(window.to(torch.float32), centers, sizes, crop_size)  # [..., N, s, s, C]
    toks = patchify(crops.reshape(-1, *crops.shape[-3:]), patch_size)  # [*N, g*g, p*p*C]
    toks = toks.to(kernel.dtype) @ kernel + bias.to(kernel.dtype)
    return toks.reshape(*centers.shape[:-1], *toks.shape[-2:])


class LaunchPlan(NamedTuple):
    path: str  # "wide" or "narrow" (bf16 on tensor cores), "scalar" (f32 FMAs)
    rows: int  # windows * N * g*g token rows
    row_tiles: int
    col_tiles: int
    grid: tuple[int, int]  # (row-tile slots, column-tile slots): a block a tile
    smem: int  # dynamic shared memory a block, bytes
    n: int  # boxes a window
    swin: int
    c: int
    d: int
    windows: int = 1


def smem_bytes(path: str, patch: int, c: int, crop: int) -> int:
    """Dynamic shared memory one block of `path` asks for, as the kernel's
    smem_bytes computes it: the weight ring and the bf16 token rows (mma),
    or the f32 token rows (scalar), then the crop's sample offsets."""
    kdim, t = patch * patch * c, TILES[path]
    if path == "scalar":
        return 4 * (t["bm"] * (-(-kdim // 4) * 4) + crop)
    kpad = -(-kdim // t["bk"]) * t["bk"]
    return 2 * (t["stages"] * t["bk"] * (t["bn"] + 8) + t["bm"] * (kpad + 8)) + 4 * crop


def launch_plan(window: torch.Tensor, centers: torch.Tensor, sizes: torch.Tensor, crop_size: int,
                patch_size: int, kernel: torch.Tensor, bias: torch.Tensor,
                num_sms: int = H100_SMS) -> LaunchPlan:
    """Check K2's operands for what the kernels take and return the launch:
    the kernel, the tiles and the grid. Raises ValueError on anything they do
    not take; it never copies.

    bf16 weights with D % 8 == 0 go to the tensor-core kernel: the wide tile
    (64 rows x 384 columns) when its blocks cover three quarters of the
    ``num_sms`` SMs, else the narrow one (16 x 32), which splits D over blocks, so the
    one-box template call spreads its weight reads over 24 SMs (D 768).
    Everything else goes to the scalar kernel. Each tile gets a block of its
    own. Runs on every launch, so it is written for the host's time.
    """
    tensors = (window, centers, sizes, kernel, bias)
    if len({x.device for x in tensors}) != 1:
        raise ValueError("window, centers, sizes, kernel and bias must be on one device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("gather_patchify_window needs contiguous tensors")
    if window.dim() not in (3, 4) or window.shape[-3] != window.shape[-2]:
        raise ValueError(f"window must be [Swin, Swin, C] or [K, Swin, Swin, C], got {tuple(window.shape)}")
    swin, _, c = window.shape[-3:]
    windows = window.shape[0] if window.dim() == 4 else 1
    lead = window.shape[:-3]
    n = centers.shape[-2] if centers.dim() >= 2 else 0
    if centers.shape != (*lead, n, 2) or sizes.shape != centers.shape or n < 1 or windows < 1:
        raise ValueError(f"centers and sizes must be [N, 2] ([K, N, 2] for K windows) with N >= 1, got "
                         f"{tuple(centers.shape)}, {tuple(sizes.shape)} for window {tuple(window.shape)}")
    if not (window.dtype == centers.dtype == sizes.dtype == torch.float32):
        raise ValueError("window, centers and sizes must be float32")
    if kernel.dtype != bias.dtype or kernel.dtype not in _DTYPE_CODES:
        raise ValueError(f"kernel and bias must both be float32 or bfloat16, got "
                         f"{kernel.dtype}, {bias.dtype}")
    p = patch_size
    if p < 1 or crop_size % p != 0 or crop_size < p:
        raise ValueError(f"crop_size {crop_size} must be a multiple of patch_size {p}")
    d = kernel.shape[1] if kernel.dim() == 2 else -1
    if kernel.shape != (p * p * c, d) or bias.shape != (d,) or d < 1:
        raise ValueError(f"kernel must be [{p * p * c}, D] and bias [D], got "
                         f"{tuple(kernel.shape)}, {tuple(bias.shape)}")
    rows = windows * n * (crop_size // p) ** 2
    if windows * swin * swin * c > 2**31 - 1:
        raise ValueError(f"{windows} windows of {swin} x {swin} x {c} is more than the kernel indexes")
    if rows > 2**31 - 1:
        raise ValueError(f"{rows} token rows is more than the kernel indexes")
    if kernel.dtype == torch.bfloat16 and d % 8 == 0:
        if kernel.data_ptr() % 16:
            raise ValueError(f"kernel must start on 16 bytes, got address {kernel.data_ptr():#x}")
        paths = ("wide", "narrow")
    else:
        paths = ("scalar",)
    # The first path that fits a block's shared memory and covers the SMs,
    # else the last that fits.
    plan = None
    for path in paths:
        smem = smem_bytes(path, p, c, crop_size)
        if smem > MAX_SMEM_BYTES:
            continue
        row_tiles, col_tiles = -(-rows // TILES[path]["bm"]), -(-d // TILES[path]["bn"])
        plan = path, smem, row_tiles, col_tiles
        if row_tiles * col_tiles >= _FILL * num_sms:
            break
    if plan is None:
        raise ValueError(f"patch {p} with {c} channels needs more shared memory than a block has")
    path, smem, row_tiles, col_tiles = plan
    grid = (min(row_tiles, _MAX_GRID_X), min(col_tiles, _MAX_GRID_Y))
    return LaunchPlan(path, rows, row_tiles, col_tiles, grid, smem, n, swin, c, d, windows)


def launch(plan: LaunchPlan, window, centers, sizes, crop_size: int, patch_size: int, kernel, bias,
           out: torch.Tensor) -> None:
    """One launch of K2 as `plan` says, into `out` (no count, no checks
    beyond the kernel's own; ``gather_patchify_window`` is the entry)."""
    from vitparticlefiltertracker_tpu_torch.ops._build import window_patchify_library

    lib = window_patchify_library()
    with torch.cuda.device(window.device):
        stream = torch.cuda.current_stream(window.device).cuda_stream
        rc = lib.vpt_window_patchify_fwd(
            window.data_ptr(), centers.data_ptr(), sizes.data_ptr(), kernel.data_ptr(), bias.data_ptr(),
            out.data_ptr(), plan.n, plan.windows, plan.swin, plan.c, crop_size, patch_size, plan.d,
            _DTYPE_CODES[kernel.dtype], _PATH_CODES[plan.path], *plan.grid, stream,
        )
    if rc != 0:
        raise RuntimeError(f"vpt_window_patchify_fwd failed with code {rc} at crop {crop_size}, "
                           f"patch {patch_size} ({plan})")


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
    K windows [K, Swin, Swin, C] with boxes [K, N, 2] -> [K, N, g*g, D], one
    launch.

    Adds one to ``gather_patchify_window.launches`` (and to
    ``gather_patchify_window.sizes[N]``, or ``sizes[(K, N)]`` for K windows)
    per launch, so a run can show that its patch embedding went through the
    kernel, and for how many boxes.
    """
    if not all(x.is_cuda for x in (window, centers, sizes, kernel, bias)):
        raise ValueError(
            "gather_patchify_window takes CUDA tensors; use window_gather_patchify_plain on the CPU"
        )
    dev = window.device
    plan = launch_plan(window, centers, sizes, crop_size, patch_size, kernel, bias, sm_count(dev))
    g = crop_size // patch_size
    out = torch.empty((*window.shape[:-3], plan.n, g * g, plan.d), dtype=kernel.dtype, device=dev)
    launch(plan, window, centers, sizes, crop_size, patch_size, kernel, bias, out)
    gather_patchify_window.launches += 1
    gather_patchify_window.sizes[plan.n if window.dim() == 3 else (plan.windows, plan.n)] += 1
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
