"""Multi-head attention for the ViT: the CUDA kernel and its plain version.

``flash_attention`` wraps kernel K1 (csrc/flash_attn.cu), the Hopper port of
the JAX package's Pallas ``_flash_kernel``. ``reference_attention`` is the
plain PyTorch version of the same function. ``multi_head_attention`` sends a
CUDA tensor to the kernel and a CPU tensor to the plain version; there is no
size gate and no fallback: on a CUDA tensor the kernel launches or the call
raises. The kernel has no backward (neither has the JAX package's): both
entry points raise on inputs that require grad, and training computes its
attention with ``reference_attention``, chosen by its ViT spec.

The kernel takes strided views, so the ViT hands it q, k and v as views of
its fused qkv activation [B, T, H, 3, 64] (``split_fused_qkv``) and gets the
output in [B, T, H, 64] memory (``empty_attention_output``): no copy before
or after the launch. ``launch_plan`` is the pure-Python part of a launch
(checks, path, block shape, grid, strides), so the CPU tests reach it.
"""

from __future__ import annotations

import ctypes
import math
from collections import Counter
from typing import NamedTuple

import torch

from vitparticlefiltertracker_tpu_torch.utils.platform import H100_SMS, sm_count

HEAD_DIM = 64  # the one head width the kernel takes (every ViT preset)
SMALL_T_MAX = 16  # csrc/flash_attn.cu kSmallTMax: crop sizes 32/48/64 -> T 4/9/16
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PATH_CODES = {"small": 0, "tiled": 1, "split": 2}
# Warps a block each path can run with, most first (csrc/flash_attn.cu).
# f32 above T 16 is 3xTF32: "tiled" when the call has query tiles of 16 rows
# for every SM's 4 schedulers, else "split" (4 warps on one tile's keys and
# output dims), so a small call such as eval1's [1, 12, 196, 64] still fills
# the card.
_WARP_CHOICES = {("small", torch.float32): (8, 4, 2, 1), ("small", torch.bfloat16): (8, 4, 2, 1),
                 ("tiled", torch.bfloat16): (4, 2, 1), ("tiled", torch.float32): (4,),
                 ("split", torch.float32): (4,)}
WARPS_PER_SM = 4  # an SM's warp schedulers
_MAX_GRID = 2**31 - 1


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain attention. q, k, v: [..., T, d]. Logits and softmax in f32.

    As in the JAX reference: the QK product runs in the input dtype, the
    logits are taken to f32 and scaled, the probabilities go back to V's
    dtype for the PV product.
    """
    d = q.shape[-1]
    logits = torch.matmul(q, k.transpose(-1, -2)).float() / math.sqrt(d)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


def split_fused_qkv(qkv: torch.Tensor, heads: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[B, T, H*3*hd] with head-major (h, 3, hd) columns, as the ViT's fused
    QKV product gives it -> q, k, v as [B, H, T, hd] views of it (no copy)."""
    b, t, f = qkv.shape
    q, k, v = qkv.reshape(b, t, heads, 3, f // (3 * heads)).permute(3, 0, 2, 1, 4).unbind(0)
    return q, k, v


def empty_attention_output(q: torch.Tensor) -> torch.Tensor:
    """An uninitialised [B, H, T, d] output laid out as [B, T, H, d] in
    memory, so that ``out.transpose(1, 2).reshape(B, T, H*d)`` is a view."""
    b, h, t, d = q.shape
    return torch.empty((b, t, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)


class LaunchPlan(NamedTuple):
    path: str  # "small" (T <= SMALL_T_MAX), "tiled" or "split" (f32 above SMALL_T_MAX)
    warps: int  # warps a block
    grid: int  # blocks on grid.x (the kernels loop over their work items)
    b: int
    h: int
    t: int
    strides: tuple[int, ...]  # (b, h, t) element strides of q, k, v, o; 0 for a size-1 dim
    ptrs: tuple[int, int, int, int]  # data_ptr of q, k, v, o


def _blocks(path: str, bh: int, t: int, warps: int) -> int:
    if path == "small":
        return -(-bh // warps)  # one warp per (b, h) pair
    if path == "split":
        return bh * -(-t // 16)  # 16 query rows a block
    return bh * -(-t // (16 * warps))  # 16 query rows a warp


def launch_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                num_sms: int = H100_SMS) -> LaunchPlan:
    """Check q, k, v and o ([B, H, T, 64] views in one dtype) for what the
    kernel takes and return its launch: the path, the warps a block, the
    grid and the strides. Raises ValueError on anything the kernel does not
    take; it never copies.

    The block is as wide as still puts at least ``num_sms`` blocks on the
    card (else the narrowest), so a single head at T = 196 spreads over the
    SMs and a large batch gets wide blocks; f32 above T 16 takes the split
    path when it has fewer 16-row query tiles than ``WARPS_PER_SM`` a SM.
    Runs on every launch, so it is written for the host's time (the dense
    step is bound by it).
    """
    tensors = (q, k, v, o)
    shape, dtype, device = q.shape, q.dtype, q.device
    for x in tensors:
        if x.shape != shape or x.dtype != dtype or x.device != device:
            raise ValueError("q, k, v and out must share one [B, H, T, d] shape, dtype and device, got "
                             + ", ".join(f"{tuple(x.shape)} {x.dtype} {x.device}" for x in tensors))
    if len(shape) != 4:
        raise ValueError(f"flash_attention takes [B, H, T, d], got {tuple(shape)}")
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention takes float32 or bfloat16, got {dtype}")
    b, h, t, d = shape
    if d != HEAD_DIM:
        raise ValueError(f"flash_attention takes head dim {HEAD_DIM}, got {d}")
    if b < 1 or h < 1 or t < 1:
        raise ValueError(f"flash_attention needs a non-empty [B, H, T, d], got {tuple(shape)}")
    strides = []
    ptrs = []
    for name, x in zip(("q", "k", "v", "out"), tensors):
        sb, sh, st, sd = x.stride()
        # A size-1 dim is never stepped over: its stride is taken as 0.
        sb, sh, st = (0 if b == 1 else sb), (0 if h == 1 else sh), (0 if t == 1 else st)
        if sd != 1:
            raise ValueError(f"{name}: the head dim must have stride 1, got strides {x.stride()}")
        if sb % 8 or sh % 8 or st % 8:
            raise ValueError(f"{name}: every stride must be a multiple of 8 elements, got {x.stride()}")
        ptr = x.data_ptr()
        if ptr % 16:
            raise ValueError(f"{name}: data must start on 16 bytes, got address {ptr:#x}")
        strides += (sb, sh, st)
        ptrs.append(ptr)
    bh = b * h
    path = "small" if t <= SMALL_T_MAX else "tiled"
    if path == "tiled" and dtype == torch.float32 and bh * -(-t // 16) < WARPS_PER_SM * num_sms:
        path = "split"
    choices = _WARP_CHOICES[(path, dtype)]
    warps = choices[-1]
    for w in choices:
        if _blocks(path, bh, t, w) >= num_sms:
            warps = w
            break
    return LaunchPlan(path, warps, min(_blocks(path, bh, t, warps), _MAX_GRID), b, h, t,
                      tuple(strides), tuple(ptrs))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Kernel K1 on the card. q, k, v: CUDA [B, H, T, 64] views in float32
    or bfloat16 (head dim of stride 1, other strides multiples of 8, data on
    16 bytes) -> [B, H, T, 64] in the same dtype, a view of a new
    [B, T, H, 64] buffer (``empty_attention_output``).

    Adds one to ``flash_attention.launches`` (and to
    ``flash_attention.shapes[(B, H, T)]``) per launch, so a run can show
    that its attention went through the kernel, and at which shapes.
    """
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention takes CUDA tensors; use reference_attention on the CPU")
    _refuse_grad(q, k, v)
    out = empty_attention_output(q)
    dev = q.device
    plan = launch_plan(q, k, v, out, sm_count(dev))
    from vitparticlefiltertracker_tpu_torch.ops._build import flash_attn_library

    lib = flash_attn_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.vpt_flash_attn_fwd(
            *plan.ptrs, (ctypes.c_longlong * 12)(*plan.strides), plan.b, plan.h, plan.t, HEAD_DIM,
            _DTYPE_CODES[q.dtype], 1.0 / math.sqrt(HEAD_DIM), _PATH_CODES[plan.path], plan.warps,
            plan.grid, stream,
        )
    if rc != 0:
        raise RuntimeError(f"vpt_flash_attn_fwd failed with code {rc} at shape {tuple(q.shape)} ({plan})")
    flash_attention.launches += 1
    flash_attention.shapes[(plan.b, plan.h, plan.t)] += 1
    return out


flash_attention.launches = 0
flash_attention.shapes = Counter()


def _refuse_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """K1 is forward only (as the JAX package's Pallas kernel): its output
    has no grad_fn, so a gradient through it would silently be cut. Raise
    instead; training takes the plain version through its spec
    (VitSpec.use_flash_attention False)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError(
            "flash_attention has no backward: inputs that require grad must go through "
            "reference_attention (VitSpec.use_flash_attention=False, as the trainer's spec sets it)"
        )


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Dispatch on where the tensors lie: CUDA -> kernel K1 (output in
    [B, T, H, d] memory), CPU -> plain. Forward only on both: inputs that
    require grad (with grad mode on) raise, whatever their device."""
    _refuse_grad(q, k, v)
    if q.is_cuda:
        return flash_attention(q, k, v)
    return reference_attention(q, k, v)
