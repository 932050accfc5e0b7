"""The SwiGLU gate of a DINOv2 FFN: the CUDA kernel and its plain version.

``swiglu(x)`` takes the FFN's first product with its bias, x = [gate | up]
[..., 2 h], and gives silu(gate) * up [..., h], computed in f32 and rounded
once to x's dtype. On a CUDA tensor it launches csrc/swiglu.cu (one pass
over the activation) or raises: there is no fallback. On a CPU tensor it is
the plain torch form, ``swiglu_plain``. Forward only, as K1: a tensor that
requires grad raises on either device.

Every launch of the kernel adds one to ``swiglu.launches`` (and to
``swiglu.shapes[(M, h)]``, M the rows); the plain form on a CPU tensor is
not counted, as K1's plain version is not. A captured step graph counts
its launches once a replay (runtime/step_graph.py). ``launch_blocks`` is
the pure-Python part of a launch, so the CPU tests reach it.
"""

from __future__ import annotations

from collections import Counter

import torch

from vitparticlefiltertracker_tpu_torch.utils.platform import H100_SMS, sm_count

BLOCK = 256  # threads a block (csrc/swiglu.cu kBlock)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}  # values in a thread's 16-byte load


def swiglu_plain(x: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up in f32, rounded once to x's dtype; x = [gate | up]."""
    gate, up = x.float().chunk(2, dim=-1)
    return (torch.nn.functional.silu(gate) * up).to(x.dtype)


def launch_blocks(m: int, h: int, dtype: torch.dtype, sms: int = H100_SMS) -> int:
    """The kernel's grid for [m, 2 h] rows: a thread a 16-byte group of
    output columns, at most 8 blocks of 256 a SM (the kernel loops over the
    rest)."""
    return max(1, min(-(-(m * h // _VEC[dtype]) // BLOCK), sms * 8))


def _check(x: torch.Tensor) -> tuple[int, int]:
    """-> (M, h) of a CUDA input, or ValueError."""
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"swiglu takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"swiglu takes a contiguous input on 16 bytes, got strides {x.stride()}")
    two_h = x.shape[-1]
    if two_h % (2 * _VEC[x.dtype]):
        raise ValueError(f"swiglu: the last axis {two_h} must be 2 h with h a multiple of {_VEC[x.dtype]}")
    return x.numel() // two_h, two_h // 2


def swiglu(x: torch.Tensor) -> torch.Tensor:
    """x = [gate | up] [..., 2 h] -> silu(gate) * up [..., h] in x's dtype:
    csrc/swiglu.cu on a CUDA tensor, swiglu_plain on a CPU tensor."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("swiglu has no backward: it is the inference path's FFN gate")
    if not x.is_cuda:
        return swiglu_plain(x)
    m, h = _check(x)
    out = torch.empty((*x.shape[:-1], h), dtype=x.dtype, device=x.device)
    from vitparticlefiltertracker_tpu_torch.ops._build import swiglu_library

    lib = swiglu_library()
    dev = x.device
    with torch.cuda.device(dev):
        rc = lib.vpt_swiglu(x.data_ptr(), out.data_ptr(), m, h, _DTYPE_CODES[x.dtype],
                            launch_blocks(m, h, x.dtype, sm_count(dev)), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"vpt_swiglu failed with code {rc} at shape {tuple(x.shape)} {x.dtype}")
    swiglu.launches += 1
    swiglu.shapes[(m, h)] += 1
    return out


swiglu.launches = 0
swiglu.shapes = Counter()
