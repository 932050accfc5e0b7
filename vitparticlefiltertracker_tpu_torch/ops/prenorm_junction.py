"""The pre-norm junction of a ViT block: the CUDA kernel and its plain version.

``prenorm_junction(x, branch, bias, scale, shift, dtype, eps)`` closes a
residual branch and opens the next LayerNorm: it returns ``x_new = x +
(branch + bias)`` (the bias may be None; with the branch None nothing is
pending, the bias must be None too, and x_new is x) and ``y = LN(x_new)``,
the LayerNorm of models/vit.py with its statistics in f32 and the result
rounded once to ``dtype``. On a CUDA tensor ``scale`` and ``shift``, the
LayerNorm's parameters, are float32, as models/params.py
cast_for_inference leaves them. On a CUDA tensor it launches
csrc/prenorm_junction.cu (one pass: x and branch read, x_new and y written)
or raises: there is no fallback. On a CPU tensor it is the plain torch
chain, ``prenorm_junction_plain``: the residual adds, then the LayerNorm's
f32 statistics, op by op. Forward only, as K1: a tensor that requires grad
raises on either device.

The kernel keeps the plain form's two roundings of the residual stream, so
x_new is bitwise the plain form's; y may differ from it by an ulp at a
rounding tie, the two sums being taken in another order.

Every launch of the kernel adds one to ``prenorm_junction.launches`` (and to
``prenorm_junction.shapes[(M, D)]``, M the rows); the plain form is not
counted. A captured step graph counts its launches once a replay
(runtime/step_graph.py). ``launch_geometry`` is the pure-Python part of a
launch, so the CPU tests reach it.
"""

from __future__ import annotations

from collections import Counter
from typing import NamedTuple

import torch

from vitparticlefiltertracker_tpu_torch.utils.platform import H100_SMS, sm_count

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}  # values in a lane's 16-byte load
VPLS = (1, 2, 3, 4, 6, 8, 12, 16)  # 16-byte vectors a lane may hold (the kernel's instances)


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, dtype: torch.dtype,
                     eps: float) -> torch.Tensor:
    """LN with f32 statistics regardless of compute dtype (population var)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + shift).to(dtype)


def prenorm_junction_plain(x: torch.Tensor, branch: torch.Tensor | None, bias: torch.Tensor | None,
                           scale: torch.Tensor, shift: torch.Tensor, dtype: torch.dtype,
                           eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(x + (branch + bias), its LN): the plain, differentiable torch form."""
    if branch is not None:
        x = x + (branch if bias is None else branch + bias)
    elif bias is not None:
        raise ValueError("prenorm_junction: a bias comes with its branch")
    return x, layer_norm_plain(x, scale, shift, dtype, eps)


class Geometry(NamedTuple):
    vpl: int  # 16-byte vectors a lane holds
    warps: int  # rows a block, a warp each
    blocks: int


def launch_geometry(m: int, d: int, dtype: torch.dtype, sms: int = H100_SMS) -> Geometry:
    """The kernel's launch for [m, d] rows: a warp a row, holding d / 32
    lanes' worth of 16-byte vectors (the smallest instance that covers it);
    4 rows a block where that still gives every SM a block, else 2, else 1
    (a few hundred rows spread over as many SMs as they can)."""
    vec = _VEC[dtype]
    if d % vec:
        raise ValueError(f"prenorm_junction: D {d} must be a multiple of {vec} for 16-byte {dtype} loads")
    need = -(-d // (32 * vec))
    vpl = next((v for v in VPLS if v >= need), None)
    if vpl is None:
        raise ValueError(f"prenorm_junction: D {d} is wider than {32 * vec * VPLS[-1]} ({dtype})")
    warps = next((w for w in (4, 2) if -(-m // w) >= sms), 1)
    return Geometry(vpl, warps, -(-m // warps))


def _check(x: torch.Tensor, branch, bias, scale: torch.Tensor, shift: torch.Tensor, dtype: torch.dtype) -> int:
    """-> D of a CUDA input, or ValueError."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"prenorm_junction takes float32 or bfloat16, got {dtype}")
    if bias is not None and branch is None:
        raise ValueError("prenorm_junction: a bias comes with its branch")
    d = x.shape[-1]
    for name, t, shape in (("x", x, x.shape), ("branch", branch, x.shape), ("bias", bias, (d,))):
        if t is None:
            continue
        if t.dtype != dtype:
            raise ValueError(f"prenorm_junction: {name} is {t.dtype}, the compute dtype {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"prenorm_junction: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    for name, t in (("scale", scale), ("shift", shift)):
        if t.dtype != torch.float32 or tuple(t.shape) != (d,):
            raise ValueError(f"prenorm_junction: the LayerNorm's {name} must be float32 [{d}] (cast_for_inference "
                             f"widens a checkpoint's), got {t.dtype} {tuple(t.shape)}")
    for name, t in (("x", x), ("branch", branch), ("bias", bias), ("scale", scale), ("shift", shift)):
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16 or t.device != x.device):
            raise ValueError(f"prenorm_junction takes contiguous inputs on 16 bytes on x's device; {name} has "
                             f"strides {t.stride()} at {t.data_ptr() % 16} bytes past 16 on {t.device}")
    return d


def prenorm_junction(x: torch.Tensor, branch: torch.Tensor | None, bias: torch.Tensor | None,
                     scale: torch.Tensor, shift: torch.Tensor, dtype: torch.dtype,
                     eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(x_new, y) = (x + (branch + bias), LN(x_new) in dtype):
    csrc/prenorm_junction.cu on a CUDA tensor, prenorm_junction_plain on a
    CPU tensor."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, branch, bias, scale, shift)):
        raise RuntimeError("prenorm_junction has no backward: it is the inference path's LayerNorm")
    if not x.is_cuda:
        return prenorm_junction_plain(x, branch, bias, scale, shift, dtype, eps)
    d = _check(x, branch, bias, scale, shift, dtype)
    m = x.numel() // d
    x_new = x if branch is None else torch.empty_like(x)
    y = torch.empty_like(x)
    from vitparticlefiltertracker_tpu_torch.ops._build import prenorm_junction_library

    lib = prenorm_junction_library()
    dev = x.device
    geo = launch_geometry(m, d, dtype, sm_count(dev))

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        rc = lib.vpt_prenorm_junction(x.data_ptr(), ptr(branch), ptr(bias), scale.data_ptr(), shift.data_ptr(),
                                      None if branch is None else x_new.data_ptr(), y.data_ptr(), m, d,
                                      _DTYPE_CODES[dtype], eps, geo.vpl, geo.warps, geo.blocks,
                                      torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"vpt_prenorm_junction failed with code {rc} at shape {tuple(x.shape)} {dtype}")
    prenorm_junction.launches += 1
    prenorm_junction.shapes[(m, d)] += 1
    return x_new, y


prenorm_junction.launches = 0
prenorm_junction.shapes = Counter()
