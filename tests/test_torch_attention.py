"""Port parity: attention (vitparticlefiltertracker_tpu_torch/ops/attention.py).

The port's plain version runs against the JAX package's Pallas kernel (in
interpret mode, as tests/test_attention.py runs it on the CPU) and its XLA
reference, on the same numpy inputs. Tolerances are those of
tests/test_attention.py: f32 within 2e-5, bf16 within 3e-2. The CUDA kernel
itself is compared with the plain version in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from vitparticlefiltertracker_tpu.ops import attention as jattn
from vitparticlefiltertracker_tpu_torch.ops import attention as tattn

HIGHEST = jax.lax.Precision.HIGHEST


def _qkv(seed, shape, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32).astype(dtype) for _ in range(3)]


def _to_torch(x):
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


@pytest.mark.parametrize("t", [128, 130, 197, 389])
def test_reference_matches_jax_f32(t):
    q, k, v = _qkv(t, (1, 2, t, 64))
    got = tattn.reference_attention(*map(_to_torch, (q, k, v))).numpy()
    flash = jattn.flash_attention(
        *map(jnp.asarray, (q, k, v)), interpret=True, precision=HIGHEST, block_q=128, block_k=128
    )
    ref = jattn.reference_attention(*map(jnp.asarray, (q, k, v)), precision=HIGHEST)
    np.testing.assert_allclose(got, np.asarray(flash), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_reference_matches_jax_bf16():
    q, k, v = _qkv(0, (1, 2, 197, 64), ml_dtypes.bfloat16)
    got = tattn.reference_attention(*map(_to_torch, (q, k, v))).float().numpy()
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    flash = np.asarray(jattn.flash_attention(jq, jk, jv, interpret=True), np.float32)
    ref = np.asarray(jattn.reference_attention(jq, jk, jv), np.float32)
    np.testing.assert_allclose(got, flash, rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(got, ref, rtol=3e-2, atol=3e-2)


def test_extreme_logits_stay_finite():
    q = np.full((1, 1, 256, 64), 30.0, np.float32)
    v = _qkv(1, (1, 1, 256, 64))[2]
    got = tattn.reference_attention(*map(_to_torch, (q, q, v))).numpy()
    assert np.all(np.isfinite(got))
    want = np.asarray(
        jattn.flash_attention(jnp.asarray(q), jnp.asarray(q), jnp.asarray(v),
                              interpret=True, precision=HIGHEST)
    )
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_cpu_dispatch_is_plain_version():
    q, k, v = (_to_torch(x) for x in _qkv(3, (2, 2, 17, 64)))
    before = tattn.flash_attention.launches
    out = tattn.multi_head_attention(q, k, v)
    assert torch.equal(out, tattn.reference_attention(q, k, v))
    assert tattn.flash_attention.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 1, 8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_attention(q, q, q)


# --- The launch plan on the views the ViT passes (no card needed) ----------

def _fused(b, t, h, dtype=torch.bfloat16, seed=0):
    """The ViT's fused QKV activation [B, T, H*3*64], head-major columns."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn((b, t, h * 3 * 64), generator=g).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [4, 9, 16, 17, 196])
@pytest.mark.parametrize("h", [3, 12, 16])
@pytest.mark.parametrize("b", [1, 3])
def test_launch_plan_reads_fused_views_in_place(b, h, t, dtype):
    qkv = _fused(b, t, h, dtype)
    q, k, v = tattn.split_fused_qkv(qkv, h)
    assert q.shape == k.shape == v.shape == (b, h, t, 64)
    out = tattn.empty_attention_output(q)
    plan = tattn.launch_plan(q, k, v, out)
    # No copy: the kernel gets the fused activation's own memory and strides.
    elem = qkv.element_size()
    assert plan.ptrs == (qkv.data_ptr(), qkv.data_ptr() + 64 * elem, qkv.data_ptr() + 128 * elem,
                         out.data_ptr())
    fused = (t * h * 192, 192, h * 192)
    assert plan.strides[:9] == tuple(0 if n == 1 else s for n, s in zip((b, h, t) * 3, fused * 3))
    assert plan.strides[9:] == tuple(0 if n == 1 else s for n, s in zip((b, h, t), (t * h * 64, 64, h * 64)))
    assert (plan.b, plan.h, plan.t) == (b, h, t)
    few_tiles = dtype == torch.float32 and b * h * -(-t // 16) < tattn.WARPS_PER_SM * tattn.H100_SMS
    assert plan.path == ("small" if t <= tattn.SMALL_T_MAX else "split" if few_tiles else "tiled")
    # The output's [B, T, D] reshape, as models/vit.py takes it, is a view.
    flat = out.transpose(1, 2).reshape(b, t, h * 64)
    assert flat.data_ptr() == out.data_ptr() and flat.is_contiguous()


@pytest.mark.parametrize("shape,dtype,path,warps,grid", [
    ((1, 12, 196, 64), torch.bfloat16, "tiled", 1, 156),  # dense: 13 x 12 warps of 16 rows
    ((49, 12, 196, 64), torch.bfloat16, "tiled", 4, 2352),
    ((1, 12, 196, 64), torch.float32, "split", 4, 156),  # eval1: 156 query tiles < 4 x 132, 4 warps each
    ((49, 12, 196, 64), torch.float32, "tiled", 4, 2352),  # the scan's shape in f32: 16 rows a warp
    ((2, 12, 197, 64), torch.float32, "split", 4, 312),
    ((4, 12, 196, 64), torch.float32, "tiled", 4, 192),  # 624 query tiles >= 528
    ((1024, 12, 4, 64), torch.bfloat16, "small", 8, 1536),  # crop: one warp per (b, h)
    ((1, 12, 4, 64), torch.bfloat16, "small", 1, 12),
    ((6000, 12, 4, 64), torch.bfloat16, "small", 8, 9000),  # B*H = 72,000 > 65,535
    ((2, 3, 16, 64), torch.float32, "small", 1, 6),
])
def test_launch_plan_path_and_grid(shape, dtype, path, warps, grid):
    q = torch.empty(shape, dtype=dtype)
    plan = tattn.launch_plan(q, q, q, torch.empty_like(q))
    assert (plan.path, plan.warps, plan.grid) == (path, warps, grid)


def test_launch_plan_refusals():
    q = torch.zeros(1, 2, 8, 64)
    ok = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="stride 1"):
        tattn.launch_plan(torch.zeros(1, 2, 64, 8).transpose(-1, -2), ok, ok, ok)
    with pytest.raises(ValueError, match="16 bytes"):
        tattn.launch_plan(torch.zeros(1 * 2 * 8 * 64 + 1)[1:].view(1, 2, 8, 64), ok, ok, ok)
    with pytest.raises(ValueError, match="head dim"):
        x = torch.zeros(1, 2, 8, 32)
        tattn.launch_plan(x, x, x, x)
    with pytest.raises(ValueError, match="multiple of 8"):
        tattn.launch_plan(torch.zeros(1, 2, 8, 68)[..., :64], ok, ok, ok)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tattn.launch_plan(q.half(), ok.half(), ok.half(), ok.half())
    with pytest.raises(ValueError, match="shape"):
        tattn.launch_plan(q, ok, ok, torch.zeros(1, 2, 9, 64))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("t", [4, 9, 16])
def test_reference_on_fused_views_matches_jax(t, dtype, tol):
    """The small-T (crop-mode) shapes, read as the ViT passes them: views of
    the fused activation, against the JAX reference on the same numbers."""
    b, h = 3, 12
    rng = np.random.default_rng(t)
    np_dtype = np.float32 if dtype == torch.float32 else ml_dtypes.bfloat16
    fused = rng.standard_normal((b, t, h * 3 * 64)).astype(np.float32).astype(np_dtype)
    q, k, v = tattn.split_fused_qkv(_to_torch(fused), h)
    got = tattn.reference_attention(q, k, v).float().numpy()
    jq, jk, jv = (jnp.asarray(x) for x in fused.reshape(b, t, h, 3, 64).transpose(3, 0, 2, 1, 4))
    want = np.asarray(jattn.reference_attention(jq, jk, jv, precision=HIGHEST), np.float32)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# --- 3xTF32: the f32 tiled and split paths' arithmetic, emulated on the CPU ---

def _tf32_split(x):
    """csrc/flash_attn.cu split_tf32 on f32 bits: big = x rounded to TF32 (add
    half a unit of the 13 dropped bits, then mask: to nearest, ties away),
    small = x - big (exact in f32) as the tensor core reads it, its low 13
    bits dropped."""
    big = ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    small = ((x - big).view(torch.int32) & ~0x1FFF).view(torch.float32)
    return big, small


def _mm_tf32(a, b, passes=3):
    """a @ b from TF32 operands with f32 sums (a product of two TF32 values
    is exact in f32): passes 3 is the kernel's small*big + big*small, then
    big*big; passes 1 is big*big alone (plain TF32)."""
    ab, asm = _tf32_split(a)
    bb, bsm = _tf32_split(b)
    if passes == 1:
        return ab @ bb
    return (asm @ bb + ab @ bsm) + ab @ bb


def _attention_tf32(q, k, v, passes=3, tile=64):
    """The f32 paths' algorithm: 64-key tiles, the online softmax in f32,
    each tile's S = Q K^T and P V from TF32 operands (P split too, never
    rounded), acc = acc * alpha + P V."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    m = torch.full(q.shape[:-1] + (1,), -torch.inf)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(q)
    for k0 in range(0, k.shape[-2], tile):
        s = _mm_tf32(q, k[..., k0:k0 + tile, :].transpose(-1, -2), passes) * scale
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p, alpha = torch.exp(s - m_new), torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha + _mm_tf32(p, v[..., k0:k0 + tile, :], passes)
        m = m_new
    return acc / l


TF32_SHAPES = [(1, 12, 196, 64), (49, 12, 196, 64)] + [
    (2, h, t, 64) for h in (3, 12, 16) for t in (17, 64, 128, 130, 196, 197, 389)]


@pytest.mark.parametrize("shape", TF32_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_3xtf32_emulation_within_the_f32_tolerance(shape):
    """The dense (eval1), scan and sweep shapes: the 3xTF32 design stays
    within K1's f32 tolerance of 2e-5 of reference_attention and of an f64
    reference, on seeded inputs (chip_smoke.py's sizes: q, k, v ~ N(0, 1))."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(shape[0] + shape[2], shape))
    got = _attention_tf32(q, k, v)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, tattn.reference_attention(q, k, v), rtol=2e-5, atol=2e-5)
    want64 = tattn.reference_attention(q.double(), k.double(), v.double())
    torch.testing.assert_close(got.double(), want64, rtol=2e-5, atol=2e-5)


def test_one_tf32_pass_misses_the_f32_tolerance():
    """Why three products: plain TF32 (big x big alone) at eval1's shape is
    far outside 2e-5, where 3xTF32 is inside it."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(7, (1, 12, 196, 64)))
    want = tattn.reference_attention(q.double(), k.double(), v.double())
    one = float((_attention_tf32(q, k, v, passes=1).double() - want).abs().max())
    three = float((_attention_tf32(q, k, v).double() - want).abs().max())
    assert one > 1e-4 and three < 1e-5, (one, three)


def test_tf32_split_rounds_to_nearest_on_the_bits():
    """big keeps 10 mantissa bits, rounded to nearest (ties away from zero);
    big + small holds x to 2^-21 of |x|."""
    x = torch.tensor([1.0 + 2**-11, 1.0 + 2**-11 + 2**-23, -(1.0 + 2**-11), 1.0 + 2**-12, 3.0])
    big, small = _tf32_split(x)
    assert big.tolist() == [1.0 + 2**-10, 1.0 + 2**-10, -(1.0 + 2**-10), 1.0, 3.0]
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    yb, ys = _tf32_split(y)
    assert bool(((yb.view(torch.int32) & 0x1FFF) == 0).all()) and bool(((ys.view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((yb.double() + ys.double() - y.double()).abs() / y.double().abs()).max()) <= 2**-21
