// The SwiGLU gate of a DINOv2 FFN (models/vit.py, ffn "swiglu"): out =
// silu(gate) * up, where x = [gate | up] is the output of the FFN's first
// product w12 (its bias included), [M, 2 h] row-major, and out is [M, h].
//
// No TPU kernel of the JAX package corresponds: the JAX package has no
// SwiGLU block. It was added so that the gate, which torch would run as a
// silu and a multiply (two passes over the activation and one [M, h]
// intermediate in HBM), is one pass: 2 h elements read and h written a row.
//
// Bound: bytes. At DINOv2 ViT-g/14's h 4096 and one 224-px window (M 261),
// 6,414,336 bytes a launch, 1.9 us at 3.35 TB/s; the arithmetic (an exp, a
// divide and two multiplies an element) is far below the card's rate. The
// design is what a bandwidth-bound elementwise pass wants: each thread
// loads 16 bytes of gate and the 16 bytes of up in the same columns (8 bf16
// or 4 f32 values), neighbouring threads on neighbouring addresses, and
// stores 16 bytes; a grid-stride loop over the M h / vec groups; no shared
// memory. silu is x / (1 + exp(-x)) in f32, as torch's CUDA silu computes
// it, built without --use_fast_math as torch's own kernels are, and the
// product is rounded once to the output's type.
//
// Plain C interface, loaded with ctypes (ops/_build.py).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

__device__ __forceinline__ float silu_mul(float g, float u) { return g / (1.0f + expf(-g)) * u; }

// 16 bytes of a row: 8 bf16 values.
__global__ void swiglu_bf16_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out,
                                   long long m, long long h) {
  const long long per_row = h / 8;
  const long long items = m * per_row;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < items;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = i / per_row;
    const long long col = (i - row * per_row) * 8;
    const __nv_bfloat16* xr = x + row * 2 * h;
    const uint4 gv = *reinterpret_cast<const uint4*>(xr + col);
    const uint4 uv = *reinterpret_cast<const uint4*>(xr + h + col);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
    const __nv_bfloat162* u2 = reinterpret_cast<const __nv_bfloat162*>(&uv);
    uint4 ov;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&ov);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 g = __bfloat1622float2(g2[j]);
      const float2 u = __bfloat1622float2(u2[j]);
      o2[j] = __floats2bfloat162_rn(silu_mul(g.x, u.x), silu_mul(g.y, u.y));
    }
    *reinterpret_cast<uint4*>(out + row * h + col) = ov;
  }
}

// 16 bytes of a row: 4 f32 values.
__global__ void swiglu_f32_kernel(const float* __restrict__ x, float* __restrict__ out, long long m, long long h) {
  const long long per_row = h / 4;
  const long long items = m * per_row;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < items;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = i / per_row;
    const long long col = (i - row * per_row) * 4;
    const float* xr = x + row * 2 * h;
    const float4 g = *reinterpret_cast<const float4*>(xr + col);
    const float4 u = *reinterpret_cast<const float4*>(xr + h + col);
    *reinterpret_cast<float4*>(out + row * h + col) =
        make_float4(silu_mul(g.x, u.x), silu_mul(g.y, u.y), silu_mul(g.z, u.z), silu_mul(g.w, u.w));
  }
}

}  // namespace

extern "C" {

// x: [m, 2 h] contiguous on the card, out: [m, h] contiguous, both 16-byte
// aligned, of dtype 0 (f32; h a multiple of 4) or 1 (bf16; h a multiple of
// 8); blocks: this launch's grid (ops/swiglu.py launch_blocks); stream: the
// stream to launch on. Returns a cudaError_t value (0 = success).
int vpt_swiglu(const void* x, void* out, long long m, long long h, int dtype, int blocks, void* stream) {
  const int vec = dtype == 1 ? 8 : 4;
  if (m < 1 || h < vec || h % vec != 0 || blocks < 1 || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16 != 0) return cudaErrorMisalignedAddress;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    swiglu_bf16_kernel<<<blocks, kBlock, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                                  static_cast<__nv_bfloat16*>(out), m, h);
  } else {
    swiglu_f32_kernel<<<blocks, kBlock, 0, s>>>(static_cast<const float*>(x), static_cast<float*>(out), m, h);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
