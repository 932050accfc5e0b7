// The pre-norm junction of a ViT block (models/vit.py): the residual add
// that closes one branch and the LayerNorm that opens the next, in one pass.
//
//   t     = round(f32(branch) + f32(bias))       where the bias is given
//   x_new = round(f32(x) + f32(t))               (t = branch without one)
//   y     = round(LN(x_new) * scale + shift)     statistics in f32
//
// x, branch, bias, x_new and y are in the compute dtype; scale and shift,
// the LayerNorm's parameters, in f32 (models/params.py cast_for_inference
// widens a checkpoint's). A bias comes only with its branch. The residual
// stream keeps the plain path's two roundings, so x_new is bitwise torch's
// `x + (branch + bias)`.
// The LayerNorm uses models/vit.py _layer_norm's formulas in its order: the
// mean (the sum times 1/D, as torch's mean reduction computes it), the
// population variance of (x - mean)^2 with each square rounded, rsqrtf(var
// + eps), then (x - mean) * rstd, * scale, + shift, each rounded on its own
// (__fmul_rn / __fadd_rn: no contraction into an FMA). Only the order of the
// two sums differs from torch's reduction, so y may differ from the plain
// chain by an ulp at a rounding tie.
//
// No TPU kernel of the JAX package corresponds: XLA fuses the JAX package's
// layer norm and residual adds itself. It was added because torch runs the
// chain as about 16 launches (two casts, two means, the subtractions, the
// square, + eps, rsqrt, three broadcast passes, the bias and residual adds),
// each writing an f32 temporary of the whole activation.
//
// Bound: bytes. A row reads x and the branch and writes x_new and y: at
// DINOv2 ViT-g/14's [261, 1536] bf16, 3.2 MB, 0.96 us at 3.35 TB/s; at
// ViT-B/16 over 16 windows, [3136, 768], 9.6 MB, 2.9 us. The design is the
// one a normalisation wants on this card: one warp a row, the row held in
// registers between the two reductions (warp shuffles; no shared memory),
// 16-byte loads and stores with neighbouring lanes on neighbouring
// addresses, and no f32 temporary in device memory. VPL, the 16-byte
// vectors a lane holds, is a template parameter chosen from D by the host
// (ops/prenorm_junction.py launch_geometry); a row narrower than 32 VPL
// vectors is masked.
//
// Plain C interface, loaded with ctypes (ops/_build.py); built without
// --use_fast_math, as torch's own kernels are.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// 16 bytes of T as floats, and back (rounded to nearest even).
template <typename T>
struct Vec16;

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int n = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&f)[8]) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 g = __bfloat1622float2(h[j]);
      f[2 * j] = g.x;
      f[2 * j + 1] = g.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&f)[8]) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
    *reinterpret_cast<uint4*>(p) = v;
  }
  static __device__ __forceinline__ float round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
};

template <>
struct Vec16<float> {
  static constexpr int n = 4;
  static __device__ __forceinline__ void load(const float* p, float (&f)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&f)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
  static __device__ __forceinline__ float round(float x) { return x; }
};

// N f32 LayerNorm parameters from column c, in 16-byte loads.
template <int N>
__device__ __forceinline__ void load_param(const float* p, int c, float (&f)[N]) {
#pragma unroll
  for (int j = 0; j < N; j += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + c + j);
    f[j] = v.x;
    f[j + 1] = v.y;
    f[j + 2] = v.z;
    f[j + 3] = v.w;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  // A butterfly: every lane ends with the same bits (each add's operands are
  // the same pair in either order).
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int VPL>
__global__ void prenorm_junction_kernel(const T* __restrict__ x, const T* __restrict__ branch,
                                        const T* __restrict__ bias, const float* __restrict__ scale,
                                        const float* __restrict__ shift, T* __restrict__ x_new,
                                        T* __restrict__ y, long long m, int d, float eps) {
  using V = Vec16<T>;
  constexpr int n = V::n;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= m) return;  // a whole warp: no lane of it takes part in a shuffle
  const long long base = row * d;

  float v[VPL][n];
  float sum = 0.0f;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int c = (lane + 32 * k) * n;
    if (c < d) {
      V::load(x + base + c, v[k]);
      if (branch != nullptr) {
        float t[n], b[n];
        V::load(branch + base + c, t);
        if (bias != nullptr) {
          V::load(bias + c, b);
#pragma unroll
          for (int i = 0; i < n; ++i) t[i] = V::round(t[i] + b[i]);
        }
#pragma unroll
        for (int i = 0; i < n; ++i) v[k][i] = V::round(v[k][i] + t[i]);
        V::store(x_new + base + c, v[k]);
      }
#pragma unroll
      for (int i = 0; i < n; ++i) sum += v[k][i];
    }
  }
  const float inv_d = 1.0f / static_cast<float>(d);
  const float mean = __fmul_rn(warp_sum(sum), inv_d);

  float sq = 0.0f;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    if ((lane + 32 * k) * n < d) {
#pragma unroll
      for (int i = 0; i < n; ++i) {
        v[k][i] -= mean;
        sq = __fadd_rn(sq, __fmul_rn(v[k][i], v[k][i]));
      }
    }
  }
  const float rstd = rsqrtf(__fadd_rn(__fmul_rn(warp_sum(sq), inv_d), eps));

#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int c = (lane + 32 * k) * n;
    if (c < d) {
      float s[n], h[n];
      load_param(scale, c, s);
      load_param(shift, c, h);
#pragma unroll
      for (int i = 0; i < n; ++i) v[k][i] = __fadd_rn(__fmul_rn(__fmul_rn(v[k][i], rstd), s[i]), h[i]);
      V::store(y + base + c, v[k]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* branch, const void* bias, const float* scale, const float* shift, void* x_new,
           void* y, long long m, int d, float eps, int vpl, int warps, int blocks, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(branch);
  const T* ct = static_cast<const T*>(bias);
  T* nt = static_cast<T*>(x_new);
  T* yt = static_cast<T*>(y);
  switch (vpl) {
#define VPT_JUNCTION_CASE(N)                                                                            \
  case N:                                                                                               \
    prenorm_junction_kernel<T, N><<<blocks, 32 * warps, 0, s>>>(xt, bt, ct, scale, shift, nt, yt, m, d, eps); \
    break;
    VPT_JUNCTION_CASE(1)
    VPT_JUNCTION_CASE(2)
    VPT_JUNCTION_CASE(3)
    VPT_JUNCTION_CASE(4)
    VPT_JUNCTION_CASE(6)
    VPT_JUNCTION_CASE(8)
    VPT_JUNCTION_CASE(12)
    VPT_JUNCTION_CASE(16)
#undef VPT_JUNCTION_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: [m, d] contiguous on the card; branch: [m, d] or null; bias: [d], or
// null (always where branch is); scale, shift: [d] f32; x_new: [m, d], null
// exactly where branch is (x_new is then x); y: [m, d]. x, branch, bias,
// x_new and y of dtype 0 (f32; d a multiple of 4) or 1 (bf16; d a multiple
// of 8); every pointer 16-byte aligned.
// vpl: the 16-byte vectors a lane holds (1, 2, 3, 4, 6, 8, 12 or 16; 32 vpl
// of them cover d); warps: rows a block (1, 2 or 4); blocks: at least
// ceil(m / warps) (ops/prenorm_junction.py launch_geometry); stream: the
// stream to launch on. Returns a cudaError_t value (0 = success).
int vpt_prenorm_junction(const void* x, const void* branch, const void* bias, const float* scale,
                         const float* shift, void* x_new, void* y, long long m, int d, int dtype, float eps, int vpl,
                         int warps, int blocks, void* stream) {
  const int vec = dtype == 1 ? 8 : 4;
  if ((dtype != 0 && dtype != 1) || m < 1 || d < vec || d % vec != 0 || 32 * vpl * vec < d ||
      (warps != 1 && warps != 2 && warps != 4) || static_cast<long long>(blocks) * warps < m || x == nullptr ||
      scale == nullptr || shift == nullptr || y == nullptr || (x_new == nullptr) != (branch == nullptr) ||
      (bias != nullptr && branch == nullptr))
    return cudaErrorInvalidValue;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(branch) |
                         reinterpret_cast<uintptr_t>(bias) | reinterpret_cast<uintptr_t>(x_new) |
                         reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(scale) |
                         reinterpret_cast<uintptr_t>(shift);
  if (ptrs % 16 != 0) return cudaErrorMisalignedAddress;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, branch, bias, scale, shift, x_new, y, m, d, eps, vpl, warps, blocks, s);
  return launch<float>(x, branch, bias, scale, shift, x_new, y, m, d, eps, vpl, warps, blocks, s);
}

}  // extern "C"
