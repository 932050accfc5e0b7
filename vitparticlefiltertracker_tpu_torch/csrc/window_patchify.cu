// Fused window gather + patchify + patch embed, for Hopper (sm_90a).
//
// Replaces: _window_patchify_kernel in
// vitparticlefiltertracker_tpu/ops/patchify_pallas.py (launched by
// gather_patchify_window_pallas there). For each particle box (cx, cy, w, h)
// in window pixels it samples a crop x crop bilinear crop of the resampled
// search window (pixel-centred, clamp-to-edge), cuts it into g x g patch
// tokens of p*p*C values in the canonical (py, px, c) order of
// models/vit.py:patchify, and embeds them: tokens @ K + b -> [N, g*g, D].
//
// Same arithmetic as the TPU kernel: samples in f32; tokens rounded to the
// weight's type before the product; f32 accumulation; the bias added in f32;
// one final rounding to the output type. The TPU kernel's hat weights
// max(0, 1 - |y - r|) over the whole window grid, with y clipped to
// [0, Swin - 1], are exactly the 4-tap bilinear sample at floor(y) and
// min(floor(y) + 1, Swin - 1) that this kernel reads.
//
// What bounds it on this card: at the tracker's shape (N 1024, Swin 256,
// crop 32, p 16, D 768, bf16) the embed product is 4.83 GFLOP against 8.3 MB
// moved, so the floor is the tensor-core rate (4.9 us at 989 TFLOP/s). This
// first version is simple and right, not fast: scalar f32 FMAs, no tensor
// cores. What the design does about the bound: the sampled tokens never
// leave shared memory (one pass writes only the [N, g*g, D] output), and the
// 786 KB window and the 1.18 MB weight are read from L2, not staged (the
// window does not fit the 227 KB a block can use, as it fits a TPU's VMEM).
//
// Layout: window [Swin, Swin, C] f32, centers and sizes [N, 2] f32, kernel
// [p*p*C, D], bias [D] and out [N, g*g, D] in the weight's type (f32 or
// bf16), all contiguous. One block per 32 consecutive token rows of the
// flattened [N*g*g] output (8 particles at crop 32, p 16, like the TPU's
// block_n = 8), so a ragged N only leaves the last block's tail rows
// unwritten. Phase 1: the block's 256 threads sample its 32 tokens into
// shared memory (32 x 768 f32 = 96 KB, dynamic). Phase 2: thread t owns
// output columns t, t + 256 and t + 512 of each 768-column pass and keeps 32
// x 3 accumulators in registers; per 4 reduction steps it reads 12 weights
// from global memory and 32 float4s of tokens from shared memory (broadcast).
//
// Interface: plain C, loaded with ctypes. Returns cudaGetLastError() after
// the launch (0 = success), -1 for arguments the kernel does not take.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kRows = 32;      // token rows per block
constexpr int kThreads = 256;  // 8 warps
constexpr int kCols = 3;       // output columns per thread per pass
constexpr int kMaxSmemBytes = 232448;  // 227 KB, the most a block can use

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// A token value as the embed product sees it: rounded to the weight's type.
template <typename T> __device__ __forceinline__ float as_weight_type(float v);
template <> __device__ __forceinline__ float as_weight_type<float>(float v) { return v; }
template <> __device__ __forceinline__ float as_weight_type<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__host__ __device__ __forceinline__ int token_stride(int kdim) { return (kdim + 3) & ~3; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
window_patchify_kernel(const float* __restrict__ win, const float* __restrict__ centers,
                       const float* __restrict__ sizes, const T* __restrict__ kern,
                       const T* __restrict__ bias, T* __restrict__ out, int n, int swin,
                       int c, int crop, int patch, int d) {
  extern __shared__ __align__(16) float tok[];  // [kRows][kstride]
  const int g = crop / patch;
  const int g2 = g * g;
  const int pp = patch * patch;
  const int kdim = pp * c;
  const int kstride = token_stride(kdim);
  const long long rows_total = static_cast<long long>(n) * g2;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const float smax = static_cast<float>(swin - 1);

  // Phase 1: sample the block's tokens. One (token row, py, px) per step.
  for (int i = threadIdx.x; i < kRows * pp; i += kThreads) {
    const int r = i / pp;
    const int q = i - r * pp;
    float* dst = tok + r * kstride + q * c;
    const long long row = row0 + r;
    if (row >= rows_total) {  // past the last particle: zero rows, never stored
      for (int ch = 0; ch < c; ++ch) dst[ch] = 0.f;
      continue;
    }
    const int pid = static_cast<int>(row / g2);
    const int ti = static_cast<int>(row - static_cast<long long>(pid) * g2);
    const int py = q / patch, px = q - (q / patch) * patch;
    const int ci = (ti / g) * patch + py;  // crop row
    const int cj = (ti % g) * patch + px;  // crop column
    const float cx = centers[2 * pid], cy = centers[2 * pid + 1];
    const float bw = sizes[2 * pid], bh = sizes[2 * pid + 1];
    const float ty = (static_cast<float>(ci) + 0.5f) / static_cast<float>(crop) - 0.5f;
    const float tx = (static_cast<float>(cj) + 0.5f) / static_cast<float>(crop) - 0.5f;
    const float ys = fminf(fmaxf(cy + bh * ty, 0.f), smax);
    const float xs = fminf(fmaxf(cx + bw * tx, 0.f), smax);
    const float y0f = floorf(ys), x0f = floorf(xs);
    const float wy = ys - y0f, wx = xs - x0f;
    const int y0 = static_cast<int>(y0f), x0 = static_cast<int>(x0f);
    const int y1 = min(y0 + 1, swin - 1), x1 = min(x0 + 1, swin - 1);
    const float* p00 = win + (static_cast<size_t>(y0) * swin + x0) * c;
    const float* p01 = win + (static_cast<size_t>(y0) * swin + x1) * c;
    const float* p10 = win + (static_cast<size_t>(y1) * swin + x0) * c;
    const float* p11 = win + (static_cast<size_t>(y1) * swin + x1) * c;
    for (int ch = 0; ch < c; ++ch) {
      const float top = p00[ch] * (1.f - wx) + p01[ch] * wx;
      const float bot = p10[ch] * (1.f - wx) + p11[ch] * wx;
      dst[ch] = as_weight_type<T>(top * (1.f - wy) + bot * wy);
    }
  }
  for (int i = threadIdx.x; i < kRows * (kstride - kdim); i += kThreads) {
    const int w = kstride - kdim;
    tok[(i / w) * kstride + kdim + i % w] = 0.f;  // pad columns up to a float4
  }
  __syncthreads();

  // Phase 2: the embed product over the block's rows, kThreads * kCols
  // output columns a pass.
  for (int d0 = 0; d0 < d; d0 += kThreads * kCols) {
    int col[kCols];
    bool ok[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      col[j] = d0 + threadIdx.x + j * kThreads;
      ok[j] = col[j] < d;
    }
    float acc[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[r][j] = 0.f;

    for (int k = 0; k < kstride; k += 4) {
      float w[4][kCols];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          w[kk][j] = (ok[j] && k + kk < kdim)
                         ? to_f32(kern[static_cast<size_t>(k + kk) * d + col[j]])
                         : 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 t = *reinterpret_cast<const float4*>(tok + r * kstride + k);
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          float a = acc[r][j];
          a = fmaf(t.x, w[0][j], a);
          a = fmaf(t.y, w[1][j], a);
          a = fmaf(t.z, w[2][j], a);
          a = fmaf(t.w, w[3][j], a);
          acc[r][j] = a;
        }
      }
    }

#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      if (!ok[j]) continue;
      const float b = to_f32(bias[col[j]]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const long long row = row0 + r;
        if (row < rows_total) out[row * d + col[j]] = from_f32<T>(acc[r][j] + b);
      }
    }
  }
}

int smem_bytes(int patch, int c) {
  return static_cast<int>(sizeof(float)) * kRows * token_stride(patch * patch * c);
}

template <typename T>
int launch(const float* win, const float* centers, const float* sizes, const void* kern,
           const void* bias, void* out, int n, int swin, int c, int crop, int patch, int d,
           cudaStream_t stream) {
  static int configured = 0;  // dynamic shared memory the attribute allows so far
  const int smem = smem_bytes(patch, c);
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(window_patchify_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = smem;
  }
  const long long rows = static_cast<long long>(n) * (crop / patch) * (crop / patch);
  const unsigned blocks = static_cast<unsigned>((rows + kRows - 1) / kRows);
  window_patchify_kernel<T><<<blocks, kThreads, smem, stream>>>(
      win, centers, sizes, static_cast<const T*>(kern), static_cast<const T*>(bias),
      static_cast<T*>(out), n, swin, c, crop, patch, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype (of kern, bias and out): 0 = float32, 1 = bfloat16.
int vpt_window_patchify_fwd(const void* win, const void* centers, const void* sizes,
                            const void* kern, const void* bias, void* out, int n, int swin,
                            int c, int crop, int patch, int d, int dtype, void* stream) {
  if (n <= 0 || swin <= 0 || c <= 0 || patch <= 0 || crop < patch || crop % patch != 0 ||
      d <= 0 || smem_bytes(patch, c) > kMaxSmemBytes)
    return -1;
  const float* w = static_cast<const float*>(win);
  const float* ctr = static_cast<const float*>(centers);
  const float* sz = static_cast<const float*>(sizes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(w, ctr, sz, kern, bias, out, n, swin, c, crop, patch, d, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(w, ctr, sz, kern, bias, out, n, swin, c, crop, patch, d, s);
  return -1;
}

// Dynamic shared memory one block asks for at this patch size and channel
// count (-1 past the 227 KB a block can use), so a caller can check and print it.
int vpt_window_patchify_smem_bytes(int patch, int c) {
  const int b = smem_bytes(patch, c);
  return b > kMaxSmemBytes ? -1 : b;
}

}  // extern "C"
